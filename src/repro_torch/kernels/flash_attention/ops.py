"""Blocked GQA attention over the full sequence (the
prefill's attention), causal or not. Port of
``repro/kernels/flash_attention/ops.py``.

On CUDA tensors the wrapper launches its hand-written Hopper kernel
(``csrc/flash_attention.cu``) or raises; on CPU tensors it returns its
plain version (``ref.py``). There is no other path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (32, 64, 128)

# kernel launches since the last reset (chip_smoke.py sets it to 0 before
# the main path and reads it after)
flash_launches = 0

# the C signature of flash_attention_launch (csrc/flash_attention.cu)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 6 + [ctypes.c_float, ctypes.c_void_p])


def _check(q, k, v) -> None:
    """What the kernel takes: q (B,S,H,hd), k/v (B,S,K,hd) of one dtype,
    H % K == 0, hd in HEAD_DIMS, each with unit stride over hd and stride
    hd over heads (batch and sequence strides are free)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,hd) and k/v (B,S,K,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    Bk, Sk, K, hdk = k.shape
    if Bk != B or Sk != S or hdk != hd or S < 1 or H % K != 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one of {list(DTYPE_CODES)}; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError(f"{name} must be contiguous over (heads, hd); "
                             f"strides {t.stride()}")


def _check_rows_aligned(q, k, v) -> None:
    """What the bf16 kernel's 16-byte row copies take: each data pointer
    and each batch and sequence stride a multiple of 16 bytes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        es = t.element_size()
        if (t.data_ptr() % 16 or t.stride(0) * es % 16
                or t.stride(1) * es % 16):
            raise ValueError(f"{name} rows must be 16-byte aligned for the "
                             f"bf16 kernel; data_ptr {t.data_ptr()}, "
                             f"strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,K,hd) with H % K == 0. Returns (B,S,H,hd)
    in q's dtype.

    ``block_q``/``block_k`` are kept for the reference's callers: the
    CUDA kernel picks its own tiles, and the result does not depend on
    them. The kernel reads the public layout in place through the batch
    and sequence strides (no kv-major transpose, no padding of S); keys
    at or past S are never read. Any S runs. bf16 runs on the tensor
    cores and copies 16-byte rows, so it refuses tensors whose data
    pointer or batch or sequence stride is not a multiple of 16 bytes;
    float32 runs on the CUDA cores (``csrc/flash_attention.cu``)."""
    global flash_launches
    device = _build.device_of("flash_attention", q, k, v)
    if device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    _check(q, k, v)
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q, k, v)
    B, S, H, hd = q.shape
    K = k.shape[2]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _build.launcher("flash_attention", _ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], B, S, H, K, hd, int(causal),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), 1.0 / hd ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_launches += 1
    return out
