"""Flash-decode attention: q (B,H,hd) against a contiguous (B,W,K,hd) KV
cache with an additive (B,W) float32 slot bias. Port of
``repro/kernels/decode_attention/ops.py:decode_attention``.

On CUDA tensors this launches the hand-written Hopper kernel
(``csrc/decode_attention.cu``) or raises; on CPU tensors it returns the
plain version (``ref.decode_attention_ref``). There is no other path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (a plain counter; chip_smoke.py sets
# it to 0 before the main path and reads it after)
launches = 0

_launch_fn = None


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load("decode_attention").decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _check(q, k, v, bias) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,hd) and k/v (B,W,K,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    Bk, W, K, hdk = k.shape
    if Bk != B or hdk != hd or W < 1 or H % K != 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)}")
    if tuple(bias.shape) != (B, W) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32 (B, W) = {(B, W)}; got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one of {list(_DTYPE_CODES)}; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError(f"{name} must be contiguous over (K, hd); "
                             f"strides {t.stride()}")
    if bias.stride(1) != 1:
        raise ValueError("bias must be contiguous over W")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """q (B,H,hd); k/v (B,W,K,hd); bias (B,W) additive. -> (B,H,hd)."""
    global launches
    devices = {t.device for t in (q, k, v, bias)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v, bias on different devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return decode_attention_ref(q, k, v, bias)
    if device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not "
                         f"{device.type}")
    _check(q, k, v, bias)
    B, H, hd = q.shape
    W, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr(), out.data_ptr(),
                        _DTYPE_CODES[q.dtype], B, H, K, W, hd,
                        k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                        bias.stride(0), 1.0 / hd ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
