"""Blocked GQA attention over the full sequence (the
prefill's attention), causal or not. Port of
``repro/kernels/flash_attention/ops.py``.

On CUDA tensors the wrapper launches its hand-written Hopper kernel
(``csrc/flash_attention.cu``) or raises; on CPU tensors it returns its
plain version (``ref.py``). There is no other path.
"""
from __future__ import annotations

import ctypes
import enum
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels.flash_attention.ref import attention_ref

# every head size a causal GQA config of the repo resolves to (the zoo's
# decoders and the LISA LLMs: 32, 64, 112, 128, 192) and those of the
# full-size encoders (SAM and hubert-xlarge 80, CLIP 64); any other raises
# before a launch
HEAD_DIMS = (32, 64, 80, 112, 128, 192)

# kernel launches since the last reset (chip_smoke.py sets it to 0 before
# the main path and reads it after)
flash_launches = 0

# the C signature of flash_attention_launch (csrc/flash_attention.cu)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 6 + [ctypes.c_float] + [ctypes.c_int]
             + [ctypes.c_void_p])

# flash_ws_kernel's least sequence and least grid (CTAs of 128 query rows
# of a head: B * H * ceil(S / 128)); below either, and at hd under 80, the
# one-warpgroup kernel was measured faster (``flash_plan``)
WS_MIN_S = 1024
WS_MIN_CTAS = 128


class FlashPlan(enum.IntEnum):
    """One launch's kernel (``enum Plan`` of csrc/flash_attention.cu,
    which derives each kernel's tiles and stages and refuses a plan of the
    other dtype). float32 runs split TF32 products on the tensor cores
    (flash_tf32_kernel); bf16 one warpgroup a CTA over 64-row tiles
    (flash_wgmma_kernel), or a producer warp and two consumer warpgroups
    over wide kv tiles (flash_ws_kernel) on two halves of one head's 128
    query rows, or on 64 rows of two heads that read one kv head (G even).
    Value 0 was a float32 kernel on the CUDA cores, which the card read
    slower than TF32 at every timed float32 shape (PERF.md §6)."""
    WGMMA = 1
    WS_HALVES = 2
    WS_PAIRS = 3
    TF32 = 4


def plans(dtype: torch.dtype, G: int = 1) -> tuple:
    """Every plan the library holds for ``dtype`` at G query heads a kv
    head."""
    if dtype == torch.float32:
        return (FlashPlan.TF32,)
    if dtype == torch.bfloat16:
        return ((FlashPlan.WGMMA, FlashPlan.WS_HALVES)
                + ((FlashPlan.WS_PAIRS,) if G % 2 == 0 else ()))
    return ()


def flash_plan(B: int, S: int, H: int, K: int, hd: int,
               dtype: torch.dtype) -> FlashPlan:
    """The kernel a launch of B rows, S positions, H query heads and K kv
    heads takes. float32: the online kernel. bf16: the warp-specialised
    kernel where its products outweigh the softmax (hd of at least 80),
    where its 128-row tiles waste little of the sequence (S of at least
    WS_MIN_S) and where its grid of B * H * ceil(S / 128) CTAs, one an SM,
    fills the card (at least WS_MIN_CTAS); there two heads a CTA where
    G = H / K is even, else two halves of one head's 128 rows. Else one
    warpgroup a CTA. The A/B lines of ``chip_smoke.py`` phase 3 read each
    threshold on both sides (``flash_rule_cases``; PERF.md §6): at LISA-7B's
    heads WGMMA is faster at S 512 and the two tie at 1,024; at S 1,024
    WGMMA is faster over 96 CTAs and WS over 128. LISA-7B's prefill
    (S 204), S 1,500 over 4 heads (48 CTAs) and granite's hd 64 read faster
    on WGMMA, every other timed shape on the warp-specialised kernel."""
    if dtype == torch.float32:
        return FlashPlan.TF32
    if hd < 80 or S < WS_MIN_S or B * H * -(-S // 128) < WS_MIN_CTAS:
        return FlashPlan.WGMMA
    return FlashPlan.WS_PAIRS if (H // K) % 2 == 0 else FlashPlan.WS_HALVES


def plan_tile(plan: FlashPlan, hd: int) -> tuple:
    """(query rows a CTA holds of each of its heads, keys a kv tile) of
    ``plan``'s kernel at ``hd``, read from the built library
    (``flash_attention_tile``); needs ``nvcc``, as a launch does."""
    rows, keys = ctypes.c_int(), ctypes.c_int()
    err = _build.load("flash_attention").flash_attention_tile(
        int(plan), hd, ctypes.byref(rows), ctypes.byref(keys))
    if err != 0:
        raise ValueError(f"no tile for plan {plan!r} at head_dim {hd}")
    return rows.value, keys.value


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
    """What the tensor-core kernels' 16-byte row copies (TMA) take: each
    data pointer and each batch and sequence stride a multiple of 16
    bytes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        es = t.element_size()
        if (t.data_ptr() % 16 or t.stride(0) * es % 16
                or t.stride(1) * es % 16):
            raise ValueError(f"{name} rows must be 16-byte aligned for the "
                             f"tensor-core kernels; data_ptr "
                             f"{t.data_ptr()}, strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128,
                    plan: Optional[FlashPlan] = None) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,K,hd) with H % K == 0. Returns (B,S,H,hd)
    in q's dtype.

    ``block_q``/``block_k`` are kept for the reference's callers: the
    CUDA kernel picks its own tiles, and the result does not depend on
    them. The kernel reads the public layout in place through the batch
    and sequence strides (no kv-major transpose, no padding of S); keys
    at or past S are never read. Any S runs. Both dtypes run on the
    tensor cores (float32 as split TF32 products) and copy 16-byte rows,
    so they refuse tensors whose data pointer or batch or sequence stride
    is not a multiple of 16 bytes (``csrc/flash_attention.cu``).
    ``plan`` (default ``flash_plan``'s) picks the kernel; one of
    ``plans(dtype, H // K)``, else ``ValueError``. Every plan computes the
    same function."""
    global flash_launches
    device = _build.device_of("flash_attention", q, k, v)
    if plan is not None:
        built = plans(q.dtype, q.shape[2] // max(k.shape[2], 1))
        if plan not in built:
            raise ValueError(f"no {q.dtype} kernel at {tuple(q.shape)} was "
                             f"built for {plan}; plans: {built}")
    if device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    _check(q, k, v)
    B, S, H, hd = q.shape
    K = k.shape[2]
    if plan is None:
        plan = flash_plan(B, S, H, K, hd, q.dtype)
    _check_rows_aligned(q, k, v)
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _build.launcher("flash_attention", _ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], B, S, H, K, hd, int(causal),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), 1.0 / hd ** 0.5, int(plan), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_launches += 1
    return out
