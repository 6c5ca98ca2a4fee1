"""Flash-decode attention: q (B,H,hd) against a contiguous (B,W,K,hd) KV
cache (``decode_attention``) or a shared (P,page,K,hd) page pool addressed
through a per-row page table (``paged_decode_attention``), and C chunk
queries per row against the page pool with a per-query bias
(``paged_verify_attention``, the speculative verify step), with an
additive float32 slot bias. Port of
``repro/kernels/decode_attention/ops.py``.

On CUDA tensors each wrapper launches its hand-written Hopper kernel
(``csrc/decode_attention.cu``, ``csrc/paged_decode_attention.cu``,
``csrc/paged_verify_attention.cu``) or raises; on CPU tensors it returns
its plain version (``ref.py``). There is no other path. The three bf16
kernels (contiguous decode, paged decode and verify) split each row's
keys over a cluster of CTAs and read 16-byte rows
(``csrc/split_decode.cuh``), so they refuse a q, cache or pool whose data
pointer, or a cache or pool whose batch, page or slot stride, is not a
multiple of 16 bytes. The float32 kernels keep one CTA a (row, kv head)
(``csrc/flash_decode.cuh``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref,
    paged_verify_attention_ref)

HEAD_DIMS = (32, 64, 128)

# the float32 paged decode and verify kernels stage a row's page table in
# shared memory beside the 33,280 bytes of their merge buffers (hd=128),
# within the default 48 KiB; the bf16 kernels read the table in place and
# have no such limit, but share the check
MAX_PAGES = 2048

# kernel launches since the last reset, one plain counter per kernel
# (chip_smoke.py sets them to 0 before the main path and reads them after)
launches = 0
paged_launches = 0
verify_launches = 0

# the C signature of each kernel's launch function (csrc/*.cu): pointers
# and the stream as c_void_p, so ctypes does not cut them to 32 bits
_ARGTYPES = {
    "decode_attention": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                         + [ctypes.c_longlong] * 5
                         + [ctypes.c_float, ctypes.c_void_p]),
    "paged_decode_attention": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                               + [ctypes.c_longlong] * 6
                               + [ctypes.c_float, ctypes.c_void_p]),
    "paged_verify_attention": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                               + [ctypes.c_longlong] * 7
                               + [ctypes.c_float, ctypes.c_void_p]),
}


def _kernel(name: str):
    return _build.launcher(name, _ARGTYPES[name])


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
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one of {list(DTYPE_CODES)}; "
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


def _check_rows_aligned(q, k, v) -> None:
    """What the bf16 split-K kernels' 16-byte row loads take: each data
    pointer, and each stride of k and v over their first two axes (batch
    and slot, or page and slot), a multiple of 16 bytes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        es = t.element_size()
        strides = () if t is q else (t.stride(0), t.stride(1))
        if t.data_ptr() % 16 or any(s * es % 16 for s in strides):
            raise ValueError(f"{name} rows must be 16-byte aligned for the "
                             f"bf16 kernel; data_ptr {t.data_ptr()}, "
                             f"strides {t.stride()}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """q (B,H,hd); k/v (B,W,K,hd); bias (B,W) additive. -> (B,H,hd)."""
    global launches
    device = _build.device_of("decode_attention", q, k, v, bias)
    if device.type == "cpu":
        return decode_attention_ref(q, k, v, bias)
    _check(q, k, v, bias)
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q, k, v)
    B, H, hd = q.shape
    W, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel("decode_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), DTYPE_CODES[q.dtype], B, H, K, W, hd,
            k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            bias.stride(0), 1.0 / hd ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


def _check_paged(q, k_pool, v_pool, page_table, bias) -> None:
    """What the paged kernels take. q (B,H,hd) with bias (B, n*page), or
    q (B,C,H,hd) with a per-query bias (B, C, n*page)."""
    chunk = q.dim() == 4
    if q.dim() not in (3, 4) or k_pool.dim() != 4 \
            or k_pool.shape != v_pool.shape or page_table.dim() != 2:
        raise ValueError(f"want q (B,H,hd) or (B,C,H,hd), k/v pools "
                         f"(P,page,K,hd) and page_table (B,n); got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}, {tuple(page_table.shape)}")
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    P, page, K, hdk = k_pool.shape
    n = page_table.shape[1]
    if page_table.shape[0] != B or hdk != hd or H % K != 0 or n < 1:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}, page_table "
                         f"{tuple(page_table.shape)}")
    if n > MAX_PAGES:
        raise ValueError(f"{n} pages per row; the kernel takes at most "
                         f"{MAX_PAGES}")
    if page_table.dtype != torch.int32 or page_table.stride(1) != 1:
        raise ValueError(f"page_table must be int32 with unit stride over "
                         f"pages; got {page_table.dtype} "
                         f"{page_table.stride()}")
    want = (B, q.shape[1], n * page) if chunk else (B, n * page)
    if tuple(bias.shape) != want or bias.dtype != torch.float32 \
            or bias.stride(-1) != 1:
        raise ValueError(f"bias must be float32 {want} with unit stride "
                         f"over slots; got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if q.dtype not in DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one of {list(DTYPE_CODES)}; "
                         f"got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError(f"{name} must be contiguous over (K, hd); "
                             f"strides {t.stride()}")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """q (B,H,hd); k_pool/v_pool (P,page,K,hd), the shared page pool, read
    in place; page_table (B,n) int32, every entry a valid page id (the
    kernel does not check: idle rows point at the trash page); bias
    (B, n*page) additive over the row's virtual sequence. -> (B,H,hd)."""
    global paged_launches
    device = _build.device_of("paged_decode_attention", q, k_pool, v_pool,
                     page_table, bias)
    if device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, page_table,
                                          bias)
    if q.dim() != 3:
        raise ValueError(f"want q (B,H,hd); got {tuple(q.shape)}")
    _check_paged(q, k_pool, v_pool, page_table, bias)
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q, k_pool, v_pool)
    B, H, hd = q.shape
    page, K = k_pool.shape[1], k_pool.shape[2]
    n = page_table.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel("paged_decode_attention")(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), bias.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], B, H, K, n, page, hd, k_pool.stride(0),
            k_pool.stride(1), v_pool.stride(0), v_pool.stride(1),
            page_table.stride(0), bias.stride(0), 1.0 / hd ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {err}")
    paged_launches += 1
    return out


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """q (B,C,H,hd), C chunk queries per row; k_pool/v_pool (P,page,K,hd),
    read in place; page_table (B,n) int32, every entry a valid page id;
    bias (B, C, n*page) additive per query over the row's virtual
    sequence (slot validity and causal-within-chunk). -> (B,C,H,hd).
    Column 0 of a C=1 call is ``paged_decode_attention``'s answer."""
    global verify_launches
    device = _build.device_of("paged_verify_attention", q, k_pool, v_pool,
                     page_table, bias)
    if device.type == "cpu":
        return paged_verify_attention_ref(q, k_pool, v_pool, page_table,
                                          bias)
    if q.dim() != 4:
        raise ValueError(f"want q (B,C,H,hd); got {tuple(q.shape)}")
    _check_paged(q, k_pool, v_pool, page_table, bias)
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q, k_pool, v_pool)
    B, C, H, hd = q.shape
    page, K = k_pool.shape[1], k_pool.shape[2]
    n = page_table.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel("paged_verify_attention")(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), bias.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], B, C, H, K, n, page, hd,
            k_pool.stride(0), k_pool.stride(1), v_pool.stride(0),
            v_pool.stride(1), page_table.stride(0), bias.stride(0),
            bias.stride(1), 1.0 / hd ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged_verify_attention kernel launch failed: "
                           f"CUDA error {err}")
    verify_launches += 1
    return out
