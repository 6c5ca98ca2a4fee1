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
(``csrc/flash_decode.cuh``). The two decode wrappers take one of three
kernels (``DecodePlan``), picked by ``decode_plan`` unless the caller
forces one.
"""
from __future__ import annotations

import ctypes
import enum
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref,
    paged_verify_attention_ref)
# the flash kernel's head sizes; any other raises before a launch
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS

# the float32 paged decode and verify kernels stage a row's page table in
# shared memory beside the 33,280 bytes of their merge buffers (hd=128),
# within the default 48 KiB; the bf16 kernels read the table in place and
# have no such limit, but share the check
MAX_PAGES = 2048

# the most CTAs a cluster of the SETS kernel splits a row's keys over (the
# portable cluster size; split_decode.cuh:kMaxSplit)
MAX_SPLIT = 8
# the fewest slots a CTA of a SETS split must take: below that the kernel
# runs one CTA a set, with no cluster and no merge (``sets_split``). Read on
# both sides on the H100 (chip_smoke.py's decode A/B lines, PERF.md §6):
# at W = 72 one CTA ran nemotron-4-340b's heads in 0.0062 ms against 0.0123
# at a split of 8, at W = 128 a split of 2 in 0.0071 against one CTA's
# 0.0075, at W = 256 a split of 4 in 0.0084 against 0.0119
SETS_MIN_SLOTS = 64


class DecodePlan(enum.IntEnum):
    """One decode launch's kernel (``enum Plan`` of the two decode
    launchers, which refuse a plan of the other dtype). float32: one CTA a
    (row, kv head) (``flash_decode.cuh``). bf16: the split-K body in sets
    of at most 8 queries on CUDA cores (``split_decode.cuh:attend``), or
    one cluster a kv head's whole query set (up to 16) with both products
    on the tensor cores (``split_decode.cuh:attend_set``)."""
    FLASH_DECODE = 0
    SPLIT = 1
    SETS = 2


def plans(dtype: torch.dtype, G: int = 1) -> tuple:
    """Every plan the library holds for ``dtype`` at G query heads a kv
    head: at G = 1 bf16 keeps SPLIT alone."""
    if dtype == torch.float32:
        return (DecodePlan.FLASH_DECODE,)
    if dtype == torch.bfloat16:
        return ((DecodePlan.SPLIT,) if G == 1
                else (DecodePlan.SPLIT, DecodePlan.SETS))
    return ()


def decode_plan(B: int, H: int, K: int, hd: int, W: int,
                dtype: torch.dtype) -> DecodePlan:
    """The kernel a decode launch of B rows, H query heads over K kv heads
    and W slots takes (the paged launch: W = pages x page). float32:
    FLASH_DECODE. bf16 at G = H / K = 1: SPLIT, at every B and W (LISA-7B's
    whole serving path). bf16 at G > 1: SETS, which reads each kv head's
    rows once for all its query heads (SPLIT reads them once a set of 8)
    and ran faster than SPLIT at every timed G > 1 shape on the H100
    (``chip_smoke.py`` phase 3's A/B lines, PERF.md §6)."""
    if dtype == torch.float32:
        return DecodePlan.FLASH_DECODE
    if H // K == 1:
        return DecodePlan.SPLIT
    return DecodePlan.SETS


def sets_split(W: int) -> int:
    """The most CTAs the SETS kernel may split W slots over: one per
    SETS_MIN_SLOTS slots, at most MAX_SPLIT, at least 1 (the launcher takes
    the largest power of two under it that puts no more CTAs on an SM than
    ``split_decode.cuh:set_ctas_per_sm`` aims for)."""
    return max(1, min(MAX_SPLIT, W // SETS_MIN_SLOTS))


def set_split(B: int, H: int, K: int, hd: int, W: int,
              split: Optional[int] = None,
              n_pages: Optional[int] = None) -> int:
    """The CTAs a cluster of the SETS kernel takes at this shape (the
    contiguous kernel, or the paged one over ``n_pages`` pages), with
    ``split`` its cap (default ``sets_split(W)``), read from the built
    library (``*_set_split``: from the card's SMs and the CTAs an SM the
    kernel aims for); needs ``nvcc`` and the card, as a launch does."""
    cap = sets_split(W) if split is None else split
    name = "decode_attention" if n_pages is None else \
        "paged_decode_attention"
    most = min(cap, W if n_pages is None else n_pages)
    out = ctypes.c_int()
    err = getattr(_build.load(name), f"{name}_set_split")(
        B, H, K, hd, most, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{name}_set_split failed: CUDA error {err}")
    return out.value


def _launch_plan(plan, split, dtype, G, B, H, K, hd, W):
    """(plan, max_split) of one launch: the caller's plan (one of
    ``plans``) or ``decode_plan``'s, and SETS' split cap (``split``, else
    ``sets_split``; 0 for the other plans)."""
    if plan is None:
        plan = decode_plan(B, H, K, hd, W, dtype)
    if plan not in plans(dtype, G):
        raise ValueError(f"plan {plan!r} is not one of {plans(dtype, G)} "
                         f"for {dtype} at G = {G}")
    if plan != DecodePlan.SETS:
        if split is not None:
            raise ValueError(f"split is SETS' only; plan {plan!r}")
        return plan, 0
    if split is not None and not 1 <= split <= MAX_SPLIT:
        raise ValueError(f"split {split} not in 1..{MAX_SPLIT}")
    return plan, sets_split(W) if split is None else split


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
                         + [ctypes.c_float] + [ctypes.c_int] * 2
                         + [ctypes.c_void_p]),
    "paged_decode_attention": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                               + [ctypes.c_longlong] * 6
                               + [ctypes.c_float] + [ctypes.c_int] * 2
                               + [ctypes.c_void_p]),
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
                     bias: torch.Tensor, plan: Optional[DecodePlan] = None,
                     split: Optional[int] = None) -> torch.Tensor:
    """q (B,H,hd); k/v (B,W,K,hd); bias (B,W) additive. -> (B,H,hd).
    ``plan`` forces one of ``plans(dtype, H // K)`` (default
    ``decode_plan``'s); ``split`` caps the SETS kernel's cluster (default
    ``sets_split(W)``; 1: one CTA a set)."""
    global launches
    device = _build.device_of("decode_attention", q, k, v, bias)
    if device.type == "cpu":
        return decode_attention_ref(q, k, v, bias)
    _check(q, k, v, bias)
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q, k, v)
    B, H, hd = q.shape
    W, K = k.shape[1], k.shape[2]
    plan, max_split = _launch_plan(plan, split, q.dtype, H // K, B, H, K,
                                   hd, W)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel("decode_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), DTYPE_CODES[q.dtype], B, H, K, W, hd,
            k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            bias.stride(0), 1.0 / hd ** 0.5, int(plan), max_split, stream)
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
                           bias: torch.Tensor,
                           plan: Optional[DecodePlan] = None,
                           split: Optional[int] = None) -> torch.Tensor:
    """q (B,H,hd); k_pool/v_pool (P,page,K,hd), the shared page pool, read
    in place; page_table (B,n) int32, every entry a valid page id (the
    kernel does not check: idle rows point at the trash page); bias
    (B, n*page) additive over the row's virtual sequence. -> (B,H,hd).
    ``plan`` and ``split`` as ``decode_attention``'s, over W = n*page
    slots (the SETS split is also at most one CTA a page)."""
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
    plan, max_split = _launch_plan(plan, split, q.dtype, H // K, B, H, K,
                                   hd, n * page)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel("paged_decode_attention")(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), bias.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], B, H, K, n, page, hd, k_pool.stride(0),
            k_pool.stride(1), v_pool.stride(0), v_pool.stride(1),
            page_table.stride(0), bias.stride(0), 1.0 / hd ** 0.5,
            int(plan), max_split, stream)
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
