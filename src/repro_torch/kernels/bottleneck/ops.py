"""Fused bottleneck kernels of the split point: low-rank projection with
per-token absmax int8 quantisation (``bottleneck_encode``), and
dequantisation with the projection back (``bottleneck_decode``). Port of
``repro/kernels/bottleneck/ops.py``: leading axes are flattened into
tokens and restored.

On CUDA tensors each wrapper launches its hand-written Hopper kernel
(``csrc/bottleneck_encode.cu``, ``csrc/bottleneck_decode.cu``) or raises;
on CPU tensors it returns its plain version (``ref.py``). There is no
other path. The kernels mask the ragged tile of tokens themselves, so
tokens are not padded to a tile as the reference's wrapper pads them.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels.bottleneck.ref import decode_ref, encode_ref

# kernel launches since the last reset, one plain counter per kernel
# (chip_smoke.py sets them to 0 before the main path and reads them after)
encode_launches = 0
bottleneck_decode_launches = 0

# the widest rank the encode kernel takes: a cluster of 8 CTAs, each
# walking at most 8 column tiles of 256 (csrc/bottleneck_encode.cu). The
# reference's ranks are at most d.
MAX_RANK = 8 * 8 * 256

# The kernels' products run on the tensor cores in bf16 (wgmma, float32
# accumulation; csrc/bottleneck_gemm.cuh): a float32 operand is split into
# three bf16 parts (hi + mid + lo hold its 24 bits), and each pair of parts
# (i, j) with i + j <= 2 is one product.
PRODUCT_DTYPE = torch.bfloat16


def tensor_core_products(a_dtype, w_dtype) -> int:
    """The bf16 products a kernel takes for operands of these dtypes (the
    activation or codes, then the weight): 1 for bf16 (or int8 codes) and
    bf16, 3 where one is float32, 6 where both are."""
    pa, pw = (3 if dt == torch.float32 else 1 for dt in (a_dtype, w_dtype))
    return sum(1 for i in range(pa) for j in range(pw) if i + j <= 2)

# the C signature of each kernel's launch function (csrc/*.cu)
_ARGTYPES = {
    "bottleneck_encode": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                          + [ctypes.c_longlong, ctypes.c_void_p]),
    "bottleneck_decode": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                          + [ctypes.c_void_p]),
}


def _kernel(name: str):
    return _build.launcher(name, _ARGTYPES[name])


def _check_encode(flat: torch.Tensor, w_enc: torch.Tensor) -> None:
    """What the encode kernel takes: x (T, d) with unit stride over d,
    w_enc (d, r) contiguous with r <= MAX_RANK, each float32 or bf16."""
    if w_enc.dim() != 2 or flat.shape[1] != w_enc.shape[0] \
            or flat.shape[0] < 1:
        raise ValueError(f"want x (..., d) and w_enc (d, r); got x rows "
                         f"{tuple(flat.shape)}, w_enc {tuple(w_enc.shape)}")
    if w_enc.shape[1] > MAX_RANK:
        raise ValueError(f"rank {w_enc.shape[1]} above the encode kernel's "
                         f"MAX_RANK {MAX_RANK}")
    for name, t in (("x", flat), ("w_enc", w_enc)):
        if t.dtype not in DTYPE_CODES:
            raise ValueError(f"{name} must be one of {list(DTYPE_CODES)}; "
                             f"got {t.dtype}")
    if flat.stride(1) != 1:
        raise ValueError(f"x must have unit stride over d; strides "
                         f"{flat.stride()}")
    if not w_enc.is_contiguous():
        raise ValueError("w_enc must be contiguous")


def _check_decode(flat: torch.Tensor, sflat: torch.Tensor,
                  w_dec: torch.Tensor, out_dtype) -> None:
    """What the decode kernel takes: codes (T, r) int8 and scales (T, 1)
    float32, both contiguous; w_dec (r, d) contiguous, float32 or bf16;
    out_dtype float32 or bf16."""
    if w_dec.dim() != 2 or flat.shape[1] != w_dec.shape[0] \
            or sflat.shape[0] != flat.shape[0] or flat.shape[0] < 1:
        raise ValueError(f"want codes (..., r), scales (..., 1) and w_dec "
                         f"(r, d); got codes rows {tuple(flat.shape)}, "
                         f"scales rows {tuple(sflat.shape)}, w_dec "
                         f"{tuple(w_dec.shape)}")
    if flat.dtype != torch.int8 or sflat.dtype != torch.float32:
        raise ValueError(f"want int8 codes and float32 scales; got "
                         f"{flat.dtype}, {sflat.dtype}")
    if w_dec.dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES:
        raise ValueError(f"w_dec and out_dtype must be one of "
                         f"{list(DTYPE_CODES)}; got {w_dec.dtype}, "
                         f"{out_dtype}")
    for name, t in (("codes", flat), ("scales", sflat), ("w_dec", w_dec)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def bottleneck_encode(x: torch.Tensor, w_enc: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., d) -> (codes int8 (..., r), scales f32 (..., 1))."""
    global encode_launches
    device = _build.device_of("bottleneck_encode", x, w_enc)
    lead, r = x.shape[:-1], w_enc.shape[-1]
    flat = x.reshape(-1, x.shape[-1])
    if device.type == "cpu":
        codes, scales = encode_ref(flat, w_enc)
        return codes.reshape(*lead, r), scales.reshape(*lead, 1)
    _check_encode(flat, w_enc)
    T, d = flat.shape
    codes = torch.empty((T, r), dtype=torch.int8, device=device)
    scales = torch.empty((T, 1), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel("bottleneck_encode")(
            flat.data_ptr(), w_enc.data_ptr(), codes.data_ptr(),
            scales.data_ptr(), DTYPE_CODES[flat.dtype],
            DTYPE_CODES[w_enc.dtype], T, d, r, flat.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"bottleneck_encode kernel launch failed: CUDA "
                           f"error {err} (rank {r})")
    encode_launches += 1
    return codes.reshape(*lead, r), scales.reshape(*lead, 1)


def bottleneck_decode(codes: torch.Tensor, scales: torch.Tensor,
                      w_dec: torch.Tensor,
                      out_dtype=torch.float32) -> torch.Tensor:
    """codes int8 (..., r), scales f32 (..., 1), w_dec (r, d) ->
    (..., d) in ``out_dtype``."""
    global bottleneck_decode_launches
    device = _build.device_of("bottleneck_decode", codes, scales, w_dec)
    lead, d = codes.shape[:-1], w_dec.shape[-1]
    flat = codes.reshape(-1, codes.shape[-1])
    sflat = scales.reshape(-1, 1)
    if device.type == "cpu":
        return decode_ref(flat, sflat, w_dec, out_dtype).reshape(*lead, d)
    _check_decode(flat, sflat, w_dec, out_dtype)
    T, r = flat.shape
    out = torch.empty((T, d), dtype=out_dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel("bottleneck_decode")(
            flat.data_ptr(), sflat.data_ptr(), w_dec.data_ptr(),
            out.data_ptr(), DTYPE_CODES[w_dec.dtype],
            DTYPE_CODES[out_dtype], T, r, d, stream)
    if err != 0:
        raise RuntimeError(f"bottleneck_decode kernel launch failed: CUDA "
                           f"error {err}")
    bottleneck_decode_launches += 1
    return out.reshape(*lead, d)
