"""The selective scan of the Mamba blocks, h_t = decay_t * h_{t-1} +
drive_t over axis 1. Port of ``repro/kernels/ssm_scan/ops.py``.

On CUDA tensors the wrapper launches its hand-written Hopper kernel
(``csrc/ssm_scan.cu``) or raises; on CPU tensors it returns its plain
version (``ref.py``). There is no other path. The kernel walks any S and
any C, so nothing is padded as the reference's wrapper pads to its
blocks.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES
from repro_torch.kernels.ssm_scan.ref import scan_ref

# kernel launches since the last reset (chip_smoke.py sets it to 0 before
# the main path and reads it after)
scan_launches = 0

# the C signature of ssm_scan_launch (csrc/ssm_scan.cu)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
             + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])


def _check(decay: torch.Tensor, drive: torch.Tensor) -> None:
    """What the kernel takes: decay and drive (B, S, C, N) of one shape
    and one dtype (float32 or bf16), both contiguous, 1 <= B <= 65535."""
    if decay.dim() != 4 or decay.shape != drive.shape \
            or decay.numel() == 0:
        raise ValueError(f"want decay and drive (B, S, C, N) of one "
                         f"non-empty shape; got {tuple(decay.shape)}, "
                         f"{tuple(drive.shape)}")
    if decay.shape[0] > 65535:
        raise ValueError(f"batch {decay.shape[0]} above the kernel's grid "
                         f"limit 65535")
    if decay.dtype != drive.dtype or decay.dtype not in DTYPE_CODES:
        raise ValueError(f"decay and drive must share one of "
                         f"{list(DTYPE_CODES)}; got {decay.dtype}, "
                         f"{drive.dtype}")
    for name, t in (("decay", decay), ("drive", drive)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous; strides "
                             f"{t.stride()}")


def chunked_scan(decay: torch.Tensor, drive: torch.Tensor, chunk: int = 64,
                 block_c: int = 128) -> torch.Tensor:
    """h_t = decay_t * h_{t-1} + drive_t over axis 1. (B, S, C, N) in,
    (B, S, C, N) float32 out. ``chunk`` and ``block_c`` are the
    reference's blocking and are accepted for its signature: the kernel
    carries each lane's h down the whole sequence, so neither changes
    what it computes."""
    global scan_launches
    device = _build.device_of("ssm_scan", decay, drive)
    if device.type == "cpu":
        return scan_ref(decay, drive)
    _check(decay, drive)
    B, S, C, N = decay.shape
    h = torch.empty((B, S, C, N), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _build.launcher("ssm_scan", _ARGTYPES)(
            decay.data_ptr(), drive.data_ptr(), h.data_ptr(),
            DTYPE_CODES[decay.dtype], B, S, C * N, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error "
                           f"{err} (shape {tuple(decay.shape)})")
    scan_launches += 1
    return h
