"""Plain PyTorch version of the selective scan (mirror of
``repro/kernels/ssm_scan/ref.py``). The CPU path of the wrapper, and the
oracle the CUDA kernel is held against on the card."""
from __future__ import annotations

import torch


def scan_ref(decay: torch.Tensor, drive: torch.Tensor) -> torch.Tensor:
    """h_t = decay_t * h_{t-1} + drive_t along axis 1, from h_{-1} = 0.

    decay/drive: (B, S, C, N) of any float dtype, computed in float32.
    Returns h (B, S, C, N) float32. One step at a time, a multiply then an
    add, each rounded to float32: the CUDA kernel rounds in the same two
    places, so on the card the two agree bit for bit. (The reference's
    ``associative_scan`` multiplies in another order and agrees to
    rounding.)"""
    dec, drv = decay.float(), drive.float()
    out = torch.empty(drv.shape, dtype=torch.float32, device=drv.device)
    h = torch.zeros_like(drv[:, 0])
    for t in range(drv.shape[1]):
        h = dec[:, t] * h + drv[:, t]
        out[:, t] = h
    return out
