"""Plain PyTorch versions of the fused bottleneck encode/decode (mirrors
of ``repro/kernels/bottleneck/ref.py``). The CPU path of the wrappers, and
the oracles the CUDA kernels are held against on the card."""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch


@contextlib.contextmanager
def _full_fp32():
    """Float32 products in full float32 (TF32 off) for the block."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def encode_ref(x: torch.Tensor, w_enc: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d), w_enc (d, r) -> (codes int8 (T, r), scales f32 (T, 1)).

    On a CUDA tensor PyTorch takes ``/ 127.0`` as a multiply by the
    reciprocal, so these scales can sit one unit in the last place from
    the kernel's true division; a code moves only where that meets a .5
    tie."""
    with _full_fp32():
        z = x.float() @ w_enc.float()
    s = torch.amax(torch.abs(z), dim=-1, keepdim=True) / 127.0 + 1e-8
    # torch.round, like jnp.round, rounds half to even
    codes = torch.clamp(torch.round(z / s), -127, 127).to(torch.int8)
    return codes, s


def decode_ref(codes: torch.Tensor, scales: torch.Tensor,
               w_dec: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """codes (T, r) int8, scales (T, 1) -> (T, d) in ``out_dtype``."""
    z = codes.float() * scales
    with _full_fp32():
        return (z @ w_dec.float()).to(out_dtype)
