"""Learned bottleneck compression for split activations (port of
``repro/core/bottleneck.py``).

The edge projects the (B, T, d) boundary activation to a low-rank code and
int8-quantises it with a per-token absmax scale; the cloud dequantises and
projects back. With ``use_kernel`` each side runs its fused CUDA kernel
(``repro_torch.kernels.bottleneck``), as the reference's ``use_kernel``
runs its Pallas kernels; the default is the plain path, as in the
reference, whose serving stages never set it. ``roundtrip_st`` is the
training path: the same round trip with a straight-through estimator on
the rounding, differentiable with respect to the pair and the input.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.models.common import fan_in_init


@dataclass(frozen=True)
class BottleneckSpec:
    d_model: int
    rank: int                    # code channels
    orig_bytes_per_el: int = 2   # boundary activation dtype width (bf16)

    @property
    def ratio(self) -> float:
        """Compressed bytes / original bytes per token."""
        return (self.rank * 1 + 2) / (self.d_model * self.orig_bytes_per_el)


def rank_for_ratio(d_model: int, ratio: float,
                   orig_bytes_per_el: int = 2) -> int:
    """Code rank such that the int8 payload ~= ratio * original."""
    rank = int(round(ratio * d_model * orig_bytes_per_el)) - 2
    return max(1, min(d_model, rank))


def init_bottleneck(generator: torch.Generator, spec: BottleneckSpec,
                    dtype=torch.float32, device=None) -> dict:
    return {
        "enc": fan_in_init(generator, (spec.d_model, spec.rank), dtype,
                           device),
        "dec": fan_in_init(generator, (spec.rank, spec.d_model), dtype,
                           device),
    }


def _absmax_scale(z: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(z), dim=-1, keepdim=True) / 127.0 + 1e-8


def encode(params: dict, x: torch.Tensor, use_kernel: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., d) -> (codes int8 (..., rank), scales f32 (..., 1)).

    The plain path multiplies in x's dtype, as the reference's does; the
    kernel multiplies in float32, as the reference's kernel does."""
    if use_kernel:
        from repro_torch.kernels.bottleneck import ops as bops
        return bops.bottleneck_encode(x, params["enc"])
    z = (x @ params["enc"].to(x.dtype)).float()
    s = _absmax_scale(z)
    # torch.round, like jnp.round, rounds half to even
    codes = torch.clamp(torch.round(z / s), -127, 127).to(torch.int8)
    return codes, s


def decode(params: dict, codes: torch.Tensor, scales: torch.Tensor,
           out_dtype=torch.float32, use_kernel: bool = False
           ) -> torch.Tensor:
    if use_kernel:
        from repro_torch.kernels.bottleneck import ops as bops
        return bops.bottleneck_decode(codes, scales, params["dec"],
                                      out_dtype)
    z = codes.float() * scales
    return (z @ params["dec"].float()).to(out_dtype)


def roundtrip_st(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Differentiable encode -> quantise -> decode with a straight-through
    estimator on the rounding: the forward is the plain round trip in
    float32; the gradient skips the rounding and treats the scale as a
    constant, as the reference's two ``stop_gradient``s do."""
    z = x.float() @ params["enc"].float()
    s = _absmax_scale(z.detach())
    zq = z / s
    zq = zq + (torch.clamp(torch.round(zq), -127, 127) - zq).detach()
    return ((zq * s) @ params["dec"].float()).to(x.dtype)


def payload_bytes(spec: BottleneckSpec, num_tokens: int) -> int:
    from repro_torch.core.packets import HEADER_BYTES
    return HEADER_BYTES + num_tokens * spec.rank + num_tokens * 2


def recon_loss(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Normalised reconstruction MSE (the distillation regulariser)."""
    xh = roundtrip_st(params, x).float()
    xf = x.float()
    return torch.mean(torch.square(xh - xf)) / (torch.mean(torch.square(xf))
                                                + 1e-8)
