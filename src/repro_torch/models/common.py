"""Shared NN primitives: norms, activations, RoPE, masks, inits (port of
``repro/models/common.py``).

Plain functions on tensors; every function takes its parameters
explicitly. Norms and RoPE compute in float32 and cast back, as the
reference does.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# initialisation (mirrors the reference's distributions, not its bits)
# ---------------------------------------------------------------------------


def normal_init(generator: torch.Generator, shape: Sequence[int],
                scale: float, dtype=torch.float32,
                device=None) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


Layers = Union[int, Tuple[int, ...], None]


def leading_axes(layers: Layers) -> Tuple[int, ...]:
    """The leading axes of a stacked leaf: none for one layer (None), a
    layer axis (an int), or several (a tuple)."""
    if layers is None:
        return ()
    return (layers,) if isinstance(layers, int) else tuple(layers)


def fan_in_init(generator: torch.Generator, shape: Sequence[int],
                dtype=torch.float32, device=None,
                layers: Layers = None) -> torch.Tensor:
    """LeCun-style init for a (fan_in, fan_out) weight matrix, stacked
    over ``leading_axes(layers)``."""
    scale = 1.0 / math.sqrt(max(1, shape[0]))
    return normal_init(generator, (*leading_axes(layers), *shape), scale,
                       dtype, device)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def relu2(x: torch.Tensor) -> torch.Tensor:
    r = torch.relu(x)
    return r * r


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, as ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": silu, "relu2": relu2, "gelu": gelu}


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, dim: int,
                 theta: float) -> torch.Tensor:
    """positions (...,) -> angles (..., dim//2) in float32."""
    half = dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** exps)
    return positions.float()[..., None] * inv_freq


def _apply_angles(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate-half convention. x (B, S, H, D); angles (B, S, D//2)."""
    dtype = x.dtype
    xf = x.float()
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    cos = torch.cos(angles)[..., None, :]             # (B, S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Standard 1-D RoPE. x: (B, S, H, D), positions: (B, S)."""
    return _apply_angles(x, _rope_angles(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# masking helpers (additive, with the finite NEG_INF of the reference)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def causal_mask(seq_len: int, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """(S, S) additive mask. window=None -> full causal; else sliding."""
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    ok = j <= i
    if window is not None:
        ok = ok & (j > i - window)
    return _additive(ok)


def cache_mask(cache_positions: torch.Tensor, pos,
               window: Optional[int] = None) -> torch.Tensor:
    """Additive mask over cache slots for single-token decode.

    cache_positions: (B, W) absolute position per slot (-1 = empty);
    pos: the decoded token's position — a scalar, or (B, 1) per row.
    """
    ok = (cache_positions >= 0) & (cache_positions <= pos)
    if window is not None:
        ok = ok & (cache_positions > pos - window)
    return _additive(ok)


def _additive(ok: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, neg)
