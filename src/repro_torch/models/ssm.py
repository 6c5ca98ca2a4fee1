"""Mamba-1 (selective scan) and Mamba-2 (SSD) blocks (port of
``repro/models/ssm.py``).

Both expose:
  * ``*_full``  — the full-sequence path: a log-depth doubling scan in
                  plain torch, or the selective-scan CUDA kernel
                  (``kernels/ssm_scan``) with ``use_ssm_kernel``;
  * ``*_step``  — the O(1) single-token recurrence for decode, carrying
                  {"conv": (B, K-1, d_conv_ch), "h": state}.

Every step keeps the reference's dtypes: the projections and the causal
conv in the activation dtype, the scan and its decay / drive in float32.
Decode states are updated IN PLACE (the reference returns new arrays);
the returned dict holds the same tensors.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (fan_in_init, linear, normal_init,
                                       rms_norm, silu)
from repro_torch.models.config import ModelConfig


def _dt_rank(cfg: ModelConfig) -> int:
    s = cfg.ssm
    return s.dt_rank if s.dt_rank else max(1, math.ceil(cfg.d_model / 16))


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def _dt_bias(generator: torch.Generator, shape: Tuple[int, ...],
             device) -> torch.Tensor:
    """dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] log-uniformly
    (the inverse softplus of the drawn dt), in float32."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return dt + torch.log(-torch.expm1(-dt))


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------


def init_mamba1(generator: torch.Generator, cfg: ModelConfig, device=None,
                lead: Tuple[int, ...] = ()) -> dict:
    """One layer's weights, or with ``lead`` a stack of layers: every leaf
    gets the leading axes ``lead``."""
    s = cfg.ssm
    d, di, N, K = cfg.d_model, d_inner(cfg), s.state_size, s.conv_kernel
    R = _dt_rank(cfg)
    dt = cfg.pdtype
    # S4D-real initialisation of A
    A = torch.arange(1, N + 1, dtype=torch.float32,
                     device=device).expand(*lead, di, N)
    return {
        "in_proj": fan_in_init(generator, (d, 2 * di), dt, device, lead),
        "conv_w": normal_init(generator, (*lead, K, di), 0.1, dt, device),
        "conv_b": torch.zeros((*lead, di), dtype=dt, device=device),
        "x_proj": fan_in_init(generator, (di, R + 2 * N), dt, device, lead),
        "dt_proj": fan_in_init(generator, (R, di), dt, device, lead),
        "dt_bias": _dt_bias(generator, (*lead, di), device).to(dt),
        "A_log": torch.log(A).to(dt),
        "D": torch.ones((*lead, di), dtype=dt, device=device),
        "out_proj": fan_in_init(generator, (di, d), dt, device, lead),
    }


def _causal_conv_full(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B,S,C), w (K,C); the K products summed
    in x's dtype, tap by tap, as the reference sums them."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, K):
        out = out + pad[:, i:i + S, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _selective_scan(decay: torch.Tensor, drive: torch.Tensor
                    ) -> torch.Tensor:
    """h_t = decay_t * h_{t-1} + drive_t, scan over axis 1 (seq): the
    doubling (Hillis-Steele) form of the reference's
    ``associative_scan``, ceil(log2 S) passes of the same combine
    (a2 * a1, a2 * b1 + b2). ``decay`` may be any shape that broadcasts
    to ``drive``'s (the Mamba-2 decay is per head), and is combined at
    its own size."""
    a, b = decay, drive.clone()
    S, off = b.shape[1], 1
    while off < S:
        b[:, off:] = a[:, off:] * b[:, :-off] + b[:, off:]
        if 2 * off < S:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def _mamba1_core(p: dict, cfg: ModelConfig, u: torch.Tensor):
    """Shared Δ/B/C computation. u: (B,S,di) post-conv activations."""
    s = cfg.ssm
    N, R = s.state_size, _dt_rank(cfg)
    dbc = linear(u, p["x_proj"]).float()
    dt = F.softplus(linear(dbc[..., :R], p["dt_proj"]).float()
                    + p["dt_bias"].float())                  # (B,S,di)
    Bm = dbc[..., R:R + N]                                    # (B,S,N)
    Cm = dbc[..., R + N:]                                     # (B,S,N)
    A = -torch.exp(p["A_log"].float())                        # (di,N)
    decay = torch.exp(dt[..., None] * A[None, None])          # (B,S,di,N)
    drive = (dt * u.float())[..., None] * Bm[:, :, None, :]
    return decay, drive, Cm


def mamba1_full(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    di = d_inner(cfg)
    xz = linear(x, p["in_proj"])
    u, z = xz[..., :di], xz[..., di:]
    u = silu(_causal_conv_full(u, p["conv_w"], p["conv_b"]))
    decay, drive, Cm = _mamba1_core(p, cfg, u)
    if cfg.use_ssm_kernel:
        from repro_torch.kernels.ssm_scan import ops as scan_ops
        h = scan_ops.chunked_scan(decay, drive)
    else:
        h = _selective_scan(decay, drive)                     # (B,S,di,N)
    y = torch.einsum("bscn,bsn->bsc", h, Cm)
    y = y + p["D"].float() * u.float()
    y = (y * silu(z.float())).to(x.dtype)
    return linear(y, p["out_proj"])


def mamba1_empty_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    s = cfg.ssm
    di = d_inner(cfg)
    return {
        "conv": torch.zeros((batch, s.conv_kernel - 1, di),
                            dtype=cfg.adtype, device=device),
        "h": torch.zeros((batch, di, s.state_size), dtype=torch.float32,
                         device=device),
    }


def _conv_step(p: dict, state: dict, xc: torch.Tensor):
    """One causal-conv step: (silu(conv over [state; xc]), new window)."""
    window = torch.cat([state["conv"], xc[:, None, :]], dim=1)  # (B,K,C)
    out = silu(torch.einsum("bkc,kc->bc", window,
                            p["conv_w"].to(window.dtype))
               + p["conv_b"].to(window.dtype))
    return out, window


def mamba1_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
                state: dict) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d). Returns (out (B,1,d), state), the state updated in
    place."""
    di = d_inner(cfg)
    xz = linear(x[:, 0], p["in_proj"])
    u, z = xz[..., :di], xz[..., di:]
    u, window = _conv_step(p, state, u)
    decay, drive, Cm = _mamba1_core(p, cfg, u[:, None, :])
    h = decay[:, 0] * state["h"] + drive[:, 0]                # (B,di,N)
    y = torch.einsum("bcn,bn->bc", h, Cm[:, 0])
    y = y + p["D"].float() * u.float()
    y = (y * silu(z.float())).to(x.dtype)
    out = linear(y, p["out_proj"])[:, None, :]
    state["conv"].copy_(window[:, 1:])
    state["h"].copy_(h)
    return out, state


# ---------------------------------------------------------------------------
# Mamba-2 (SSD, scalar decay per head)
# ---------------------------------------------------------------------------


def _m2_dims(cfg: ModelConfig):
    s = cfg.ssm
    di = d_inner(cfg)
    nh = di // s.head_dim
    return di, nh, s.head_dim, s.state_size


def init_mamba2(generator: torch.Generator, cfg: ModelConfig, device=None,
                lead: Tuple[int, ...] = ()) -> dict:
    """One layer's weights, or with ``lead`` a stack of layers: every leaf
    gets the leading axes ``lead``."""
    s = cfg.ssm
    di, nh, P, N = _m2_dims(cfg)
    d = cfg.d_model
    dt = cfg.pdtype
    # in_proj emits [z(di), x(di), B(N), C(N), dt(nh)]
    return {
        "in_proj": fan_in_init(generator, (d, 2 * di + 2 * N + nh), dt,
                               device, lead),
        "conv_w": normal_init(generator, (*lead, s.conv_kernel, di + 2 * N),
                              0.1, dt, device),
        "conv_b": torch.zeros((*lead, di + 2 * N), dtype=dt, device=device),
        "A_log": torch.zeros((*lead, nh), dtype=dt, device=device),  # A=-1
        "dt_bias": _dt_bias(generator, (*lead, nh), device).to(dt),
        "D": torch.ones((*lead, nh), dtype=dt, device=device),
        "norm_w": torch.ones((*lead, di), dtype=dt, device=device),
        "out_proj": fan_in_init(generator, (di, d), dt, device, lead),
    }


def _m2_split(p, cfg, raw):
    di, nh, P, N = _m2_dims(cfg)
    z = raw[..., :di]
    xBC = raw[..., di:2 * di + 2 * N]
    dt = raw[..., 2 * di + 2 * N:]
    return z, xBC, dt


def _m2_gated_out(p, cfg, y, z, x_dtype):
    y = y * silu(z.float())
    y = rms_norm(y.to(x_dtype), p["norm_w"], cfg.norm_eps)
    return linear(y, p["out_proj"])


def mamba2_full(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """With ``use_ssm_kernel`` the per-head decay is materialised at
    (B, S, nh * P, N), as the reference's ``broadcast_to(...).reshape``
    does, and the kernel reads it contiguous; the plain scan combines it
    at (B, S, nh, 1, 1) and broadcasts, which computes the same values."""
    B, S, d = x.shape
    di, nh, P, N = _m2_dims(cfg)
    raw = linear(x, p["in_proj"])
    z, xBC, dt = _m2_split(p, cfg, raw)
    xBC = silu(_causal_conv_full(xBC, p["conv_w"], p["conv_b"]))
    u = xBC[..., :di].reshape(B, S, nh, P)
    Bm = xBC[..., di:di + N]
    Cm = xBC[..., di + N:]
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                        # (nh,)
    decay = torch.exp(dt * A[None, None, :])                  # (B,S,nh)
    drive = (dt[..., None] * u.float())[..., None] \
        * Bm[:, :, None, None, :].float()                     # (B,S,nh,P,N)
    if cfg.use_ssm_kernel:
        from repro_torch.kernels.ssm_scan import ops as scan_ops
        full = decay[..., None, None].expand(drive.shape)
        h = scan_ops.chunked_scan(
            full.reshape(B, S, nh * P, N),
            drive.reshape(B, S, nh * P, N)).reshape(B, S, nh, P, N)
    else:
        h = _selective_scan(decay[..., None, None], drive)    # (B,S,nh,P,N)
    y = torch.einsum("bshpn,bsn->bshp", h, Cm.float())
    y = y + p["D"].float()[None, None, :, None] * u.float()
    return _m2_gated_out(p, cfg, y.reshape(B, S, di), z, x.dtype)


def mamba2_empty_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    s = cfg.ssm
    di, nh, P, N = _m2_dims(cfg)
    return {
        "conv": torch.zeros((batch, s.conv_kernel - 1, di + 2 * N),
                            dtype=cfg.adtype, device=device),
        "h": torch.zeros((batch, nh, P, N), dtype=torch.float32,
                         device=device),
    }


def mamba2_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
                state: dict) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d). Returns (out (B,1,d), state), the state updated in
    place."""
    B = x.shape[0]
    di, nh, P, N = _m2_dims(cfg)
    raw = linear(x[:, 0], p["in_proj"])
    z, xBC, dt = _m2_split(p, cfg, raw)
    xBC, window = _conv_step(p, state, xBC)
    u = xBC[..., :di].reshape(B, nh, P)
    Bm = xBC[..., di:di + N].float()
    Cm = xBC[..., di + N:].float()
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A[None, :])                        # (B,nh)
    h = decay[..., None, None] * state["h"] \
        + (dt[..., None] * u.float())[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cm)
    y = y + p["D"].float()[None, :, None] * u.float()
    out = _m2_gated_out(p, cfg, y.reshape(B, di), z, x.dtype)[:, None, :]
    state["conv"].copy_(window[:, 1:])
    state["h"].copy_(h)
    return out, state
