"""Dense FFN and the Mixture-of-Experts FFN: top-k router and
capacity-based dispatch (port of ``repro/models/moe.py``).

Three dispatch modes compute the same function, as in the reference:
"einsum" (GShard's one-hot dispatch and combine tensors, (T, E, C)),
"scatter" (tokens written straight into (E, C, d) expert buffers by their
rank within the expert) and "grouped" (the scatter with batch rows as
groups, capacity per row). DeepSeek-V3's topology: ``num_shared_experts``
always-on experts, ``first_k_dense`` leading dense layers (``stack.py``),
normalised top-k gates and a load-balance auxiliary loss.

Which tokens a full expert drops is decided by the order of (token, slot)
pairs, token-major, as in the reference: ties in the router's top-k go to
the lower expert index (``jax.lax.top_k``), and ranks within an expert
come from a stable sort. On one rank's share of a batch split over data
ranks (``common.data_parallel``) the router's load statistics are the
whole batch's means, the capacity is the whole batch's, and this rank's
(token, slot) pairs come after those of the ranks before it in that
order, so each rank drops what the whole batch's dispatch drops of its
tokens. The reference's placement hints are ported:
the scatter dispatch's expert buffers carry ``_buf_spec`` and the grouped
dispatch's a batch spec, through ``common.wsc`` (the identity; a dry-run
reckoning reads them).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.common import (ACTIVATIONS, batch_before,
                                       batch_ranks, batch_total,
                                       block_input, fan_in_init, full_fp32,
                                       linear, row_linear, silu, wsc)
from repro_torch.models.config import ModelConfig


def init_dense_mlp(generator: torch.Generator, cfg: ModelConfig, d_ff: int,
                   layers: Optional[int], device=None) -> dict:
    """Stacked dense-FFN weights with a leading layer axis; ``layers=None``
    for one unstacked layer."""
    d, dt = cfg.d_model, cfg.pdtype
    names = ("w_gate", "w_up") if cfg.gated_mlp else ("w_up",)
    p = {n: fan_in_init(generator, (d, d_ff), dt, device, layers)
         for n in names}
    p["w_down"] = fan_in_init(generator, (d_ff, d), dt, device, layers)
    return p


def dense_mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = ACTIVATIONS[cfg.mlp_act]
    x = block_input(x, "mlp")
    if cfg.gated_mlp:
        return row_linear(act(linear(x, p["w_gate"]))
                          * linear(x, p["w_up"]), p["w_down"], "mlp")
    return row_linear(act(linear(x, p["w_up"])), p["w_down"], "mlp")


# ---------------------------------------------------------------------------
# MoE layer
# ---------------------------------------------------------------------------


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             layers: Optional[int], device=None) -> dict:
    """Stacked MoE weights: the router (d, E) in float32, the experts'
    (E, d, f) / (E, f, d) in the parameter dtype (the reference's fan-in
    scale of an (E, ...) leaf), and the shared experts as one dense FFN."""
    m = cfg.moe
    d, E, f, dt = cfg.d_model, m.num_experts, m.d_ff_expert, cfg.pdtype
    p = {
        "router": fan_in_init(generator, (d, E), torch.float32, device,
                              layers),
        "w_gate": fan_in_init(generator, (E, d, f), dt, device, layers),
        "w_up": fan_in_init(generator, (E, d, f), dt, device, layers),
        "w_down": fan_in_init(generator, (E, f, d), dt, device, layers),
    }
    if m.num_shared_experts:
        p["shared"] = init_dense_mlp(
            generator, cfg, m.d_ff_shared * m.num_shared_experts, layers,
            device)
    return p


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    m = cfg.moe
    c = int(math.ceil(num_tokens * m.top_k / m.num_experts
                      * m.capacity_factor))
    return max(4, min(num_tokens, c))


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort keeps equal values in index
    order; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p: dict, cfg: ModelConfig, xt: torch.Tensor):
    """Shared routing: returns (gate_vals (T,k), gate_idx (T,k), the
    selection one-hot (T,k,E) in float32, aux). The logits are a full
    float32 product (no TF32 on the card), as the reference's."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    with full_fp32(xt):
        logits = xt.float() @ p["router"].float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)                        # (T, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    # load-balance auxiliary loss (Switch-style)
    onehot_any = torch.nn.functional.one_hot(gate_idx, E).float()
    # the whole batch's means (me, ce), both sums in one collective
    sums = batch_total(torch.cat([probs.sum(0), onehot_any.sum(1).sum(0)]))
    me, ce = (sums / (xt.shape[0] * batch_ranks())).split(E)
    aux = m.router_aux_weight * E * torch.sum(me * ce)
    return gate_vals, gate_idx, onehot_any, aux


def _expert_ffn(p: dict, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """xe (..., E, C, d) -> (..., E, C, d): each expert's SwiGLU (or SiLU
    up-projection) on its C slots, the products batched over experts."""
    def up(w):
        return torch.matmul(xe, w.to(xe.dtype))
    h = silu(up(p["w_gate"])) * up(p["w_up"]) if cfg.gated_mlp \
        else silu(up(p["w_up"]))
    return torch.matmul(h, p["w_down"].to(xe.dtype))


def _pair_positions(sel: torch.Tensor) -> torch.Tensor:
    """Each (token, slot) pair's position in its expert, ``sel`` (T*k, E)
    the pairs' one-hot rows, token-major: the count of earlier pairs that
    chose the same expert (on one rank's share of a batch, the earlier
    ranks' pairs first)."""
    # the running count down the (token, slot) axis, scanned as the inner
    # axis of (E, T*k): CUDA's scan along an outer axis of 40 columns took
    # 2.7 ms a layer at T*k = 16,384 on an H100
    pos_in_e = torch.cumsum(sel.t(), dim=1).t() - sel             # (T*k, E)
    if batch_ranks() > 1:
        pos_in_e = pos_in_e + batch_before(sel.sum(0))
    return (pos_in_e * sel).sum(-1)


def _moe_einsum(p: dict, cfg: ModelConfig, xt: torch.Tensor, gate_vals,
                gate_idx, onehot_any, C: int) -> torch.Tensor:
    """GShard's one-hot dispatch: (T, E, C) dispatch and combine tensors.
    A (token, slot) pair's position in its expert is the count of earlier
    pairs, token-major, that chose the same expert; pairs at or past C are
    dropped."""
    m = cfg.moe
    T, d = xt.shape
    E, k = m.num_experts, m.top_k
    sel = onehot_any.reshape(T * k, E)                            # token-major
    pos = _pair_positions(sel).reshape(T, k)                      # (T, k)
    keep = (pos < C).float()
    gate_vals = gate_vals * keep
    slot = torch.where(keep > 0, pos, torch.full_like(pos, C)).long()
    pos_oh = torch.nn.functional.one_hot(slot, C + 1)[..., :C].float()
    # each (token, expert) pair sits in at most one slot, so these sums
    # over k have at most one term
    dispatch = torch.einsum("tke,tkc->tec", onehot_any, pos_oh)   # (T,E,C)
    combine = torch.einsum("tke,tkc->tec", onehot_any,
                           pos_oh * gate_vals[..., None])
    xe = (dispatch.to(xt.dtype).reshape(T, E * C).T @ xt).reshape(E, C, d)
    ye = _expert_ffn(p, cfg, xe)
    return combine.to(xt.dtype).reshape(T, E * C) @ ye.reshape(E * C, d)


def _positions_in_expert(flat_e: torch.Tensor) -> torch.Tensor:
    """Rank of each slot within its expert, by a stable sort: slots of one
    expert keep their order, so ranks follow the flat (token-major)
    order."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(n, device=flat_e.device)
    is_start = torch.ones(n, dtype=torch.bool, device=flat_e.device)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    pos = torch.empty_like(idx)
    pos[order] = idx - start
    return pos


def _scatter_plan(gate_idx: torch.Tensor, E: int, C: int,
                  earlier: Optional[torch.Tensor] = None):
    """The destinations of a scatter dispatch: gate_idx (G, n), n = tokens
    x k of one group, token-major, each group with its own E*C buffer.
    Returns (dest (G, n) into the group's buffer, keep (G, n)). Ranks are
    taken within (group, expert): a stable sort on group*E + expert, after
    ``earlier`` (E,) pairs of each expert where given.
    Dropped slots all point at the buffer's last slot, E*C - 1, and carry
    zero payloads; kept slots' destinations are unique (a rank within
    the expert), so no real destination repeats."""
    G, n = gate_idx.shape
    e = gate_idx.long()
    base = torch.arange(G, device=e.device)[:, None] * E
    pos = _positions_in_expert((e + base).reshape(-1)).reshape(G, n)
    if earlier is not None:
        pos = pos + earlier.long()[e]
    keep = pos < C
    dest = torch.where(keep, e * C + pos, torch.full_like(pos, E * C - 1))
    return dest, keep


def _scatter(xg: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
             k: int, slots: int) -> torch.Tensor:
    """xg (G, S, d) -> buffers (G, slots, d). ``index_add_`` with each kept
    payload at its own destination and dropped ones (zeros) at the last
    slot: every duplicate add but one adds zero, so the result is exact in
    any order of the adds, on the card too."""
    G, S, d = xg.shape
    src = xg.repeat_interleave(k, dim=1) * keep[..., None].to(xg.dtype)
    flat = (dest + torch.arange(G, device=dest.device)[:, None] * slots)
    buf = torch.zeros((G * slots, d), dtype=xg.dtype, device=xg.device)
    buf.index_add_(0, flat.reshape(-1), src.reshape(G * S * k, d))
    return buf.reshape(G, slots, d)


def _combine(ye: torch.Tensor, dest, keep, gate_vals: torch.Tensor,
             k: int) -> torch.Tensor:
    """ye (G, slots, d): each token's k slots gathered, scaled by their
    gates (zero where dropped) and summed -> (G, S, d)."""
    G, slots, d = ye.shape
    g = torch.gather(ye, 1, dest[..., None].expand(G, dest.shape[1], d))
    w = gate_vals.reshape(G, -1, 1).to(ye.dtype) * keep[..., None].to(
        ye.dtype)
    return (g * w).reshape(G, -1, k, d).sum(2)


def _buf_spec(cfg: ModelConfig, E: int, C: int, model_size_hint: int = 16):
    """The scatter dispatch's buffer spec: the expert axis over "model"
    when it divides (expert parallel, deepseek's 256 experts), else the
    capacity axis (granite's 40)."""
    if E % model_size_hint == 0:
        return ("model", None, None)
    return (None, "model", None)


def _moe_scatter(p: dict, cfg: ModelConfig, xt: torch.Tensor, gate_vals,
                 gate_idx, C: int) -> torch.Tensor:
    """Sort-based dispatch: tokens scattered straight into (E, C, d)
    expert buffers, the same capacity semantics as the einsum path."""
    m = cfg.moe
    T, d = xt.shape
    E, k = m.num_experts, m.top_k
    earlier = None
    if batch_ranks() > 1:
        earlier = batch_before(torch.bincount(gate_idx.reshape(-1),
                                              minlength=E))
    dest, keep = _scatter_plan(gate_idx.reshape(1, T * k), E, C, earlier)
    buf = wsc(_scatter(xt[None], dest, keep, k, E * C).reshape(E, C, d),
              *_buf_spec(cfg, E, C))
    ye = wsc(_expert_ffn(p, cfg, buf), *_buf_spec(cfg, E, C))
    return _combine(ye.reshape(1, E * C, d), dest, keep, gate_vals, k)[0]


def _moe_grouped(p: dict, cfg: ModelConfig, x: torch.Tensor, gate_vals,
                 gate_idx) -> torch.Tensor:
    """Group-local dispatch: groups are batch rows, capacity is per row
    (``capacity(cfg, S)``), the expert products batched over rows."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    C = capacity(cfg, S)
    dest, keep = _scatter_plan(gate_idx.reshape(B, S * k), E, C)
    buf = wsc(_scatter(x, dest, keep, k, E * C).reshape(B, E, C, d),
              "BATCH", None, None, None)
    ye = wsc(_expert_ffn(p, cfg, buf), "BATCH", None, None,
             None).reshape(B, E * C, d)
    return _combine(ye, dest, keep, gate_vals, k).reshape(B * S, d)


def moe_mlp(p: dict, cfg: ModelConfig,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out, aux_loss). Capacity-dropped (token, slot)
    pairs contribute nothing; the shared experts (if any) and the residual
    carry such tokens."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    # the whole batch's rows and capacity on a rank's share of it
    rows = B * batch_ranks()
    C = capacity(cfg, rows * S)
    xt = x.reshape(T, d)
    gate_vals, gate_idx, onehot_any, aux = _router(p, cfg, xt)
    if m.dispatch == "grouped" and rows > 1:
        out = _moe_grouped(p, cfg, x, gate_vals, gate_idx)
    elif m.dispatch == "scatter" or (m.dispatch == "grouped" and rows == 1):
        out = _moe_scatter(p, cfg, xt, gate_vals, gate_idx, C)
    else:
        out = _moe_einsum(p, cfg, xt, gate_vals, gate_idx, onehot_any, C)
    if m.num_shared_experts:
        out = out + dense_mlp(p["shared"], cfg, xt)
    return out.reshape(B, S, d), aux
