"""Layer-stack machinery (port of ``repro/models/stack.py``).

Every architecture is a sequence of groups; each group's parameters keep
the reference's stacked layout, a leading layer axis on every leaf. The
reference's ``lax.scan`` over layers is a Python loop over that axis here.

Group kinds:
  dense   — attention + dense FFN
  mamba1  — Mamba-1 mixer                     (falcon-mamba)
  mamba2  — Mamba-2 mixer                     (zamba2 backbone)
  hybrid  — Zamba2 super-group: one *shared* attention block (parameters
            shared across all invocations, ``params["shared_attn"]``)
            followed by ``attn_every`` Mamba-2 layers; its leaves carry
            two leading axes, (count, attn_every, ...).
The ``moe`` kind is not ported yet and raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.models import attention, moe as moe_lib, ssm
from repro_torch.models.common import (Layers, layer_norm, leading_axes,
                                       rms_norm)
from repro_torch.models.config import ModelConfig

_ROADMAP = "not ported yet; see ROADMAP.md"


@dataclass(frozen=True)
class GroupSpec:
    kind: str
    count: int
    d_ff: int = 0   # dense FFN width for dense/moe-dense groups


def layer_groups(cfg: ModelConfig) -> List[GroupSpec]:
    if cfg.arch_type == "hybrid":
        ae = cfg.hybrid.attn_every
        assert cfg.num_layers % ae == 0, (cfg.num_layers, ae)
        return [GroupSpec("hybrid", cfg.num_layers // ae)]
    if cfg.arch_type == "ssm":
        return [GroupSpec(f"mamba{cfg.ssm.version}", cfg.num_layers)]
    if cfg.moe is not None:
        out = []
        fk = cfg.moe.first_k_dense
        if fk:
            out.append(GroupSpec("dense", fk, cfg.moe.d_ff_dense or cfg.d_ff))
        out.append(GroupSpec("moe", cfg.num_layers - fk))
        return out
    return [GroupSpec("dense", cfg.num_layers, cfg.d_ff)]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, layers: Layers = None,
              device=None) -> dict:
    """One norm's weights, stacked over ``leading_axes(layers)``."""
    shape = (*leading_axes(layers), cfg.d_model)
    p = {"w": torch.ones(shape, dtype=cfg.pdtype, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(shape, dtype=cfg.pdtype, device=device)
    return p


def apply_norm(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _refuse_moe(spec: GroupSpec) -> None:
    if spec.kind == "moe":
        raise NotImplementedError(f"moe groups are {_ROADMAP}")


def _init_dense_layer(generator: torch.Generator, cfg: ModelConfig,
                      d_ff: int, device=None) -> dict:
    """One unstacked dense layer (the hybrid's shared block)."""
    return {
        "norm1": init_norm(cfg, device=device),
        "attn": attention.init_gqa(generator, cfg, None, device),
        "norm2": init_norm(cfg, device=device),
        "mlp": moe_lib.init_dense_mlp(generator, cfg, d_ff, None, device),
    }


def _init_mamba_layers(generator: torch.Generator, cfg: ModelConfig,
                       lead: Tuple[int, ...], device=None) -> dict:
    init = ssm.init_mamba1 if cfg.ssm.version == 1 else ssm.init_mamba2
    return {"norm": init_norm(cfg, lead, device),
            "mixer": init(generator, cfg, device, lead)}


def init_group(generator: torch.Generator, cfg: ModelConfig,
               spec: GroupSpec, device=None) -> dict:
    """Stacked parameters of one group: every leaf (count, ...), or
    (count, attn_every, ...) for a hybrid group."""
    _refuse_moe(spec)
    n = spec.count
    if spec.kind == "dense":
        return {
            "norm1": init_norm(cfg, n, device),
            "attn": attention.init_gqa(generator, cfg, n, device),
            "norm2": init_norm(cfg, n, device),
            "mlp": moe_lib.init_dense_mlp(generator, cfg, spec.d_ff, n,
                                          device),
        }
    if spec.kind in ("mamba1", "mamba2"):
        return _init_mamba_layers(generator, cfg, (n,), device)
    if spec.kind == "hybrid":
        # only the per-group Mamba-2 layers; the shared attention block
        # lives once at the top level (params["shared_attn"])
        return _init_mamba_layers(generator, cfg,
                                  (n, cfg.hybrid.attn_every), device)
    raise ValueError(spec.kind)


def layer_slice(tree: Any, idx) -> Any:
    """Index (int) or slice the leading layer axis of every leaf."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, idx) for k, v in tree.items()}
    return tree[idx]


# ---------------------------------------------------------------------------
# dense block bodies
# ---------------------------------------------------------------------------


def _dense_block_full(p, cfg, x, positions, mask):
    h, kv = attention.attn_full(p["attn"], cfg,
                                apply_norm(x, p["norm1"], cfg), positions,
                                mask)
    x = x + h
    x = x + moe_lib.dense_mlp(p["mlp"], cfg, apply_norm(x, p["norm2"], cfg))
    return x, kv


def _dense_block_decode(p, cfg, x, positions, cache, slot, mask):
    h, c2 = attention.attn_decode(p["attn"], cfg,
                                  apply_norm(x, p["norm1"], cfg), positions,
                                  cache, slot, mask)
    x = x + h
    x = x + moe_lib.dense_mlp(p["mlp"], cfg, apply_norm(x, p["norm2"], cfg))
    return x, c2


def _dense_block_decode_paged(p, cfg, x, positions, pool, page_table,
                              write_page, write_off, mask, write_src,
                              attn_fn=attention.attn_decode_paged):
    h, c2 = attn_fn(p["attn"], cfg, apply_norm(x, p["norm1"], cfg),
                    positions, pool, page_table, write_page, write_off,
                    mask, write_src)
    x = x + h
    x = x + moe_lib.dense_mlp(p["mlp"], cfg, apply_norm(x, p["norm2"], cfg))
    return x, c2


def _mamba_block_full(p, cfg, x):
    full = ssm.mamba1_full if cfg.ssm.version == 1 else ssm.mamba2_full
    return x + full(p["mixer"], cfg, apply_norm(x, p["norm"], cfg))


def _mamba_block_decode(p, cfg, x, state):
    step = ssm.mamba1_step if cfg.ssm.version == 1 else ssm.mamba2_step
    h, s2 = step(p["mixer"], cfg, apply_norm(x, p["norm"], cfg), state)
    return x + h, s2


def group_forward(params: Any, cfg: ModelConfig, spec: GroupSpec,
                  x: torch.Tensor, positions: torch.Tensor,
                  mask: torch.Tensor, shared_attn: Optional[dict] = None,
                  want_cache: bool = False
                  ) -> Tuple[torch.Tensor, float, Optional[dict]]:
    """Run one group full-sequence. Returns (x, aux_loss, cache_or_None);
    the attention cache leaves are stacked (count, B, S, K, hd). Mamba
    groups return no cache, as the reference's do: their decode starts
    from ``group_empty_cache``."""
    _refuse_moe(spec)
    if spec.kind in ("mamba1", "mamba2"):
        for i in range(spec.count):
            x = _mamba_block_full(layer_slice(params, i), cfg, x)
        return x, 0.0, None
    if spec.kind not in ("dense", "hybrid"):
        raise ValueError(spec.kind)
    ks, vs = [], []
    for i in range(spec.count):
        lp = layer_slice(params, i)
        if spec.kind == "dense":
            x, kv = _dense_block_full(lp, cfg, x, positions, mask)
        else:
            x, kv = _dense_block_full(shared_attn, cfg, x, positions, mask)
            for j in range(cfg.hybrid.attn_every):
                x = _mamba_block_full(layer_slice(lp, j), cfg, x)
        if want_cache:
            ks.append(kv["k"])
            vs.append(kv["v"])
    cache = ({"k": torch.stack(ks), "v": torch.stack(vs)}
             if want_cache else None)
    return x, 0.0, cache


def group_decode(params: Any, cfg: ModelConfig, spec: GroupSpec,
                 x: torch.Tensor, positions: torch.Tensor, cache: dict,
                 slot, mask: torch.Tensor,
                 shared_attn: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, dict]:
    """Single-token decode through one group. ``cache`` is the group's
    ``group_empty_cache`` layout, its leaves updated in place, layer by
    layer. Returns (x, cache)."""
    _refuse_moe(spec)
    for i in range(spec.count):
        lp, c = layer_slice(params, i), layer_slice(cache, i)
        if spec.kind == "dense":
            x, _ = _dense_block_decode(lp, cfg, x, positions, c, slot, mask)
        elif spec.kind in ("mamba1", "mamba2"):
            x, _ = _mamba_block_decode(lp, cfg, x, c)
        elif spec.kind == "hybrid":
            x, _ = _dense_block_decode(shared_attn, cfg, x, positions,
                                       c["attn"], slot, mask)
            for j in range(cfg.hybrid.attn_every):
                x, _ = _mamba_block_decode(layer_slice(lp, j), cfg, x,
                                           layer_slice(c["mamba"], j))
        else:
            raise ValueError(spec.kind)
    return x, cache


def _attention_stacks_only(spec: GroupSpec, what: str) -> None:
    """The paged caches hold attention k/v alone: SSM recurrent state has
    no sequence axis to page (the reference refuses the same kinds)."""
    _refuse_moe(spec)
    if spec.kind != "dense":
        raise NotImplementedError(
            f"{what} covers attention stacks only, not {spec.kind}")


def group_decode_paged(params: Any, cfg: ModelConfig, spec: GroupSpec,
                       x: torch.Tensor, positions: torch.Tensor, pool: dict,
                       page_table: torch.Tensor, write_page: torch.Tensor,
                       write_off: torch.Tensor, mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, dict]:
    """Single-token decode through one group against a shared KV page pool
    (leaves (count, P, page, K, hd)). Each layer gets the contiguous view
    ``pool[l]`` (P, page, K, hd), updated in place and read in place by the
    kernel. Each layer writes the same slots, so which entry keeps a
    slot is resolved once (``attention.last_writes``). Returns (x,
    pool)."""
    _attention_stacks_only(spec, "paged decode")
    src = _write_src(pool, write_page, write_off)
    for i in range(spec.count):
        x, _ = _dense_block_decode_paged(layer_slice(params, i), cfg, x,
                                         positions, layer_slice(pool, i),
                                         page_table, write_page, write_off,
                                         mask, src)
    return x, pool


def _write_src(pool: dict, write_page: torch.Tensor,
               write_off: torch.Tensor) -> torch.Tensor:
    """The winning entry of each entry's slot for a group's pool (leaves
    (count, P, page, K, hd))."""
    P, page = pool["k"].shape[1:3]
    return attention.last_writes(write_page, write_off, page, P)


def group_verify_paged(params: Any, cfg: ModelConfig, spec: GroupSpec,
                       x: torch.Tensor, positions: torch.Tensor, pool: dict,
                       page_table: torch.Tensor, write_page: torch.Tensor,
                       write_off: torch.Tensor, mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, dict]:
    """Multi-token (speculative verify) decode through one group against
    the shared KV page pool: x (B, C, d) chunk tokens, positions /
    write_page / write_off (B, C), mask (B, C, n_pages*page). The layer
    loop of ``group_decode_paged`` with the multi-query attention body.
    Returns (x, pool), the pool updated in place."""
    _attention_stacks_only(spec, "paged verify")
    src = _write_src(pool, write_page, write_off)
    for i in range(spec.count):
        x, _ = _dense_block_decode_paged(layer_slice(params, i), cfg, x,
                                         positions, layer_slice(pool, i),
                                         page_table, write_page, write_off,
                                         mask, src,
                                         attn_fn=attention.attn_verify_paged)
    return x, pool


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _zeros_stacked(tree: Any, lead: Tuple[int, ...]) -> Any:
    """Zeros shaped like ``tree``'s leaves with the leading axes ``lead``
    (every empty cache is zeros, as the reference's broadcasts are)."""
    if isinstance(tree, dict):
        return {k: _zeros_stacked(v, lead) for k, v in tree.items()}
    return tree.new_zeros((*lead, *tree.shape))


def group_empty_cache(cfg: ModelConfig, spec: GroupSpec, batch: int,
                      width: int, device=None) -> Any:
    """One group's decode cache: attention k/v (count, B, width, K, hd),
    Mamba states (count, B, ...), and for a hybrid group both, the states
    (count, attn_every, B, ...)."""
    _refuse_moe(spec)
    n = spec.count
    if spec.kind == "dense":
        return _zeros_stacked(
            attention.empty_cache(cfg, batch, width, device), (n,))
    if spec.kind in ("mamba1", "mamba2"):
        empty = (ssm.mamba1_empty_state if cfg.ssm.version == 1
                 else ssm.mamba2_empty_state)
        return _zeros_stacked(empty(cfg, batch, device), (n,))
    if spec.kind == "hybrid":
        return {
            "attn": _zeros_stacked(
                attention.empty_cache(cfg, batch, width, device), (n,)),
            "mamba": _zeros_stacked(ssm.mamba2_empty_state(cfg, batch,
                                                           device),
                                    (n, cfg.hybrid.attn_every)),
        }
    raise ValueError(spec.kind)


# ---------------------------------------------------------------------------
# parameter counting
# ---------------------------------------------------------------------------


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count: ``init_params`` on the meta device, which
    allocates nothing."""
    from repro_torch.models import model as model_lib
    params = model_lib.init_params(cfg, torch.Generator(), device="meta")
    return sum(t.numel() for t in leaves(params))


def leaves(tree: Any):
    """Yield the tensors of a dict/list/tuple tree, depth first."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree
