"""Layer-stack machinery (port of ``repro/models/stack.py``).

Every architecture is a sequence of groups; each group's parameters keep
the reference's stacked layout, a leading layer axis on every leaf. The
reference's ``lax.scan`` over layers is a Python loop over that axis here.
Only dense groups are ported; the other kinds raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.models import attention, moe as moe_lib
from repro_torch.models.common import layer_norm, rms_norm
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


def init_norm(cfg: ModelConfig, layers: Optional[int] = None,
              device=None) -> dict:
    shape = (cfg.d_model,) if layers is None else (layers, cfg.d_model)
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


def _require_dense(spec: GroupSpec) -> None:
    if spec.kind != "dense":
        raise NotImplementedError(f"{spec.kind} groups are {_ROADMAP}")


def init_group(generator: torch.Generator, cfg: ModelConfig,
               spec: GroupSpec, device=None) -> dict:
    """Stacked dense-layer parameters: every leaf (count, ...)."""
    _require_dense(spec)
    n = spec.count
    return {
        "norm1": init_norm(cfg, n, device),
        "attn": attention.init_gqa(generator, cfg, n, device),
        "norm2": init_norm(cfg, n, device),
        "mlp": moe_lib.init_dense_mlp(generator, cfg, spec.d_ff, n, device),
    }


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
                              write_page, write_off, mask,
                              attn_fn=attention.attn_decode_paged):
    h, c2 = attn_fn(p["attn"], cfg, apply_norm(x, p["norm1"], cfg),
                    positions, pool, page_table, write_page, write_off,
                    mask)
    x = x + h
    x = x + moe_lib.dense_mlp(p["mlp"], cfg, apply_norm(x, p["norm2"], cfg))
    return x, c2


def group_forward(params: Any, cfg: ModelConfig, spec: GroupSpec,
                  x: torch.Tensor, positions: torch.Tensor,
                  mask: torch.Tensor, want_cache: bool = False
                  ) -> Tuple[torch.Tensor, float, Optional[dict]]:
    """Run one group full-sequence. Returns (x, aux_loss, cache_or_None);
    the cache leaves are stacked (count, B, S, K, hd)."""
    _require_dense(spec)
    ks, vs = [], []
    for i in range(spec.count):
        x, kv = _dense_block_full(layer_slice(params, i), cfg, x, positions,
                                  mask)
        if want_cache:
            ks.append(kv["k"])
            vs.append(kv["v"])
    cache = ({"k": torch.stack(ks), "v": torch.stack(vs)}
             if want_cache else None)
    return x, 0.0, cache


def group_decode(params: Any, cfg: ModelConfig, spec: GroupSpec,
                 x: torch.Tensor, positions: torch.Tensor, cache: dict,
                 slot, mask: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Single-token decode through one group. ``cache`` leaves are stacked
    (count, B, W, K, hd) and are updated in place, layer by layer. Returns
    (x, cache)."""
    _require_dense(spec)
    for i in range(spec.count):
        x, _ = _dense_block_decode(layer_slice(params, i), cfg, x, positions,
                                   layer_slice(cache, i), slot, mask)
    return x, cache


def group_decode_paged(params: Any, cfg: ModelConfig, spec: GroupSpec,
                       x: torch.Tensor, positions: torch.Tensor, pool: dict,
                       page_table: torch.Tensor, write_page: torch.Tensor,
                       write_off: torch.Tensor, mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, dict]:
    """Single-token decode through one group against a shared KV page pool
    (leaves (count, P, page, K, hd)). Each layer gets the contiguous view
    ``pool[l]`` (P, page, K, hd), updated in place and read in place by the
    kernel. Returns (x, pool)."""
    _require_dense(spec)
    for i in range(spec.count):
        x, _ = _dense_block_decode_paged(layer_slice(params, i), cfg, x,
                                         positions, layer_slice(pool, i),
                                         page_table, write_page, write_off,
                                         mask)
    return x, pool


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
    _require_dense(spec)
    for i in range(spec.count):
        x, _ = _dense_block_decode_paged(layer_slice(params, i), cfg, x,
                                         positions, layer_slice(pool, i),
                                         page_table, write_page, write_off,
                                         mask,
                                         attn_fn=attention.attn_verify_paged)
    return x, pool
