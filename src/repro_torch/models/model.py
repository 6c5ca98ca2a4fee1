"""Top-level model API: init / forward / prefill / decode (port of
``repro/models/model.py``).

Batch format: text, {"tokens": (B, S) int}. The audio and VLM frontends,
multi-token prediction, ``loss_fn`` and ``make_train_step`` are not ported
yet (ROADMAP.md, Queue 1: items 3a and 6).

Entry points run on the card unless the caller asks for another device.
Decode caches are updated IN PLACE (the reference returns a rebuilt
copy); ``decode_step`` returns the same dict it was given.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models import stack
from repro_torch.models.common import (cache_mask, causal_mask, fan_in_init,
                                       linear, normal_init)
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

_ROADMAP_3A = "not ported yet; see ROADMAP.md, Queue 1 item 3a"


def _check_text(cfg: ModelConfig) -> None:
    if cfg.modality != "text":
        raise NotImplementedError(f"the {cfg.modality} modality is "
                                  f"{_ROADMAP_3A}")
    if cfg.mtp:
        raise NotImplementedError(f"multi-token prediction is {_ROADMAP_3A}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random weights with the reference's keys, shapes, dtypes and
    distributions (not its bits). ``generator`` must live on ``device``
    (any generator will do for ``device="meta"``, which allocates
    nothing)."""
    _check_text(cfg)
    dev = resolve_device(device)
    p: Params = {
        "embed": normal_init(generator, (cfg.vocab_size, cfg.d_model), 0.02,
                             cfg.pdtype, dev),
        "groups": [stack.init_group(generator, cfg, s, dev)
                   for s in stack.layer_groups(cfg)],
        "final_norm": stack.init_norm(cfg, device=dev),
    }
    if not cfg.tie_embeddings:
        p["head"] = fan_in_init(generator, (cfg.d_model, cfg.vocab_size),
                                cfg.pdtype, dev)
    if cfg.arch_type == "hybrid":
        p["shared_attn"] = stack._init_dense_layer(generator, cfg, cfg.d_ff,
                                                   dev)
    return p


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _embed_tokens(p: Params, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens.long()].to(cfg.adtype)


def _embed_inputs(p: Params, cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor]):
    """Returns (x (B,S,d), positions (B,S))."""
    _check_text(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_tokens(p, cfg, tokens)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return x, positions


def _head(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = stack.apply_norm(x, p["final_norm"], cfg)
    w = p["embed"].T if cfg.tie_embeddings else p["head"]
    return linear(x, w)


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------


def forward(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            want_cache: bool = False):
    """Returns (logits, aux_loss, caches, hidden); hidden is the residual
    stream after the last group, before the final norm."""
    x, positions = _embed_inputs(p, cfg, batch)
    B, S, _ = x.shape
    if cfg.causal:
        mask = causal_mask(S, cfg.sliding_window, device=x.device)[None]
    else:
        mask = torch.zeros((1, S, S), dtype=torch.float32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for spec, gparams in zip(stack.layer_groups(cfg), p["groups"]):
        x, a, c = stack.group_forward(gparams, cfg, spec, x, positions, mask,
                                      shared_attn=p.get("shared_attn"),
                                      want_cache=want_cache)
        aux = aux + a
        caches.append(c)
    logits = _head(p, cfg, x)
    return logits, aux, (caches if want_cache else None), x


# ---------------------------------------------------------------------------
# inference: prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, width: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Decode cache. ``width`` is the KV-cache length; for sliding-window
    configs callers should pass min(width, cfg.sliding_window): slots are a
    ring buffer indexed pos % width. SSM groups carry O(1) state instead."""
    dev = resolve_device(device)
    groups = [stack.group_empty_cache(cfg, s, batch, width, dev)
              for s in stack.layer_groups(cfg)]
    return {
        "groups": groups,
        "positions": torch.full((batch, width), -1, dtype=torch.int32,
                                device=dev),
    }


def prefill_step(p: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]):
    """Full forward that also returns cache contents (width == S) and the
    last-position logits. As in the reference, SSM groups hand no state
    to decode (their cache entry is None)."""
    logits, _, caches, _ = forward(p, cfg, batch, want_cache=True)
    B, S = batch["tokens"].shape[0], logits.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=logits.device)[None].expand(B, S)
    return logits[:, -1:], {"groups": caches, "positions": positions}


def decode_step(p: Params, cfg: ModelConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, pos):
    """One decode step. tokens (B,1) int; pos an int (the absolute
    position of the new token, shared by the batch). Returns
    (logits (B,1,V), cache), the cache updated in place."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    if cfg.rope_style == "mrope":
        raise NotImplementedError(f"M-RoPE is {_ROADMAP_3A}")
    B = tokens.shape[0]
    x = _embed_tokens(p, cfg, tokens)
    pos = int(pos)
    specs = stack.layer_groups(cfg)
    if any(s.kind in ("dense", "moe", "hybrid") for s in specs):
        slot = pos % cache["positions"].shape[1]
        cache["positions"][:, slot] = pos
        mask = cache_mask(cache["positions"], pos, cfg.sliding_window)
    else:
        slot = 0
        mask = torch.zeros((B, 1), dtype=torch.float32, device=x.device)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    for spec, gparams, gcache in zip(specs, p["groups"], cache["groups"]):
        x, _ = stack.group_decode(gparams, cfg, spec, x, positions, gcache,
                                  slot, mask,
                                  shared_attn=p.get("shared_attn"))
    return _head(p, cfg, x), cache
