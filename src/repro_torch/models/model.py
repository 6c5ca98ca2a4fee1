"""Top-level model API: init / forward / prefill / decode (port of
``repro/models/model.py``).

Batch formats:

  text : {"tokens": (B,S) int}
  audio: {"frames": (B,S,frontend_dim) float, ...}   (HuBERT; the masked-
         prediction targets are the training loss's)
  vlm  : {"tokens": (B,S) int, "vision_embeds": (B,n_vis,frontend_dim)
         float, "positions": (3,B,S) int}             (M-RoPE streams)

The audio feature extractor and the VLM's ViT are stubs, as in the
reference: inputs arrive as frame / patch embeddings; the audio batch also
carries the masked-prediction targets, {"targets": (B,S) int,
"mask_positions": (B,S) bool}.

``loss_fn`` is the reference's training loss: next-token cross-entropy
(the VLM's vision positions masked out; audio's masked prediction), the
MoE router loss, and with ``cfg.mtp`` the multi-token prediction loss.
``make_train_step`` takes its gradients with ``torch.autograd.grad`` and
applies an ``optim.Optimizer``; nothing in a step is read to the host.

Entry points run on the card unless the caller asks for another device.
Decode caches are updated IN PLACE (the reference returns a rebuilt
copy); ``decode_step`` returns the same dict it was given.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models import stack
from repro_torch.models.common import (batch_ranks, batch_total, cache_mask,
                                       causal_mask, embed_rows, fan_in_init,
                                       linear, normal_init,
                                       sinusoid_positions, vocab_linear)
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random weights with the reference's keys, shapes, dtypes and
    distributions (not its bits). ``generator`` must live on ``device``
    (any generator will do for ``device="meta"``, which allocates
    nothing)."""
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
    if cfg.modality in ("audio", "vlm"):
        name = "feat_proj" if cfg.modality == "audio" else "vision_proj"
        p[name] = fan_in_init(generator, (cfg.frontend_dim, cfg.d_model),
                              cfg.pdtype, dev)
    if cfg.mtp:
        p["mtp"] = {
            "proj": fan_in_init(generator, (2 * cfg.d_model, cfg.d_model),
                                cfg.pdtype, dev),
            "block": stack._init_dense_layer(
                generator, cfg,
                cfg.d_ff or (cfg.moe.d_ff_dense if cfg.moe else 0), dev),
            "norm": stack.init_norm(cfg, device=dev),
        }
    return p


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _embed_tokens(p: Params, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    return embed_rows(p["embed"], tokens).to(cfg.adtype)


def _embed_inputs(p: Params, cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor]):
    """Returns (x (B,S,d), positions), positions (B,S) or, for the VLM,
    the batch's (3,B,S) M-RoPE streams. Audio frames are projected and
    given sinusoid positions; the VLM's projected vision embeddings take
    the first ``num_vision_tokens`` positions, the embedded
    ``tokens[:, nv:]`` the rest."""
    if cfg.modality == "audio":
        frames = batch["frames"]
        B, S, _ = frames.shape
        x = linear(frames.to(cfg.adtype), p["feat_proj"])
        x = x + sinusoid_positions(S, cfg.d_model, cfg.adtype,
                                   x.device)[None]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        return x, positions
    if cfg.modality == "vlm":
        tokens = batch["tokens"]
        nv = cfg.num_vision_tokens
        x_vis = linear(batch["vision_embeds"].to(cfg.adtype),
                       p["vision_proj"])
        x_txt = _embed_tokens(p, cfg, tokens[:, nv:])
        return torch.cat([x_vis, x_txt], dim=1), batch["positions"]
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_tokens(p, cfg, tokens)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return x, positions


def _head(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = stack.apply_norm(x, p["final_norm"], cfg)
    w = p["embed"].T if cfg.tie_embeddings else p["head"]
    return vocab_linear(x, w)


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
# losses / train step
# ---------------------------------------------------------------------------


def _xent(logits: torch.Tensor, targets: torch.Tensor,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in float32; with ``mask``, the mean
    over the masked positions (``+ 1e-6`` under the count). On one rank's
    share of a batch split over data ranks (``common.data_parallel``), the
    whole batch's mean: the sum and the count over the ranks."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return batch_total(torch.sum(nll)) / (nll.numel() * batch_ranks())
    mask = mask.float()
    total, count = batch_total(torch.stack([torch.sum(nll * mask),
                                            torch.sum(mask)]))
    return total / (count + 1e-6)


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics): ``loss`` (cross-entropy), ``aux_loss`` (the
    MoE router loss, 0 elsewhere), ``mtp_loss`` (with ``cfg.mtp`` on a
    text model: the MTP block predicts token t+2 from the final hidden
    state at t and the embedding of token t+1, weighted by
    ``cfg.mtp_weight``) and ``total_loss``; each a float32 0-d tensor."""
    logits, aux, _, hidden = forward(p, cfg, batch)
    if cfg.modality == "audio":
        loss = _xent(logits, batch["targets"], batch["mask_positions"])
    else:
        tokens = batch["tokens"]
        lmask = None
        if cfg.modality == "vlm":
            # vision positions carry patch embeddings, not predictable tokens
            lmask = (torch.arange(tokens.shape[1] - 1, device=tokens.device)
                     >= cfg.num_vision_tokens).expand(tokens[:, 1:].shape)
        loss = _xent(logits[:, :-1], tokens[:, 1:], lmask)
    total = loss + aux
    metrics = {"loss": loss, "aux_loss": aux}
    if cfg.mtp and cfg.modality == "text":
        tokens = batch["tokens"]
        emb_next = _embed_tokens(p, cfg, tokens[:, 1:])
        h_in = torch.cat(
            [stack.apply_norm(hidden[:, :-1], p["mtp"]["norm"], cfg),
             emb_next], dim=-1)
        h_in = linear(h_in, p["mtp"]["proj"])
        B, S1 = h_in.shape[:2]
        positions = torch.arange(S1, dtype=torch.int32,
                                 device=h_in.device)[None].expand(B, S1)
        mtp_h, _ = stack._dense_block_full(
            p["mtp"]["block"], cfg, h_in, positions,
            causal_mask(S1, cfg.sliding_window, device=h_in.device)[None])
        mtp_logits = _head(p, cfg, mtp_h)[:, :-1]
        mtp_loss = _xent(mtp_logits, tokens[:, 2:])
        total = total + cfg.mtp_weight * mtp_loss
        metrics["mtp_loss"] = mtp_loss
    metrics["total_loss"] = total
    return total, metrics


def _trainable(t: torch.Tensor) -> torch.Tensor:
    """A leaf autograd can differentiate with respect to, sharing ``t``'s
    storage (a clone if ``t`` was made under ``torch.inference_mode``,
    which autograd cannot save)."""
    t = t.detach()
    if t.is_inference():
        t = t.clone()
    return t.requires_grad_()


def value_and_grad(fn, p: Params):
    """The reference's ``jax.value_and_grad(fn, has_aux=True)(p)`` for
    ``fn(p) -> (value, metrics dict)``: (value, metrics, grads), the
    gradients of the value with respect to every floating leaf of ``p`` in
    a tree like ``p`` (``None`` for a leaf the value never reads, and for
    non-floating leaves), everything returned detached. Must run outside
    ``torch.inference_mode``; ``p`` may come from inside it."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError("training cannot run under torch.inference_mode")
    with torch.enable_grad():
        live = stack.tree_map(
            lambda t: _trainable(t) if t.is_floating_point() else t, p)
        wrt = [t for t in stack.leaves(live) if t.requires_grad]
        total, metrics = fn(live)
        grads = iter(torch.autograd.grad(total, wrt, allow_unused=True))
    grads = stack.tree_map(
        lambda t: next(grads) if t.requires_grad else None, live)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def loss_and_grads(p: Params, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor]):
    """``value_and_grad`` of ``loss_fn``: (total, metrics, grads)."""
    return value_and_grad(lambda q: loss_fn(q, cfg, batch), p)


def make_train_step(cfg: ModelConfig, optimizer):
    """optimizer: ``repro_torch.optim.Optimizer``. Returns
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``loss_and_grads``, one optimizer update (a ``None``
    gradient counts as zeros), and ``loss_fn``'s metrics plus
    ``grad_norm`` (the unclipped global norm). Every metric is a 0-d
    device tensor; nothing is read to the host."""
    def train_step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(params, cfg, batch)
        params, opt_state = optimizer.apply(params, opt_state, grads)
        metrics["grad_norm"] = torch.sqrt(sum(
            torch.sum(torch.square(g.float()))
            for g in stack.leaves(grads) if g is not None))
        return params, opt_state, metrics
    return train_step


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
    to decode (their cache entry is None), and an encoder-only (audio)
    model returns (logits at every position, None)."""
    logits, _, caches, _ = forward(p, cfg, batch, want_cache=True)
    if cfg.modality == "audio":
        return logits, None
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
    # M-RoPE: the one position drives all three streams
    shape = (3, B, 1) if cfg.rope_style == "mrope" else (B, 1)
    positions = torch.full(shape, pos, dtype=torch.int32, device=x.device)
    for spec, gparams, gcache in zip(specs, p["groups"], cache["groups"]):
        x, _ = stack.group_decode(gparams, cfg, spec, x, positions, gcache,
                                  slot, mask,
                                  shared_attn=p.get("shared_attn"))
    return _head(p, cfg, x), cache
