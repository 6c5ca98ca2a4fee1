"""LISA-style grounded VLM pipeline (port of ``repro/core/vlm.py``): SAM
vision backbone + CLIP context encoder + multi-modal LLM +
<SEG>-conditioned mask decoder, as plain functions over the reference's
parameter dict.

  EDGE : patchify -> SAM blocks [0,k)        (Insight head, split@k)
         resize -> CLIP encoder              (Context stream)
  CLOUD: SAM blocks [k,L) -> mask features
         LLM([ctx tokens; query]) -> answer logits + <SEG> embedding
         mask decoder(SAM feats, <SEG>) -> segmentation mask logits
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.lisa7b import LISAPipelineConfig
from repro_torch.core import bottleneck as bn
from repro_torch.core.paging import TRASH_PAGE
from repro_torch.models import stack
from repro_torch.models.common import (cache_mask, causal_mask, embed_rows,
                                       fan_in_init, gelu, linear, normal_init,
                                       vocab_linear)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import _xent

# ---------------------------------------------------------------------------
# patch embedding / encoders
# ---------------------------------------------------------------------------


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, T, patch*patch*C), row-major patches."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def _init_encoder(generator: torch.Generator, cfg: ModelConfig, patch: int,
                  num_tokens: int, device, in_ch: int = 3) -> dict:
    spec = stack.layer_groups(cfg)[0]
    return {
        "patch_w": fan_in_init(generator, (patch * patch * in_ch,
                                           cfg.d_model), cfg.pdtype, device),
        "patch_b": torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                               device=device),
        "pos": normal_init(generator, (num_tokens, cfg.d_model), 0.02,
                           cfg.pdtype, device),
        "groups": [stack.init_group(generator, cfg, spec, device)],
        "norm": stack.init_norm(cfg, device=device),
    }


def _encoder_embed(p: dict, cfg: ModelConfig, images: torch.Tensor,
                   patch: int) -> torch.Tensor:
    x = linear(patchify(images, patch).to(cfg.adtype), p["patch_w"],
               p["patch_b"])
    return x + p["pos"][None].to(cfg.adtype)


def _encoder_blocks(p_groups, cfg: ModelConfig, x: torch.Tensor,
                    lo: int = 0, hi: Optional[int] = None) -> torch.Tensor:
    """Run encoder blocks [lo, hi) — the depth-wise split."""
    full = stack.layer_groups(cfg)[0]
    hi = full.count if hi is None else hi
    if lo == hi:
        return x
    gp = stack.layer_slice(p_groups[0], slice(lo, hi))
    spec = dataclasses.replace(full, count=hi - lo)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    mask = torch.zeros((1, S, S), dtype=torch.float32, device=x.device)
    x, _, _ = stack.group_forward(gp, cfg, spec, x, positions, mask)
    return x


# ---------------------------------------------------------------------------
# LISA model
# ---------------------------------------------------------------------------


def init_lisa(pcfg: LISAPipelineConfig, generator: torch.Generator,
              device: DeviceLike = None) -> dict:
    """Random weights with the reference's keys, shapes, dtypes and
    distributions (not its bits) — for full-width runs on the card, where
    the reference cannot run. Parity tests bridge the reference's own
    weights instead. ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    llm = pcfg.llm
    d_sam, d_clip, d_llm = pcfg.sam.d_model, pcfg.clip.d_model, llm.d_model
    g = generator
    return {
        "sam": _init_encoder(g, pcfg.sam, pcfg.patch_size, pcfg.sam_tokens,
                             dev),
        "clip": _init_encoder(g, pcfg.clip, pcfg.context_patch_size,
                              pcfg.clip_tokens, dev),
        "clip_proj": fan_in_init(g, (d_clip, d_llm), llm.pdtype, dev),
        "llm": {
            "embed": normal_init(g, (llm.vocab_size, d_llm), 0.02,
                                 llm.pdtype, dev),
            "groups": [stack.init_group(g, llm, stack.layer_groups(llm)[0],
                                        dev)],
            "norm": stack.init_norm(llm, device=dev),
            "answer_head": fan_in_init(g, (d_llm, llm.vocab_size),
                                       llm.pdtype, dev),
        },
        "seg_proj": fan_in_init(g, (d_llm, d_sam), llm.pdtype, dev),
        "mask_head": {
            "w1": fan_in_init(g, (d_sam, d_sam), pcfg.sam.pdtype, dev),
            "b1": torch.zeros((d_sam,), dtype=pcfg.sam.pdtype, device=dev),
            "w2": fan_in_init(g, (d_sam, max(1, pcfg.mask_pixels_per_patch)),
                              pcfg.sam.pdtype, dev),
        },
    }


# ----- edge-side stages -----


def sam_head(params: dict, pcfg: LISAPipelineConfig, images: torch.Tensor,
             split_k: Optional[int] = None) -> torch.Tensor:
    """Edge prefix of the SAM backbone: patchify + blocks [0, k)."""
    k = pcfg.split_layer if split_k is None else split_k
    p = params["sam"]
    x = _encoder_embed(p, pcfg.sam, images, pcfg.patch_size)
    return _encoder_blocks(p["groups"], pcfg.sam, x, 0, k)


def clip_encode(params: dict, pcfg: LISAPipelineConfig,
                images: torch.Tensor) -> torch.Tensor:
    """Context stream: low-res CLIP features projected to LLM width,
    (B, clip_tokens, d_llm). Images are resized to the context resolution
    first; ``jax.image.resize(method="linear")`` antialiases when it
    shrinks, which bilinear ``F.interpolate`` matches with
    ``antialias=True``."""
    p = params["clip"]
    size = pcfg.context_image_size
    if images.shape[1] != size:
        x = images.float().permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(size, size), mode="bilinear",
                          antialias=True, align_corners=False)
        images = x.permute(0, 2, 3, 1).to(images.dtype)
    x = _encoder_embed(p, pcfg.clip, images, pcfg.context_patch_size)
    x = _encoder_blocks(p["groups"], pcfg.clip, x)
    x = stack.apply_norm(x, p["norm"], pcfg.clip)
    return linear(x, params["clip_proj"])


# ----- cloud-side stages -----


def sam_tail(params: dict, pcfg: LISAPipelineConfig, x: torch.Tensor,
             split_k: Optional[int] = None) -> torch.Tensor:
    """Cloud suffix: blocks [k, L) + final norm -> mask features."""
    k = pcfg.split_layer if split_k is None else split_k
    p = params["sam"]
    x = _encoder_blocks(p["groups"], pcfg.sam, x, k, None)
    return stack.apply_norm(x, p["norm"], pcfg.sam)


def _llm_trunk(params: dict, pcfg: LISAPipelineConfig,
               ctx_tokens: torch.Tensor, query_tokens: torch.Tensor,
               want_cache: bool = False):
    """Full-sequence LLM trunk over [ctx; query]: embed, causal attention
    stack, final norm. Returns (x (B,S,d), stacked kv cache or None)."""
    llm = pcfg.llm
    p = params["llm"]
    x_q = embed_rows(p["embed"], query_tokens).to(llm.adtype)
    x = torch.cat([ctx_tokens.to(llm.adtype), x_q], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    mask = causal_mask(S, device=x.device)[None]
    spec = stack.layer_groups(llm)[0]
    x, _, kv = stack.group_forward(p["groups"][0], llm, spec, x, positions,
                                   mask, want_cache=want_cache)
    return stack.apply_norm(x, p["norm"], llm), kv


def _llm_outputs(params: dict, x_last: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Answer logits + <SEG> embedding from the hidden state at one
    position (B, d_llm), or at every chunk position (B, C, d_llm)."""
    answer_logits = vocab_linear(x_last, params["llm"]["answer_head"])
    seg = linear(x_last, params["seg_proj"])
    return answer_logits, seg


def llm_reason(params: dict, pcfg: LISAPipelineConfig,
               ctx_tokens: torch.Tensor, query_tokens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LLM over [ctx; query] -> (answer_logits (B,V), seg (B, d_sam)) at
    the final (<SEG>) position."""
    x, _ = _llm_trunk(params, pcfg, ctx_tokens, query_tokens)
    return _llm_outputs(params, x[:, -1])


def llm_prefill(params: dict, pcfg: LISAPipelineConfig,
                ctx_tokens: torch.Tensor, query_tokens: torch.Tensor,
                width: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Full-sequence forward over [ctx; query] that also materialises the
    KV cache for ``llm_decode_step``: ring slots of ``width`` (>= S,
    default S) with per-slot absolute positions (-1 = empty). Returns
    (answer_logits (B,V), seg (B,d_sam), cache)."""
    x, kv = _llm_trunk(params, pcfg, ctx_tokens, query_tokens,
                       want_cache=True)
    B, S, _ = x.shape
    answer_logits, seg = _llm_outputs(params, x[:, -1])
    W = S if width is None else width
    if W < S:
        raise ValueError(f"cache width {W} < sequence length {S}")
    if W > S:
        padded = {}
        for name, a in kv.items():
            buf = a.new_zeros(a.shape[:2] + (W,) + a.shape[3:])
            buf[:, :, :S] = a
            padded[name] = buf
        kv = padded
    pos_arr = torch.full((B, W), -1, dtype=torch.int32, device=x.device)
    pos_arr[:, :S] = torch.arange(S, dtype=torch.int32, device=x.device)
    return answer_logits, seg, {"groups": [kv], "positions": pos_arr}


def llm_decode_step(params: dict, pcfg: LISAPipelineConfig, cache: Dict,
                    tokens: torch.Tensor, pos
                    ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """One autoregressive decode step against the KV cache. tokens (B,1)
    int; pos an int (whole batch at one absolute position) or a (B,)
    tensor of per-row positions. Returns (answer_logits (B,V),
    seg (B,d_sam), cache). The cache (k/v and slot positions) is updated
    IN PLACE; the reference returns a rebuilt copy. Decode attention runs
    the flash-decode kernel when ``pcfg.llm.use_flash_decode`` is set."""
    llm = pcfg.llm
    p = params["llm"]
    B = tokens.shape[0]
    x = embed_rows(p["embed"], tokens).to(llm.adtype)
    pos_arr = cache["positions"]
    W = pos_arr.shape[1]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        pos = pos.to(device=x.device, dtype=torch.int32)
        slot = pos % W
        pos_arr[torch.arange(B, device=x.device), slot] = pos
        mask = cache_mask(pos_arr, pos[:, None], llm.sliding_window)
        positions = pos[:, None]
    else:
        pos = int(pos)
        slot = pos % W
        pos_arr[:, slot] = pos
        mask = cache_mask(pos_arr, pos, llm.sliding_window)
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
    spec = stack.layer_groups(llm)[0]
    x, kv = stack.group_decode(p["groups"][0], llm, spec, x, positions,
                               cache["groups"][0], slot, mask)
    x = stack.apply_norm(x, p["norm"], llm)
    answer_logits, seg = _llm_outputs(params, x[:, -1])
    return answer_logits, seg, {"groups": [kv], "positions": pos_arr}


def llm_prefill_paged(params: dict, pcfg: LISAPipelineConfig,
                      ctx_tokens: torch.Tensor, query_tokens: torch.Tensor,
                      page_size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Prefill over [ctx; query] that emits the KV cache chunked into
    fixed-size pages, the serving path's shared-prefix unit. Returns
    (answer_logits (B,V), seg (B,d_sam), paged_kv) with paged_kv leaves
    (L, B, n_pages, page_size, K, hd); the zero-padded tail of the last
    page carries no position and is masked by the caller's bookkeeping
    (``paging.prefix_positions``)."""
    x, kv = _llm_trunk(params, pcfg, ctx_tokens, query_tokens,
                       want_cache=True)
    S = x.shape[1]
    answer_logits, seg = _llm_outputs(params, x[:, -1])
    n_pages = -(-S // page_size)
    paged = {}
    for name, a in kv.items():
        buf = a.new_zeros(a.shape[:2] + (n_pages * page_size,) + a.shape[3:])
        buf[:, :, :S] = a
        paged[name] = buf.reshape(a.shape[:2] + (n_pages, page_size)
                                  + a.shape[3:])
    return answer_logits, seg, {"groups": [paged]}


def llm_decode_step_paged(params: dict, pcfg: LISAPipelineConfig,
                          pool: Dict, page_table: torch.Tensor,
                          positions: torch.Tensor, tokens: torch.Tensor,
                          pos: torch.Tensor, write_slot: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """One in-flight decode step against the shared KV page pool.

    pool {"groups": [kv]} with leaves (L, P, page, K, hd); page_table
    (B, n_pages) int32, every entry a valid page id (idle rows park on
    the trash page); positions (B, n_pages*page) int32 absolute position
    in each virtual slot (-1 empty; the caller owns this bookkeeping);
    tokens (B,1) int; pos (B,) int32 positions of the new tokens;
    write_slot (B,) int32 virtual slot receiving each row's token.
    Returns (answer_logits (B,V), seg (B,d_sam), pool); the pool is
    updated IN PLACE. Decode attention runs the paged flash-decode kernel
    when ``pcfg.llm.use_flash_decode`` is set."""
    llm = pcfg.llm
    p = params["llm"]
    B = tokens.shape[0]
    page = pool["groups"][0]["k"].shape[2]
    x = embed_rows(p["embed"], tokens).to(llm.adtype)
    rows = torch.arange(B, device=x.device)
    pos_arr = positions.clone()
    pos_arr[rows, write_slot.long()] = pos
    mask = cache_mask(pos_arr, pos[:, None], llm.sliding_window)
    write_page = page_table[rows, (write_slot // page).long()].long()
    write_off = (write_slot % page).long()
    spec = stack.layer_groups(llm)[0]
    x, kv = stack.group_decode_paged(p["groups"][0], llm, spec, x,
                                     pos[:, None], pool["groups"][0],
                                     page_table, write_page, write_off, mask)
    x = stack.apply_norm(x, p["norm"], llm)
    answer_logits, seg = _llm_outputs(params, x[:, -1])
    return answer_logits, seg, {"groups": [kv]}


def llm_verify_step_paged(params: dict, pcfg: LISAPipelineConfig,
                          pool: Dict, page_table: torch.Tensor,
                          positions: torch.Tensor, tokens: torch.Tensor,
                          pos: torch.Tensor, write_slot: torch.Tensor,
                          chunk_len: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """One speculative verify step: a chunk of C tokens per row (the row's
    last accepted token, then drafted continuations) scored through the
    serving model in one paged multi-token pass.

    pool/page_table/positions as in ``llm_decode_step_paged`` (positions
    is not written: the caller owns it); tokens (B, C) int occupying
    virtual slots ``write_slot .. write_slot+C-1`` at positions
    ``pos .. pos+C-1`` (both (B,) starts); chunk_len (B,) the number of
    real leading entries. Pad entries write their k/v to the trash page,
    record no position, and give logits the caller ignores. Chunk token i
    attends [cache; chunk tokens <= i]. Returns (answer_logits (B, C, V),
    seg (B, C, d_sam), pool); the pool is updated IN PLACE. Attention runs
    the paged verify kernel when ``pcfg.llm.use_flash_decode`` is set."""
    llm = pcfg.llm
    p = params["llm"]
    B, C = tokens.shape
    page = pool["groups"][0]["k"].shape[2]
    n_slots = positions.shape[1]
    x = embed_rows(p["embed"], tokens).to(llm.adtype)
    dev = x.device
    offs = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    valid = offs < chunk_len.to(dev, torch.int32)[:, None]
    pos_c = pos.to(dev, torch.int32)[:, None] + offs             # (B, C)
    ws = write_slot.to(dev, torch.int32)[:, None] + offs         # (B, C)
    rows = torch.arange(B, device=dev)[:, None].expand(B, C)
    # only the real entries inside the row record a position (the
    # reference scatters the rest out of bounds, where JAX drops them):
    # they go to a spare column past the row, sliced off after. A scatter,
    # not a boolean-mask selection, whose count would cost a host sync
    keep = valid & (ws < n_slots)
    pos_arr = torch.cat([positions, positions.new_full((B, 1), -1)], dim=1)
    pos_arr.scatter_(1, torch.where(keep, ws, n_slots).long(),
                     pos_c.to(positions.dtype))
    pos_arr = pos_arr[:, :n_slots]
    mask = cache_mask(pos_arr[:, None, :], pos_c[:, :, None],
                      llm.sliding_window)                        # (B, C, W)
    ws_in = ws.clamp(max=n_slots - 1).long()
    write_page = torch.where(valid, page_table[rows, ws_in // page].long(),
                             TRASH_PAGE)
    write_off = ws_in % page
    spec = stack.layer_groups(llm)[0]
    x, kv = stack.group_verify_paged(p["groups"][0], llm, spec, x, pos_c,
                                     pool["groups"][0], page_table,
                                     write_page, write_off, mask)
    x = stack.apply_norm(x, p["norm"], llm)
    answer_logits, seg = _llm_outputs(params, x)
    return answer_logits, seg, {"groups": [kv]}


def llm_generate(params: dict, pcfg: LISAPipelineConfig,
                 ctx_tokens: torch.Tensor, query_tokens: torch.Tensor,
                 max_new_tokens: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy answer generation: one prefill over [ctx; query], then
    decode steps (the first answer token comes from the prefill logits).
    Returns (tokens (B, T) int32, first_answer_logits (B, V),
    seg (B, d_sam)); seg is read at the final generated token, through one
    more decode step whose logits are discarded."""
    S = ctx_tokens.shape[1] + query_tokens.shape[1]
    T = max_new_tokens
    logits0, _, cache = llm_prefill(params, pcfg, ctx_tokens, query_tokens,
                                    width=S + T)
    last = torch.argmax(logits0, dim=-1).to(torch.int32)
    toks = [last]
    for pos in range(S, S + T - 1):
        logits, _, cache = llm_decode_step(params, pcfg, cache,
                                           last[:, None], pos)
        last = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(last)
    _, seg, _ = llm_decode_step(params, pcfg, cache, last[:, None],
                                S + T - 1)
    return torch.stack(toks, dim=1), logits0, seg


def mask_decode(params: dict, pcfg: LISAPipelineConfig,
                sam_feats: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """<SEG>-conditioned mask decoder: (B, T, d_sam) x (B, d_sam) ->
    per-pixel logits (B, H, W)."""
    mh = params["mask_head"]
    fused = sam_feats * seg[:, None, :].to(sam_feats.dtype)
    h = gelu(linear(fused, mh["w1"], mh["b1"]))
    pix = linear(h, mh["w2"])                         # (B, T, pp)
    B, T, pp = pix.shape
    g = pcfg.image_size // pcfg.patch_size
    if pp == 1:
        return pix.reshape(B, g, g)
    s = int(round(pp ** 0.5))
    pix = pix.reshape(B, g, g, s, s).permute(0, 1, 3, 2, 4)
    return pix.reshape(B, g * s, g * s)


# ---------------------------------------------------------------------------
# end-to-end pipelines
# ---------------------------------------------------------------------------


def insight_forward(params: dict, pcfg: LISAPipelineConfig,
                    images: torch.Tensor, query_tokens: torch.Tensor,
                    bn_params: Optional[dict] = None,
                    split_k: Optional[int] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full Insight pipeline; with ``bn_params`` the boundary activation is
    compressed with the straight-through bottleneck (the training and
    evaluation path). Returns (mask_logits (B,H,W), answer_logits (B,V))."""
    a = sam_head(params, pcfg, images, split_k)
    if bn_params is not None:
        a = bn.roundtrip_st(bn_params, a)
    feats = sam_tail(params, pcfg, a, split_k)
    ctx = clip_encode(params, pcfg, images)
    answer_logits, seg = llm_reason(params, pcfg, ctx, query_tokens)
    return mask_decode(params, pcfg, feats, seg), answer_logits


def context_forward(params: dict, pcfg: LISAPipelineConfig,
                    images: torch.Tensor, query_tokens: torch.Tensor
                    ) -> torch.Tensor:
    """Context pipeline: CLIP-only features -> LLM -> answer logits."""
    ctx = clip_encode(params, pcfg, images)
    answer_logits, _ = llm_reason(params, pcfg, ctx, query_tokens)
    return answer_logits


# ---------------------------------------------------------------------------
# losses / metrics
# ---------------------------------------------------------------------------


def insight_loss(params: dict, pcfg: LISAPipelineConfig,
                 batch: Dict[str, torch.Tensor],
                 bn_params: Optional[dict] = None,
                 pos_weight: float = 25.0
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Positive-weighted BCE + dice on the mask + half the answer CE.

    The weight ``1 + (pos_weight - 1) * m`` scales the whole per-pixel
    term, as the reference's does (targets cover about 2 % of pixels);
    ``F.binary_cross_entropy_with_logits(pos_weight=)`` would weight only
    the positive part, a different loss."""
    mask_logits, answer_logits = insight_forward(
        params, pcfg, batch["images"], batch["query"], bn_params)
    m = batch["mask"].float()
    ml = mask_logits.float()
    w = 1.0 + (pos_weight - 1.0) * m
    bce = torch.mean(w * (torch.maximum(ml, torch.zeros_like(ml)) - ml * m
                          + torch.log1p(torch.exp(-torch.abs(ml)))))
    p = torch.sigmoid(ml)
    inter = torch.sum(p * m, dim=(1, 2))
    dice = 1 - torch.mean((2 * inter + 1) / (torch.sum(p, dim=(1, 2))
                                             + torch.sum(m, dim=(1, 2)) + 1))
    ans = _answer_ce(answer_logits, batch["answer"])
    loss = bce + dice + 0.5 * ans
    return loss, {"bce": bce, "dice": dice, "answer_ce": ans}


def context_loss(params: dict, pcfg: LISAPipelineConfig,
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = context_forward(params, pcfg, batch["images"], batch["query"])
    ce = _answer_ce(logits, batch["answer"])
    return ce, {"answer_ce": ce}


def _answer_ce(logits: torch.Tensor, answer: torch.Tensor) -> torch.Tensor:
    """Mean float32 cross-entropy of the gold answer token."""
    return _xent(logits, answer)


def iou_metrics(mask_logits: torch.Tensor, gt: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """gIoU (mean per-image IoU), cIoU (cumulative), and their mean —
    the paper's 'Average IoU' (Table 3 note)."""
    pred = (mask_logits > 0).to(torch.float32)
    gt = gt.to(torch.float32)
    inter = torch.sum(pred * gt, dim=(1, 2))
    union = torch.sum(torch.maximum(pred, gt), dim=(1, 2))
    giou = torch.mean(inter / (union + 1e-6))
    ciou = torch.sum(inter) / (torch.sum(union) + 1e-6)
    return {"giou": giou, "ciou": ciou, "avg_iou": 0.5 * (giou + ciou)}
