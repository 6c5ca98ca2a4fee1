"""GQA attention: full-sequence (encoders, prefill), single-token decode
against a ring KV cache or a shared KV page pool, and multi-token
(speculative verify) decode against the page pool (port of
``repro/models/attention.py``).

Cache layout per layer: {"k": (B, W, K, hd), "v": (B, W, K, hd)}, or, for
the page pool, {"k": (P, page, K, hd), "v": ...}; k stored post-RoPE. Slot
positions live at the model level and arrive here as an additive mask.
With ``use_flash`` a causal full-sequence pass without a sliding window
runs the flash-attention CUDA kernel (``kernels/flash_attention``), as the
reference routes it to its Pallas kernel. MLA, query chunking
(``attn_chunk``), the scores stub and ``shard_cache_hd`` are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.common import apply_rope, fan_in_init, linear
from repro_torch.models.config import ModelConfig

_ROADMAP = "not ported yet; see ROADMAP.md"


def init_gqa(generator: torch.Generator, cfg: ModelConfig,
             layers: Optional[int], device=None) -> dict:
    """Stacked GQA weights with a leading layer axis; ``layers=None`` for
    one unstacked layer."""
    d, H, K, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    dt = cfg.pdtype
    p = {
        "wq": fan_in_init(generator, (d, H * hd), dt, device, layers),
        "wk": fan_in_init(generator, (d, K * hd), dt, device, layers),
        "wv": fan_in_init(generator, (d, K * hd), dt, device, layers),
        "wo": fan_in_init(generator, (H * hd, d), dt, device, layers),
    }
    if cfg.qkv_bias:
        for n, w in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            shape = (w,) if layers is None else (layers, w)
            p[n] = torch.zeros(shape, dtype=dt, device=device)
    return p


def _rope_q_or_k(cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope_style == "none":
        return x
    if cfg.rope_style == "mrope":
        raise NotImplementedError(f"M-RoPE is {_ROADMAP}")
    return apply_rope(x, positions, cfg.rope_theta)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,S,H,hd) k/v (B,T,K,hd) grouped attention, fp32 softmax, the
    output in q's dtype (``sdpa_f32``)."""
    return sdpa_f32(q, k, v, mask, scale).to(q.dtype)


def sdpa_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: torch.Tensor, scale: float) -> torch.Tensor:
    """``_sdpa`` before its output is rounded to q's dtype: float32.

    mask: additive, broadcastable to (B, 1, S, T). The reference multiplies
    native-dtype operands with float32 accumulation and a float32 result.
    On CUDA, bf16 and fp16 operands do the same: the two batched products
    ``scores_f32`` and ``pv_f32``, on the tensor cores. Elsewhere, and for
    float32 operands, the operands are upcast and multiplied in float32
    (TF32 stays off); products of bf16 values are exact in float32, so
    this computes the same thing. The CPU has no kernel for
    ``aten::bmm.dtype``. Probabilities are cast to v's dtype before P.V,
    as in the reference.
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    mask = mask.reshape(mask.shape[0], 1, 1, *mask.shape[1:])
    if q.is_cuda and q.dtype in (torch.bfloat16, torch.float16):
        scores = scores_f32(q, k).reshape(B, K, G, S, T) * scale + mask
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = pv_f32(probs.reshape(B * K, G * S, T), v)
        out = out.reshape(B, K, G, S, hd).permute(0, 3, 1, 2, 4)
        return out.reshape(B, S, H, hd)
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    probs = torch.softmax(scores + mask, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, S, H, hd)


def scores_f32(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q.k of each kv head's query group on the native operands with a
    float32 result (``aten::bmm.dtype``; CUDA only): q (B,S,H,hd), k
    (B,T,K,hd) -> (B*K, G*S, T), rows ordered (group head, query)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1).reshape(B * K, hd, T)
    return torch.bmm(qg.reshape(B * K, -1, hd), kt, out_dtype=torch.float32)


def pv_f32(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """P.V on the native operands with a float32 result
    (``aten::bmm.dtype``; CUDA only): probs (B*K, G*S, T) in v's dtype, v
    (B,T,K,hd) -> (B*K, G*S, hd)."""
    B, T, K, hd = v.shape
    vg = v.permute(0, 2, 1, 3).reshape(B * K, T, hd)
    return torch.bmm(probs, vg, out_dtype=torch.float32)


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = linear(x, p["wq"], p.get("bq")).reshape(B, S, H, hd)
    k = linear(x, p["wk"], p.get("bk")).reshape(B, S, K, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(B, S, K, hd)
    return q, k, v


def _check_decode_supported(cfg: ModelConfig) -> None:
    """The decode paths read ``shard_cache_hd`` alone of the unported
    switches; like the reference's, they ignore ``use_flash``,
    ``attn_chunk`` and ``attn_scores_stub``, which only the full-sequence
    pass reads."""
    if cfg.shard_cache_hd:
        raise NotImplementedError(f"shard_cache_hd is {_ROADMAP}")


def gqa_full(p: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor,
             mask: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Full-sequence GQA. Returns (out, cache_contents).

    The branches follow the reference's order: the scores stub, then the
    flash kernel (``use_flash``, causal, no sliding window; it builds the
    causal mask itself and ignores ``mask``, as the reference's does),
    then query chunking, then ``_sdpa``."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(p, cfg, x)
    q = _rope_q_or_k(cfg, q, positions)
    k = _rope_q_or_k(cfg, k, positions)
    if cfg.attn_scores_stub:
        raise NotImplementedError(f"attn_scores_stub is {_ROADMAP}")
    elif cfg.use_flash and cfg.causal and cfg.sliding_window is None:
        from repro_torch.kernels.flash_attention import ops as flash_ops
        out = flash_ops.flash_attention(q, k, v, causal=True)
    elif cfg.attn_chunk and S > cfg.attn_chunk and S % cfg.attn_chunk == 0:
        raise NotImplementedError(f"attn_chunk is {_ROADMAP}")
    else:
        out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(hd))
    out = linear(out.reshape(B, S, H * hd), p["wo"])
    return out, {"k": k, "v": v}


def gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, cache: dict, slot,
               mask: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Single-token decode. x (B,1,d); cache k/v (B,W,K,hd); slot an int
    (shared ring slot) or a (B,) tensor (per-row slots); mask (B,W)
    additive over cache slots (already admitting the new token's slot).

    The cache is updated IN PLACE (the reference rebuilds it with
    ``dynamic_update_slice``/``.at[].set``); the returned dict holds the
    same tensors."""
    _check_decode_supported(cfg)
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(p, cfg, x)
    q = _rope_q_or_k(cfg, q, positions)
    k = _rope_q_or_k(cfg, k, positions)
    k_cache, v_cache = cache["k"], cache["v"]
    if isinstance(slot, torch.Tensor) and slot.dim() == 1:
        rows = torch.arange(B, device=x.device)
        k_cache[rows, slot] = k[:, 0]
        v_cache[rows, slot] = v[:, 0]
    else:
        k_cache[:, int(slot)] = k[:, 0]
        v_cache[:, int(slot)] = v[:, 0]
    if cfg.use_flash_decode and S == 1:
        from repro_torch.kernels.decode_attention import ops as decode_ops
        out = decode_ops.decode_attention(q[:, 0], k_cache, v_cache,
                                          mask)[:, None]
    else:
        out = _sdpa(q, k_cache, v_cache, mask[:, None, :],
                    1.0 / math.sqrt(hd))
    out = linear(out.reshape(B, S, H * hd), p["wo"])
    return out, {"k": k_cache, "v": v_cache}


def last_writes(write_page: torch.Tensor, write_off: torch.Tensor,
                page_size: int, n_pages: int) -> torch.Tensor:
    """For each entry of a pool write, flattened in row-major order, the
    position of the last entry that targets the same (page, offset) slot:
    the entry that a write in that order leaves there, as the reference's
    ``.at[].set`` does. Pad entries and idle rows all target the trash
    page, several to one slot, and an idle row attends that page."""
    slot = (write_page.reshape(-1).long() * page_size
            + write_off.reshape(-1).long())
    pos = torch.arange(slot.numel(), device=slot.device)
    last = torch.full((n_pages * page_size,), -1, dtype=torch.long,
                      device=slot.device)
    last.scatter_reduce_(0, slot, pos, "amax", include_self=False)
    return last[slot]


def _put(pool_t: torch.Tensor, page: torch.Tensor, off: torch.Tensor,
         rows: torch.Tensor) -> None:
    pool_t.index_put_((page, off), rows)


def write_pool(pool: dict, write_page: torch.Tensor, write_off: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor, src: torch.Tensor) -> None:
    """Write each entry's k/v row (k, v: (*write_page.shape, K, hd)) into
    its (page, offset) slot of the pool, in place, the last entry for each
    slot winning. Every entry carries its slot's winning row (``src``, as
    ``last_writes`` gives it), so entries that share a slot write the same
    values: a card that resolves duplicate indices in any order leaves one
    result. (Selecting the winners by a mask instead would synchronise the
    host with the card at every layer.)"""
    page, off = write_page.reshape(-1), write_off.reshape(-1)
    for name, x in (("k", k), ("v", v)):
        _put(pool[name], page, off,
             x.reshape(-1, *x.shape[-2:]).index_select(0, src))


def gqa_decode_paged(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor, pool: dict,
                     page_table: torch.Tensor, write_page: torch.Tensor,
                     write_off: torch.Tensor, mask: torch.Tensor,
                     write_src: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Single-token decode against a shared KV page pool.

    x (B,1,d); pool k/v (P, page, K, hd), pages shared by every live row;
    page_table (B, n_pages) int32, every entry a valid page id (idle rows
    point at the reserved trash page); write_page/write_off (B,) the page
    slot receiving each row's new k/v; mask (B, n_pages*page) additive
    over the row's virtual sequence; write_src (B,) the entry whose row
    each entry writes, its slot's last (``last_writes``). Returns (out,
    pool).

    The pool is updated IN PLACE (``write_pool``; the reference rebuilds it
    with ``.at[].set``); the returned dict holds the same tensors. Idle
    rows may all write the same trash-page slot; the last of them keeps
    it, as in the reference."""
    _check_decode_supported(cfg)
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(p, cfg, x)
    q = _rope_q_or_k(cfg, q, positions)
    k = _rope_q_or_k(cfg, k, positions)
    write_pool(pool, write_page, write_off, k[:, 0], v[:, 0], write_src)
    k_pool, v_pool = pool["k"], pool["v"]
    if cfg.use_flash_decode and S == 1:
        from repro_torch.kernels.decode_attention import ops as decode_ops
        out = decode_ops.paged_decode_attention(q[:, 0], k_pool, v_pool,
                                                page_table, mask)[:, None]
    else:
        n, page = page_table.shape[1], k_pool.shape[1]
        idx = page_table.long()
        kg = k_pool[idx].reshape(B, n * page, *k_pool.shape[2:])
        vg = v_pool[idx].reshape(B, n * page, *v_pool.shape[2:])
        out = _sdpa(q, kg, vg, mask[:, None, :], 1.0 / math.sqrt(hd))
    out = linear(out.reshape(B, S, H * hd), p["wo"])
    return out, {"k": k_pool, "v": v_pool}


def gqa_verify_paged(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor, pool: dict,
                     page_table: torch.Tensor, write_page: torch.Tensor,
                     write_off: torch.Tensor, mask: torch.Tensor,
                     write_src: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Multi-token decode against the shared KV page pool, the speculative
    verify step.

    x (B, C, d), each row's chunk of C tokens (last accepted token and
    drafted continuations, ascending positions); positions (B, C);
    write_page/write_off (B, C) the page slot receiving each chunk token's
    k/v (pad tokens target the trash page, several to one slot; the last
    in row-major order keeps it, ``write_pool``); mask (B, C,
    n_pages*page) additive per query, carrying slot validity and
    causal-within-chunk; write_src (B*C,) as in ``gqa_decode_paged``. The
    chunk's k/v are written IN PLACE before attention, so chunk token i
    attends chunk tokens <= i through the pool as C successive decode
    steps would. Returns (out, pool)."""
    _check_decode_supported(cfg)
    B, C, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(p, cfg, x)
    q = _rope_q_or_k(cfg, q, positions)
    k = _rope_q_or_k(cfg, k, positions)
    write_pool(pool, write_page, write_off, k, v, write_src)
    k_pool, v_pool = pool["k"], pool["v"]
    if cfg.use_flash_decode:
        from repro_torch.kernels.decode_attention import ops as decode_ops
        out = decode_ops.paged_verify_attention(q, k_pool, v_pool,
                                                page_table, mask)
    else:
        n, page = page_table.shape[1], k_pool.shape[1]
        idx = page_table.long()
        kg = k_pool[idx].reshape(B, n * page, *k_pool.shape[2:])
        vg = v_pool[idx].reshape(B, n * page, *v_pool.shape[2:])
        out = _sdpa(q, kg, vg, mask, 1.0 / math.sqrt(hd))
    out = linear(out.reshape(B, C, H * hd), p["wo"])
    return out, {"k": k_pool, "v": v_pool}


def gqa_empty_cache(cfg: ModelConfig, batch: int, width: int,
                    device=None) -> dict:
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, width, K, hd)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=device)}


def empty_cache(cfg: ModelConfig, batch: int, width: int,
                device=None) -> dict:
    if cfg.attn_type == "mla":
        raise NotImplementedError(f"MLA attention is {_ROADMAP}")
    return gqa_empty_cache(cfg, batch, width, device)


def attn_full(p, cfg: ModelConfig, x, positions, mask):
    if cfg.attn_type == "mla":
        raise NotImplementedError(f"MLA attention is {_ROADMAP}")
    return gqa_full(p, cfg, x, positions, mask)


def attn_decode(p, cfg: ModelConfig, x, positions, cache, slot, mask):
    if cfg.attn_type == "mla":
        raise NotImplementedError(f"MLA attention is {_ROADMAP}")
    return gqa_decode(p, cfg, x, positions, cache, slot, mask)


def attn_decode_paged(p, cfg: ModelConfig, x, positions, pool, page_table,
                      write_page, write_off, mask, write_src):
    if cfg.attn_type == "mla":
        raise NotImplementedError(f"MLA attention is {_ROADMAP}")
    return gqa_decode_paged(p, cfg, x, positions, pool, page_table,
                            write_page, write_off, mask, write_src)


def attn_verify_paged(p, cfg: ModelConfig, x, positions, pool, page_table,
                      write_page, write_off, mask, write_src):
    if cfg.attn_type == "mla":
        raise NotImplementedError(f"MLA attention is {_ROADMAP}")
    return gqa_verify_paged(p, cfg, x, positions, pool, page_table,
                            write_page, write_off, mask, write_src)
