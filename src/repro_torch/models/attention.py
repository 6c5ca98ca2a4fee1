"""Attention variants: GQA (optionally biased / sliding-window) and MLA
(port of ``repro/models/attention.py``).

GQA runs full-sequence (encoders, prefill), single-token decode against a
ring KV cache or a shared KV page pool, and multi-token (speculative
verify) decode against the page pool; MLA runs full-sequence and absorbed
single-token decode against its latent ring cache.

Cache layout per layer: GQA {"k": (B, W, K, hd), "v": (B, W, K, hd)}, or,
for the page pool, {"k": (P, page, K, hd), "v": ...}, k stored post-RoPE;
MLA {"ckv": (B, W, r_kv), "krope": (B, W, d_r)}. Slot positions live at
the model level and arrive here as an additive mask. With ``use_flash`` a
causal full-sequence GQA pass without a sliding window runs the
flash-attention CUDA kernel (``kernels/flash_attention``), and with
``use_flash_decode`` a single-token GQA decode runs the decode-attention
kernel, as the reference routes them to its Pallas kernels.
``shard_cache_hd`` is a placement hint for a head-dim-sharded cache: it
keeps contiguous decode off the kernel, as in the reference, and places
the fresh q/k/v on the cache's head-dim cut (``common.wsc``, the identity
that a dry-run reckoning reads); the paged paths refuse it, as the
reference's do. Under tensor-parallel serving (``sharding.serving``) a
GQA block runs this rank's heads, and the output projection of GQA or MLA
sums over the ranks (``common.row_linear``); a full-sequence block takes
its input through ``common.block_input`` (training's conjugate sum).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.common import (apply_mrope, apply_rope,
                                       block_input, fan_in_init, full_fp32,
                                       linear, rms_norm, row_linear, wsc)
from repro_torch.models.config import ModelConfig


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


def init_mla(generator: torch.Generator, cfg: ModelConfig,
             layers: Optional[int], device=None) -> dict:
    """Stacked MLA weights with a leading layer axis; ``layers=None`` for
    one unstacked layer."""
    m = cfg.mla
    d, H, dt = cfg.d_model, cfg.num_heads, cfg.pdtype
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    lead = () if layers is None else (layers,)

    def ones(n):
        return torch.ones((*lead, n), dtype=dt, device=device)

    return {
        "wq_a": fan_in_init(generator, (d, m.q_lora_rank), dt, device,
                            layers),
        "q_norm": ones(m.q_lora_rank),
        "wq_b": fan_in_init(generator, (m.q_lora_rank, H * qk), dt, device,
                            layers),
        "wkv_a": fan_in_init(generator,
                             (d, m.kv_lora_rank + m.qk_rope_head_dim), dt,
                             device, layers),
        "kv_norm": ones(m.kv_lora_rank),
        "wkv_b": fan_in_init(generator,
                             (m.kv_lora_rank,
                              H * (m.qk_nope_head_dim + m.v_head_dim)), dt,
                             device, layers),
        "wo": fan_in_init(generator, (H * m.v_head_dim, d), dt, device,
                          layers),
    }


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   layers: Optional[int], device=None) -> dict:
    init = init_mla if cfg.attn_type == "mla" else init_gqa
    return init(generator, cfg, layers, device)


def _rope_q_or_k(cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope_style == "none":
        return x
    if cfg.rope_style == "mrope":
        return apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
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
    as in the reference. Under autograd the tensor-core route's two
    products take ``_MatmulF32``'s backward (``aten::bmm.dtype`` has no
    derivative), which computes what autograd of the upcast route does.
    """
    if q.is_cuda and q.dtype in (torch.bfloat16, torch.float16):
        return sdpa_tc(q, k, v, mask, scale)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    mask = mask.reshape(mask.shape[0], 1, 1, *mask.shape[1:])
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    probs = torch.softmax(scores + mask, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, S, H, hd)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor, scale: float,
                  chunk: int) -> torch.Tensor:
    """Query-chunked attention: ``_sdpa`` over blocks of ``chunk`` queries
    (the reference's ``lax.scan``), so only a (chunk, T) score tile is live
    at once. mask (Bm, S, T)."""
    S = q.shape[1]
    return torch.cat([_sdpa(q[:, i:i + chunk], k, v, mask[:, i:i + chunk],
                            scale) for i in range(0, S, chunk)], dim=1)


def sdpa_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor, scale: float) -> torch.Tensor:
    """``sdpa_f32``'s tensor-core route: the two batched products on the
    native operands with float32 results (``scores_f32``, ``pv_f32``).
    CUDA's route for bf16 / fp16 operands; elsewhere (only a test's call)
    the products' forward is the float32 upcast's."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    mask = mask.reshape(mask.shape[0], 1, 1, *mask.shape[1:])
    scores = scores_f32(q, k).reshape(B, K, G, S, T) * scale + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = pv_f32(probs.reshape(B * K, G * S, T), v)
    out = out.reshape(B, K, G, S, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, H, hd)


class _MatmulF32(torch.autograd.Function):
    """a @ b (batched) with a float32 result and a backward: JAX's
    transpose of a ``preferred_element_type=float32`` product. Each
    operand's cotangent is the float32 cotangent times the other operand
    upcast to float32 (full float32 products, no TF32), cast to the
    operand's dtype: what autograd of ``a.float() @ b.float()`` computes.
    The forward picks its route by device (``aten::bmm.dtype`` on CUDA,
    the upcast elsewhere); the backward is one device-independent
    function."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        with full_fp32(a):
            return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        with full_fp32(g):
            if ctx.needs_input_grad[0]:
                da = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
            if ctx.needs_input_grad[1]:
                db = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return da, db


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``aten::bmm.dtype`` with a float32 result (CUDA only); through
    ``_MatmulF32`` when autograd records (grad mode on and an operand
    requires grad), which also runs on the CPU."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MatmulF32.apply(a, b)
    return torch.bmm(a, b, out_dtype=torch.float32)


def scores_f32(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q.k of each kv head's query group on the native operands with a
    float32 result (``_bmm_f32``): q (B,S,H,hd), k (B,T,K,hd) ->
    (B*K, G*S, T), rows ordered (group head, query)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1).reshape(B * K, hd, T)
    return _bmm_f32(qg.reshape(B * K, -1, hd), kt)


def pv_f32(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """P.V on the native operands with a float32 result (``_bmm_f32``):
    probs (B*K, G*S, T) in v's dtype, v (B,T,K,hd) -> (B*K, G*S, hd)."""
    B, T, K, hd = v.shape
    vg = v.permute(0, 2, 1, 3).reshape(B * K, T, hd)
    return _bmm_f32(probs, vg)


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = linear(x, p["wq"], p.get("bq")).reshape(B, S, H, hd)
    k = linear(x, p["wk"], p.get("bk")).reshape(B, S, K, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(B, S, K, hd)
    return q, k, v


def _refuse_sharded_pool(cfg: ModelConfig, what: str) -> None:
    """The paged paths refuse the head-dim-sharded cache, as the
    reference's do. Like the reference's decode paths they ignore
    ``use_flash``, ``attn_chunk`` and ``attn_scores_stub``, which only the
    full-sequence pass reads."""
    if cfg.shard_cache_hd:
        raise NotImplementedError(
            f"{what} does not support the head_dim-sharded cache")


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
    scale = 1.0 / math.sqrt(hd)
    if cfg.attn_scores_stub:
        # perf-analysis stub: keep the q/k/v projections alive, skip the
        # score/softmax/PV stage
        out = q + 1e-6 * (torch.mean(k) + torch.mean(v))
    elif cfg.use_flash and cfg.causal and cfg.sliding_window is None:
        from repro_torch.kernels.flash_attention import ops as flash_ops
        out = flash_ops.flash_attention(q, k, v, causal=True)
    elif cfg.attn_chunk and S > cfg.attn_chunk and S % cfg.attn_chunk == 0:
        out = _sdpa_chunked(q, k, v, mask, scale, cfg.attn_chunk)
    else:
        out = _sdpa(q, k, v, mask, scale)
    out = row_linear(out.reshape(B, S, H * hd), p["wo"], "attn")
    return out, {"k": k, "v": v}


def gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, cache: dict, slot,
               mask: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Single-token decode. x (B,1,d); cache k/v (B,W,K,hd); slot an int
    (shared ring slot) or a (B,) tensor (per-row slots); mask (B,W)
    additive over cache slots (already admitting the new token's slot).

    The cache is updated IN PLACE (the reference rebuilds it with
    ``dynamic_update_slice``/``.at[].set``); the returned dict holds the
    same tensors. Under ``shard_cache_hd`` the kernel is skipped, as in the
    reference (whose sharding hints are no-ops on one device)."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(p, cfg, x)
    q = _rope_q_or_k(cfg, q, positions)
    k = _rope_q_or_k(cfg, k, positions)
    if cfg.shard_cache_hd:
        # the reference aligns the fresh q/k/v with the head-dim-sharded
        # cache at the source
        q = wsc(q, "BATCH", None, None, "model")
        k = wsc(k, "BATCH", None, None, "model")
        v = wsc(v, "BATCH", None, None, "model")
    k_cache, v_cache = cache["k"], cache["v"]
    if isinstance(slot, torch.Tensor) and slot.dim() == 1:
        rows = torch.arange(B, device=x.device)
        k_cache[rows, slot] = k[:, 0]
        v_cache[rows, slot] = v[:, 0]
    else:
        k_cache[:, int(slot)] = k[:, 0]
        v_cache[:, int(slot)] = v[:, 0]
    if cfg.use_flash_decode and S == 1 and not cfg.shard_cache_hd:
        from repro_torch.kernels.decode_attention import ops as decode_ops
        out = decode_ops.decode_attention(q[:, 0], k_cache, v_cache,
                                          mask)[:, None]
    else:
        out = _sdpa(q, k_cache, v_cache, mask[:, None, :],
                    1.0 / math.sqrt(hd))
    out = row_linear(out.reshape(B, S, H * hd), p["wo"], "attn")
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
    _refuse_sharded_pool(cfg, "paged decode")
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
    out = row_linear(out.reshape(B, S, H * hd), p["wo"], "attn")
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
    _refuse_sharded_pool(cfg, "paged verify")
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
    out = row_linear(out.reshape(B, C, H * hd), p["wo"], "attn")
    return out, {"k": k_pool, "v": v_pool}


def gqa_empty_cache(cfg: ModelConfig, batch: int, width: int,
                    device=None) -> dict:
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, width, K, hd)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 / MiniCPM3)
# ---------------------------------------------------------------------------


def _mla_qkv_full(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor):
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    qk_n, qk_r = m.qk_nope_head_dim, m.qk_rope_head_dim
    q = linear(rms_norm(linear(x, p["wq_a"]), p["q_norm"], cfg.norm_eps),
               p["wq_b"]).reshape(B, S, H, qk_n + qk_r)
    q_nope = q[..., :qk_n]
    q_rope = apply_rope(q[..., qk_n:], positions, cfg.rope_theta)
    kv_a = linear(x, p["wkv_a"])
    ckv = rms_norm(kv_a[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = kv_a[..., m.kv_lora_rank:].reshape(B, S, 1, qk_r)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def mla_full(p: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor,
             mask: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Full-sequence MLA: keys and values expanded from the latent, the
    attention on float32 copies (as the reference's), query-chunked under
    ``attn_chunk``. Returns (out, {"ckv", "krope"})."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    qk_n, qk_r, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q_nope, q_rope, ckv, k_rope = _mla_qkv_full(p, cfg, x, positions)
    kv = linear(ckv, p["wkv_b"]).reshape(B, S, H, qk_n + dv)
    k_nope, v = kv[..., :qk_n].float(), kv[..., qk_n:].float()
    kr = k_rope.float()
    scale = 1.0 / math.sqrt(float(qk_n + qk_r))

    def attend(qn, qr, mb):
        with full_fp32(qn):
            scores = (torch.einsum("bshn,bthn->bhst", qn.float(), k_nope)
                      + torch.einsum("bshr,btr->bhst", qr.float(), kr)
                      ) * scale
            scores = scores + mb.reshape(mb.shape[0], 1, *mb.shape[1:])
            probs = torch.softmax(scores, dim=-1)
            return torch.einsum("bhst,bthv->bshv", probs, v).to(x.dtype)

    c = cfg.attn_chunk
    if c and S > c and S % c == 0:
        out = torch.cat([attend(q_nope[:, i:i + c], q_rope[:, i:i + c],
                                mask[:, i:i + c]) for i in range(0, S, c)],
                        dim=1)
    else:
        out = attend(q_nope, q_rope, mask)
    out = row_linear(out.reshape(B, S, H * dv), p["wo"], "attn")
    return out, {"ckv": ckv, "krope": k_rope}


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, cache: dict, slot,
               mask: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Absorbed-matmul MLA decode: scores in the latent space, so the cache
    stays (r_kv + d_r) a token. ``wkv_b`` (r, H*(qk_n + dv)) is read as
    (r, H, qk_n + dv), the layout ``mla_full`` expands with. slot an int
    (the shared ring slot); the cache is updated IN PLACE and returned."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    qk_n, qk_r, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv_full(p, cfg, x, positions)
    slot = int(slot)
    cache["ckv"][:, slot:slot + S] = ckv_new
    cache["krope"][:, slot:slot + S] = krope_new
    ckv, krope = cache["ckv"].float(), cache["krope"].float()
    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, H, qk_n + dv).float()
    w_uk, w_uv = wkv_b[..., :qk_n], wkv_b[..., qk_n:]
    scale = 1.0 / math.sqrt(float(qk_n + qk_r))
    with full_fp32(x):
        # absorb the k up-projection into the query
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_uk)
        scores = (torch.einsum("bshr,bwr->bhsw", q_lat, ckv)
                  + torch.einsum("bshr,bwr->bhsw", q_rope.float(), krope)
                  ) * scale
        probs = torch.softmax(scores + mask[:, None, None, :], dim=-1)
        o_lat = torch.einsum("bhsw,bwr->bshr", probs, ckv)
        out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv).to(x.dtype)
    out = row_linear(out.reshape(B, S, H * dv), p["wo"], "attn")
    return out, cache


def mla_empty_cache(cfg: ModelConfig, batch: int, width: int,
                    device=None) -> dict:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, width, m.kv_lora_rank),
                               dtype=cfg.adtype, device=device),
            "krope": torch.zeros((batch, width, m.qk_rope_head_dim),
                                 dtype=cfg.adtype, device=device)}


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def empty_cache(cfg: ModelConfig, batch: int, width: int,
                device=None) -> dict:
    if cfg.attn_type == "mla":
        return mla_empty_cache(cfg, batch, width, device)
    return gqa_empty_cache(cfg, batch, width, device)


def attn_full(p, cfg: ModelConfig, x, positions, mask):
    x = block_input(x, "attn")
    if cfg.attn_type == "mla":
        return mla_full(p, cfg, x, positions, mask)
    return gqa_full(p, cfg, x, positions, mask)


def attn_decode(p, cfg: ModelConfig, x, positions, cache, slot, mask):
    if cfg.attn_type == "mla":
        if isinstance(slot, torch.Tensor) and slot.dim() != 0:
            raise NotImplementedError(
                "per-row decode slots (in-flight batching) are only "
                "implemented for the GQA cache layout")
        return mla_decode(p, cfg, x, positions, cache, slot, mask)
    return gqa_decode(p, cfg, x, positions, cache, slot, mask)


def _refuse_mla_pool(cfg: ModelConfig) -> None:
    if cfg.attn_type == "mla":
        raise NotImplementedError(
            "the paged KV pool is only implemented for the GQA cache "
            "layout (MLA's latent cache pages differently)")


def attn_decode_paged(p, cfg: ModelConfig, x, positions, pool, page_table,
                      write_page, write_off, mask, write_src):
    _refuse_mla_pool(cfg)
    return gqa_decode_paged(p, cfg, x, positions, pool, page_table,
                            write_page, write_off, mask, write_src)


def attn_verify_paged(p, cfg: ModelConfig, x, positions, pool, page_table,
                      write_page, write_off, mask, write_src):
    _refuse_mla_pool(cfg)
    return gqa_verify_paged(p, cfg, x, positions, pool, page_table,
                            write_page, write_off, mask, write_src)
