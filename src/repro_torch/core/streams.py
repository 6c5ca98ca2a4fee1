"""Dual-stream execution (port of ``repro/core/streams.py``): the edge
stages and the batched cloud serving stages of a LISA pipeline.

``cloud_context_batch`` / ``cloud_insight_batch`` stack several packets of
one tier into one device call; ``cloud_generate_batch`` serves multi-token
answers through prefill + decode steps (``vlm.llm_generate``), whose decode
attention runs the flash-decode CUDA kernel when ``flash_decode`` is set.
Request counts are padded up to a bucket size, as in the reference, so the
shapes match the reference's. (PyTorch runs eagerly: there is no compile
cache to key.) Stages take and return numpy arrays: that is the payload
that crosses the link.

The in-flight stages serve the paged shared-prefix cache instead:
``cloud_prefix`` prefills a [ctx; query] prefix into fixed-size KV pages,
``pool_write`` writes them into the shared page pool, and
``cloud_decode_rows`` advances every live slot one token through per-row
page tables (``vlm.llm_decode_step_paged``, whose decode attention runs
the paged flash-decode CUDA kernel), and ``cloud_verify_rows`` scores a
chunk of tokens per slot in one pass for speculative decoding
(``vlm.llm_verify_step_paged``, the paged verify CUDA kernel). The pool
and the SAM features stay on the device; logits, <SEG> states and masks
come back as numpy.

Every copy between host and card goes through ``to_device`` / ``host``,
each inside the explicit window (:func:`sync_window`): under
``AveryEngine(debug_transfers=True)``, whose guard
(``analysis.sanitizers.transfer_guard_ctx``) sets the sync debug mode to
"error", these boundary copies stay allowed and any other host-card
synchronisation raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, bridge, resolve_device
from repro_torch.configs.lisa7b import LISAPipelineConfig
from repro_torch.core import bottleneck as bn
from repro_torch.core import packets as pk
from repro_torch.core import vlm
from repro_torch.core.lut import SystemLUT, Tier


class Stream(enum.Enum):
    CONTEXT = "context"   # high-frequency, low-resolution awareness
    INSIGHT = "insight"   # low-frequency, high-fidelity grounding


def _pad_rows(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Pad axis 0 up to ``bucket`` by repeating the last row (rows past the
    real count are sliced away after the call)."""
    n = arr.shape[0]
    if n == bucket:
        return arr
    reps = np.repeat(arr[-1:], bucket - n, axis=0)
    return np.concatenate([arr, reps], axis=0)


def _pool_write(dst: Dict, src: Dict, page_ids: torch.Tensor) -> Dict:
    """Write one prefilled prefix's pages (leaves (L, n, page, ...)) into
    the shared page pool (leaves (L, P, page, ...)) at ``page_ids`` (n,),
    IN PLACE (the reference returns a rebuilt pool). Returns ``dst``."""
    for d, s in zip(dst["groups"], src["groups"]):
        for name in d:
            d[name][:, page_ids] = s[name]
    return dst


def on_card(device: Any) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class SyncDebugMode:
    """``torch.cuda.set_sync_debug_mode(mode)`` for a region; the mode
    found on entry is restored on every exit."""

    def __init__(self, mode: Any):
        self.mode = mode

    def __enter__(self) -> None:
        self.prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(self.mode)

    def __exit__(self, *exc: Any) -> bool:
        torch.cuda.set_sync_debug_mode(self.prev)
        return False


NULL_CTX = contextlib.nullcontext()


def sync_window(device: Any):
    """The explicit window: inside a guarded region, permit the
    synchronisation of an explicit copy or wait on ``device``. A no-op
    off the card and outside a guard."""
    if not on_card(device) or torch.cuda.get_sync_debug_mode() == 0:
        return NULL_CTX
    return SyncDebugMode(0)


def host(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> numpy, an explicit copy. numpy has no bfloat16, so
    bf16 comes back as float32 (exact; the cloud side casts it back to bf16
    losslessly)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    with sync_window(t.device):
        return t.detach().cpu().numpy()


def to_device(arr, device: torch.device) -> torch.Tensor:
    """numpy (or array-like) -> a tensor on ``device``, an explicit copy;
    a tensor already there is returned as it is."""
    with sync_window(device):
        if isinstance(arr, torch.Tensor):
            return arr.to(device)
        return torch.as_tensor(np.asarray(arr)).to(device)


@dataclass
class DualStreamExecutor:
    pcfg: LISAPipelineConfig
    params: dict                          # tensors or numpy leaves
    bottlenecks: Dict[str, dict]          # tier name -> bottleneck params
    lut: SystemLUT
    buckets: Tuple[int, ...] = (1, 2, 4, 8, 16)
    max_new_tokens: int = 4
    # route decode attention through the flash-decode CUDA kernels
    flash_decode: bool = True
    # KV page size (token slots per page) for the paged in-flight cache
    page_size: int = 16
    device: DeviceLike = None             # None -> cuda

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.buckets = tuple(sorted(self.buckets))
        self.params = bridge.to_torch(self.params, self.device)
        self.bottlenecks = bridge.to_torch(self.bottlenecks, self.device)

    @property
    def _gen_pcfg(self) -> LISAPipelineConfig:
        pcfg = self.pcfg
        return dataclasses.replace(
            pcfg, llm=pcfg.llm.replace(use_flash_decode=self.flash_decode))

    def _dev(self, arr) -> torch.Tensor:
        return to_device(arr, self.device)

    @property
    def num_compiled_stages(self) -> int:
        """Always 0: the reference counts its (stage, tier, bucket) jit
        cache here, and the port runs every stage eagerly, so it compiles
        none (``AveryEngine.stats()`` reports it as ``compiled_stages``)."""
        return 0

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n; oversized calls round up to a multiple of
        the largest bucket."""
        for b in self.buckets:
            if n <= b:
                return b
        top = self.buckets[-1]
        return ((n + top - 1) // top) * top

    # ---- edge side ----

    @torch.inference_mode()
    def edge_context(self, images, seq_id: int, now: float
                     ) -> Tuple[pk.Packet, np.ndarray]:
        ctx = host(vlm.clip_encode(self.params, self.pcfg,
                                    self._dev(images)))
        return pk.make_context_packet(seq_id, now, ctx), ctx

    @torch.inference_mode()
    def edge_insight(self, images, tier: Tier, seq_id: int, now: float,
                     ctx: Optional[np.ndarray] = None) -> pk.Packet:
        """``ctx``: precomputed CLIP features for this frame, which keeps
        the edge at one CLIP pass per frame."""
        img = self._dev(images)
        a = vlm.sam_head(self.params, self.pcfg, img)
        codes, scales = bn.encode(self.bottlenecks[tier.name], a)
        if ctx is None:
            ctx = host(vlm.clip_encode(self.params, self.pcfg, img))
        return pk.make_insight_packet(seq_id, now, tier.name, host(codes),
                                      host(scales),
                                      clip_feats=np.asarray(ctx))

    # ---- cloud side (single packet, thin wrappers of the batch stages) ----

    def cloud_context(self, packet: pk.Packet, query) -> np.ndarray:
        return self.cloud_context_batch([packet], [np.asarray(query)])[0]

    def cloud_insight(self, packet: pk.Packet, query
                      ) -> Tuple[np.ndarray, np.ndarray]:
        return self.cloud_insight_batch([packet], [np.asarray(query)])[0]

    # ---- cloud side (batched) ----

    def _stack(self, packets: Sequence[pk.Packet],
               queries: Sequence[np.ndarray], keys: Sequence[str]
               ) -> Tuple[List[np.ndarray], np.ndarray, List[int], int]:
        """Concatenate per-packet content rows + queries along the batch
        axis and pad to the bucket. Returns (stacked content arrays in
        ``keys`` order, stacked queries, per-packet row counts, bucket)."""
        rows = [np.asarray(q).reshape(-1, np.asarray(q).shape[-1])
                for q in queries]
        counts = [p.content[keys[0]].shape[0] for p in packets]
        if any(r.shape[0] != c for r, c in zip(rows, counts)):
            raise ValueError(
                f"query batch rows {[r.shape[0] for r in rows]} do not match "
                f"packet batch rows {counts}")
        bucket = self.bucket_for(sum(counts))
        content = [_pad_rows(np.concatenate(
            [np.asarray(p.content[k]) for p in packets], axis=0), bucket)
            for k in keys]
        query = _pad_rows(np.concatenate(rows, axis=0), bucket)
        return content, query, counts, bucket

    @staticmethod
    def _split(arrs: Sequence[np.ndarray], counts: Sequence[int]
               ) -> List[Tuple[np.ndarray, ...]]:
        """Slice off the pad rows and split back into per-packet results."""
        out, lo = [], 0
        for c in counts:
            out.append(tuple(np.asarray(a[lo:lo + c]) for a in arrs))
            lo += c
        return out

    def _sam_feats(self, tier: str, codes, scales) -> torch.Tensor:
        a = bn.decode(self.bottlenecks[tier], self._dev(codes),
                      self._dev(scales), out_dtype=self.pcfg.sam.adtype)
        return vlm.sam_tail(self.params, self.pcfg, a)

    @torch.inference_mode()
    def cloud_context_batch(self, packets: Sequence[pk.Packet],
                            queries: Sequence[np.ndarray]
                            ) -> List[np.ndarray]:
        """Batched Context stage: K packets -> K answer-logit arrays."""
        (ctx,), query, counts, _ = self._stack(packets, queries, ["ctx"])
        logits, _ = vlm.llm_reason(self.params, self.pcfg, self._dev(ctx),
                                   self._dev(query))
        return [r[0] for r in self._split([host(logits)], counts)]

    @torch.inference_mode()
    def cloud_insight_batch(self, packets: Sequence[pk.Packet],
                            queries: Sequence[np.ndarray]
                            ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Batched Insight stage: K same-tier packets -> K
        (mask_logits, answer_logits) pairs."""
        tier = self._same_tier(packets)
        (codes, scales, ctx), query, counts, _ = self._stack(
            packets, queries, ["codes", "scales", "clip"])
        feats = self._sam_feats(tier, codes, scales)
        logits, seg = vlm.llm_reason(self.params, self.pcfg, self._dev(ctx),
                                     self._dev(query))
        mask = vlm.mask_decode(self.params, self.pcfg, feats, seg)
        return self._split([host(mask), host(logits)], counts)

    @torch.inference_mode()
    def cloud_generate_batch(self, packets: Sequence[pk.Packet],
                             queries: Sequence[np.ndarray]
                             ) -> List[Tuple[np.ndarray, ...]]:
        """Batched multi-token serving through the KV-cache decode path.
        Context packets -> (answer_logits, tokens); Insight packets ->
        (mask_logits, answer_logits, tokens). ``tokens`` is the greedy
        ``max_new_tokens``-long answer."""
        T, gcfg = self.max_new_tokens, self._gen_pcfg
        if packets[0].kind == "context":
            (ctx,), query, counts, _ = self._stack(packets, queries, ["ctx"])
            tokens, logits, _ = vlm.llm_generate(
                self.params, gcfg, self._dev(ctx), self._dev(query), T)
            return self._split([host(logits), host(tokens)], counts)
        tier = self._same_tier(packets)
        (codes, scales, ctx), query, counts, _ = self._stack(
            packets, queries, ["codes", "scales", "clip"])
        feats = self._sam_feats(tier, codes, scales)
        tokens, logits, seg = vlm.llm_generate(
            self.params, gcfg, self._dev(ctx), self._dev(query), T)
        mask = vlm.mask_decode(self.params, self.pcfg, feats, seg)
        return self._split([host(mask), host(logits), host(tokens)],
                           counts)

    # ---- cloud side (in-flight / paged continuous batching) ----
    #
    # ``cloud_generate_batch`` serves a closed microbatch end to end. The
    # stages below split that into page-table operations for the
    # ``InflightDecoder``, which owns the allocator and prefix store
    # (``core.paging``).

    @torch.inference_mode()
    def cloud_sam_feats(self, packet: pk.Packet) -> torch.Tensor:
        """Per-frame Insight tail: bottleneck decode + SAM suffix -> mask
        features, kept on the device for ``cloud_mask``."""
        return self._sam_feats(packet.tier_name, packet.content["codes"],
                               packet.content["scales"])

    @torch.inference_mode()
    def cloud_prefix(self, ctx, query) -> Tuple[np.ndarray, Dict]:
        """Prefill one request's [ctx; query] prefix into KV pages. Returns
        (first-token logits (1, V) as numpy, paged KV on the device with
        leaves (L, n_pages, page_size, K, hd)), the unit ``pool_write``
        consumes. One sequence per call: pool rows are per-request."""
        query = np.asarray(query).reshape(-1, np.asarray(query).shape[-1])
        if query.shape[0] != 1:
            raise ValueError(
                f"prefix prefill is per-sequence, got {query.shape[0]} rows")
        logits0, _, paged = vlm.llm_prefill_paged(
            self.params, self.pcfg, self._dev(ctx), self._dev(query),
            self.page_size)
        # one request per pool row: drop the unit batch axis
        return host(logits0), {"groups": [
            {name: a[:, 0] for name, a in g.items()}
            for g in paged["groups"]]}

    @torch.inference_mode()
    def pool_write(self, pool: Dict, paged_kv: Dict, page_ids) -> Dict:
        """Write a prefilled prefix's pages into the shared page pool at
        ``page_ids``, in place; returns the pool."""
        return _pool_write(pool, paged_kv,
                           self._dev(np.asarray(page_ids, np.int64)))

    @torch.inference_mode()
    def cloud_decode_rows(self, pool: Dict, page_table, positions, tokens,
                          pos, write_slot
                          ) -> Tuple[np.ndarray, np.ndarray, Dict]:
        """One paged decode step over all slots. pool {"groups": [kv]}
        with leaves (L, P, page, K, hd); page_table (slots, n_pages) int32
        (idle rows parked on the trash page); positions
        (slots, n_pages*page) int32 absolute slot positions (-1 empty);
        tokens (slots, 1) int32; pos / write_slot (slots,) int32. Idle rows
        write into the trash page and their outputs are discarded.
        Returns (answer_logits, seg) as numpy and the pool, updated in
        place."""
        i32 = [self._dev(np.asarray(a, np.int32))
               for a in (page_table, positions, tokens, pos, write_slot)]
        logits, seg, pool = vlm.llm_decode_step_paged(
            self.params, self._gen_pcfg, pool, *i32)
        return host(logits), host(seg), pool

    @torch.inference_mode()
    def cloud_verify_rows(self, pool: Dict, page_table, positions, tokens,
                          pos, write_slot, chunk_len
                          ) -> Tuple[np.ndarray, np.ndarray, Dict]:
        """One speculative verify step over all slots: tokens (slots, C)
        int32 chunks (last accepted token + drafts, padded past
        ``chunk_len``); pos / write_slot (slots,) int32 starts; chunk_len
        (slots,) int32 real entries per row (pad entries write to the trash
        page and their logits are discarded). Returns (answer_logits
        (slots, C, V), seg (slots, C, d_sam)) as numpy and the pool,
        updated in place."""
        i32 = [self._dev(np.asarray(a, np.int32))
               for a in (page_table, positions, tokens, pos, write_slot,
                         chunk_len)]
        logits, seg, pool = vlm.llm_verify_step_paged(
            self.params, self._gen_pcfg, pool, *i32)
        return host(logits), host(seg), pool

    @torch.inference_mode()
    def cloud_mask(self, feats: torch.Tensor, seg) -> np.ndarray:
        """<SEG>-conditioned mask decode from stored SAM feats (the final
        in-flight stage for Insight requests)."""
        return host(vlm.mask_decode(self.params, self.pcfg, feats,
                                     self._dev(seg)))

    @staticmethod
    def _same_tier(packets: Sequence[pk.Packet]) -> str:
        tiers = {p.tier_name for p in packets}
        if len(tiers) != 1:
            raise ValueError(f"mixed tiers in one microbatch: {tiers} — "
                             "bucket packets by tier before batching")
        return next(iter(tiers))
