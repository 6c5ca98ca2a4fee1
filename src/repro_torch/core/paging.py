"""Paged KV-cache bookkeeping for the cloud serving engine (port of
``repro/core/paging.py``).

KV lives in a shared **page pool**: fixed-size pages of ``page_size`` token
slots per LLM layer, which every request addresses through its own
**page table**. Freed pages return to the allocator and are reused without
clearing (stale KV is masked by the position bookkeeping, never attended),
and the ``[ctx; query]`` prefix of successive frames from one operator is
content-addressed in a **prefix store**, so a repeat maps the same
read-only pages and skips the prefill.

The host side (refcounting free-page allocator, LRU-capped prefix store,
``grow_to``/``rollback_to``, the invariant audit and the telemetry) is a
copy of the reference. The device pool is torch:
``{"groups": [{"k", "v"}]}``, each leaf ``(L, P, page, K, hd)`` on the
device and dtype of the first prefill. It is zero-filled on creation and
on every growth, as the reference does: masking is additive, so a page
holding NaN would poison live rows through ``0 * NaN`` in P.V, and every
live row's unused table entries point at the trash page.

Page id 0 is the reserved **trash page**: idle decode rows park their page
tables on it, so their (discarded) writes never touch a live request's
pages. The allocator never hands it out.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

TRASH_PAGE = 0
_SHARDING = ("sharded serving (placement/shards) is not ported yet; see "
             "ROADMAP.md, Queue 1, sharding")


def pages_for(tokens: int, page_size: int) -> int:
    """Number of pages covering ``tokens`` slots."""
    return -(-int(tokens) // int(page_size))


def prefix_digest(ctx: Any, query: Any) -> str:
    """Content hash of one request's ``[ctx; query]`` LLM prefix. Two
    requests share prefix pages iff their digests (and operator) match.
    Hashes the same bytes as the reference, so both see the same hits."""
    h = hashlib.sha1()
    for arr in (ctx, query):
        a = np.ascontiguousarray(np.asarray(arr))
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def prefix_positions(prefix_len: int, n_pages: int, page_size: int
                     ) -> np.ndarray:
    """Absolute positions of the prefix region of one row's virtual
    sequence: ``[0, prefix_len)`` then ``-1`` (empty) through the zero-
    padded tail of the last prefix page."""
    out = np.full((n_pages * page_size,), -1, np.int32)
    out[:prefix_len] = np.arange(prefix_len, dtype=np.int32)
    return out


@dataclass
class PrefixEntry:
    """One cached ``[ctx; query]`` prefix: its read-only pages plus the
    prefill products every sharer reuses verbatim."""
    key: Tuple[str, str]               # (operator_id, content digest)
    page_ids: Tuple[int, ...]
    prefix_len: int
    logits0: np.ndarray                # (1, V) first-token logits


def _zeros_like_pages(a: torch.Tensor, pages: int) -> torch.Tensor:
    return torch.zeros((a.shape[0], pages) + tuple(a.shape[2:]),
                       dtype=a.dtype, device=a.device)


class PagePool:
    """Free-page allocator + prefix store over one shared device pool.

    ``kv`` is ``{"groups": [{"k", "v"}]}`` with leaves (L, P, page, K, hd),
    created from the first prefill's page shapes and grown (doubling) when
    the free list runs dry, so allocation never fails and admission never
    deadlocks. Pages are refcounted: prefix pages carry one pin from the
    store plus one per active sharer; private decode pages carry exactly
    their request's reference.
    """

    def __init__(self, page_size: int = 16, share_prefixes: bool = True,
                 initial_pages: Optional[int] = None,
                 max_prefixes: Optional[int] = None,
                 placement: Optional[Any] = None, shards: int = 1):
        if placement is not None or shards != 1:
            raise NotImplementedError(_SHARDING)
        self.page_size = int(page_size)
        self.share_prefixes = bool(share_prefixes)
        self.initial_pages = initial_pages
        self.kv_shards = 1
        if max_prefixes is not None and max_prefixes < 1:
            raise ValueError(f"max_prefixes must be >= 1, got {max_prefixes}")
        self.max_prefixes = max_prefixes
        self.kv: Optional[Dict] = None
        self._refcount: List[int] = []
        self._free: List[int] = []
        # insertion order doubles as recency order: a hit reinserts its
        # key at the back, so the front is always the LRU candidate
        self.prefix: Dict[Tuple[str, str], PrefixEntry] = {}
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_evictions = 0
        self.kv_pages_peak = 0

    # ---- capacity ----

    @property
    def num_pages(self) -> int:
        return len(self._refcount)

    @property
    def pages_in_use(self) -> int:
        """Live pages, excluding the reserved trash page."""
        return sum(1 for c in self._refcount[1:] if c > 0)

    def _leaves(self) -> List[torch.Tensor]:
        return [a for g in self.kv["groups"] for a in g.values()]

    @property
    def page_bytes(self) -> int:
        """Device bytes of one page across all layers (k + v leaves)."""
        if self.kv is None:
            return 0
        total = sum(a.numel() * a.element_size() for a in self._leaves())
        return total // max(1, self.num_pages)

    @property
    def pool_bytes(self) -> int:
        """Total device bytes resident in the pool (all pages, all
        layers)."""
        return self.page_bytes * self.num_pages

    def ensure(self, n_free: int, like: Optional[Dict] = None,
               capacity_hint: int = 0) -> None:
        """Guarantee ``n_free`` allocatable pages. ``like`` (a prefill's
        paged KV, leaves ``(L, n, page, K, hd)``) is required on the first
        call to shape the pool; later calls grow by doubling. New pages
        are zero-filled."""
        if self.kv is None:
            if like is None:
                raise RuntimeError("page pool is empty and no prefill "
                                   "shapes were provided to create it")
            cap = max(n_free + 1, capacity_hint, self.initial_pages or 0)
            self.kv = {"groups": [{name: _zeros_like_pages(a, cap)
                                   for name, a in g.items()}
                                  for g in like["groups"]]}
            self._refcount = [1] + [0] * (cap - 1)   # page 0: trash, pinned
            self._free = list(range(1, cap))
            return
        while len(self._free) < n_free:
            old = self.num_pages
            grow = max(old, n_free)
            self.kv = {"groups": [
                {name: torch.cat([a, _zeros_like_pages(a, grow)], dim=1)
                 for name, a in g.items()} for g in self.kv["groups"]]}
            self._refcount.extend([0] * grow)
            self._free.extend(range(old, old + grow))

    # ---- refcounted page allocation ----

    def alloc(self, n: int) -> List[int]:
        if len(self._free) < n:
            self.ensure(n)
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._refcount[i] = 1
        self.kv_pages_peak = max(self.kv_pages_peak, self.pages_in_use)
        return ids

    def retain(self, ids: Sequence[int]) -> None:
        for i in ids:
            assert self._refcount[i] > 0, f"retain of free page {i}"
            self._refcount[i] += 1

    def release(self, ids: Sequence[int]) -> None:
        for i in ids:
            self._refcount[i] -= 1
            assert self._refcount[i] >= 0, f"double free of page {i}"
            if self._refcount[i] == 0:
                self._free.append(i)

    # ---- speculative allocation (draft overhang + rollback) ----

    def grow_to(self, ids: List[int], tokens: int) -> List[int]:
        """Extend one row's private page run (in place) to cover
        ``tokens`` slots. Returns the freshly allocated page ids (empty
        when the run already covers ``tokens``)."""
        need = pages_for(tokens, self.page_size)
        if need <= len(ids):
            return []
        fresh = self.alloc(need - len(ids))
        ids.extend(fresh)
        return fresh

    def rollback_to(self, ids: List[int], tokens: int) -> List[int]:
        """Truncate one row's private page run (in place) to the pages
        covering ``tokens`` accepted slots. Pages wholly past that length
        lose this row's reference and free immediately (refcounts intact).
        Returns the dropped page ids so the caller can park its page-table
        entries back on the trash page."""
        keep = pages_for(tokens, self.page_size)
        if keep >= len(ids):
            return []
        dropped = list(ids[keep:])
        del ids[keep:]
        self.release(dropped)
        return dropped

    # ---- prefix store ----

    def lookup_prefix(self, key: Tuple[str, str]) -> Optional[PrefixEntry]:
        entry = self.prefix.get(key) if self.share_prefixes else None
        if entry is None:
            self.prefix_misses += 1
        else:
            self.prefix_hits += 1
            self.prefix.pop(key)          # refresh recency: move to back
            self.prefix[key] = entry
        return entry

    def put_prefix(self, key: Tuple[str, str], page_ids: Sequence[int],
                   prefix_len: int, logits0: np.ndarray) -> PrefixEntry:
        """Register a freshly prefilled prefix. The caller's ``alloc``
        reference stays the request's; when sharing is on, the store takes
        one pin of its own on top (released by ``release_operator`` or LRU
        eviction), so the pages outlive the request."""
        entry = PrefixEntry(key=key, page_ids=tuple(page_ids),
                            prefix_len=int(prefix_len),
                            logits0=np.asarray(logits0))
        if self.share_prefixes:
            self.prefix[key] = entry
            self.retain(entry.page_ids)
            self._evict_lru()
        return entry

    def _evict_lru(self) -> None:
        """Enforce ``max_prefixes``: drop least-recently-hit entries (the
        store's pin only, so eviction is always refcount-safe)."""
        if self.max_prefixes is None:
            return
        while len(self.prefix) > self.max_prefixes:
            lru = next(iter(self.prefix))
            self.release(self.prefix.pop(lru).page_ids)
            self.prefix_evictions += 1

    def release_operator(self, operator_id: str) -> int:
        """Drop every stored prefix of one operator (their pin). Returns
        the number of entries released."""
        keys = [k for k in self.prefix if k[0] == operator_id]
        for k in keys:
            self.release(self.prefix.pop(k).page_ids)
        return len(keys)

    # ---- invariant audit ----

    def check_invariants(self) -> Dict[str, int]:
        """Audit the allocator: every page is exactly one of {trash, live,
        free}, the free list carries no duplicates and only refcount-zero
        pages, no refcount is negative, and every stored prefix still
        holds live pages. Raises ``RuntimeError`` naming the violations;
        returns the page accounting on success."""
        errs = []
        rc = self._refcount
        if any(c < 0 for c in rc):
            errs.append("negative refcount")
        if len(set(self._free)) != len(self._free):
            errs.append("duplicate ids on the free list")
        if rc and TRASH_PAGE in self._free:
            errs.append("trash page on the free list")
        if rc and rc[TRASH_PAGE] < 1:
            errs.append("trash page lost its pin")
        for i in self._free:
            if rc[i] != 0:
                errs.append(f"free page {i} has refcount {rc[i]}")
                break
        if rc and self.pages_in_use + len(self._free) != self.num_pages - 1:
            errs.append(
                f"conservation violated: {self.pages_in_use} in use + "
                f"{len(self._free)} free != {self.num_pages} pages - trash")
        for key, entry in self.prefix.items():
            if any(rc[i] <= 0 for i in entry.page_ids):
                errs.append(f"prefix {key} holds a freed page")
                break
        if errs:
            raise RuntimeError("PagePool invariants violated: "
                               + "; ".join(errs))
        return {"pages_in_use": self.pages_in_use,
                "pages_free": len(self._free),
                "pages_total": self.num_pages}

    # ---- telemetry ----

    @property
    def prefix_hit_rate(self) -> float:
        n = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / n if n else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "kv_page_size": self.page_size,
            "kv_pages_total": self.num_pages,
            "kv_pages_in_use": self.pages_in_use,
            "kv_pages_peak": self.kv_pages_peak,
            "kv_pool_bytes": self.pool_bytes,
            "kv_pool_bytes_per_shard": self.pool_bytes // self.kv_shards,
            "kv_shards": self.kv_shards,
            "prefix_entries": len(self.prefix),
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_rate": self.prefix_hit_rate,
            "prefix_evictions": self.prefix_evictions,
        }
