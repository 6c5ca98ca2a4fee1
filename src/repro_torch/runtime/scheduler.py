"""Continuous-batching microbatch scheduler for the cloud serving engine
(host copy of ``repro/runtime/scheduler.py``).

  arrival queue -> head-of-line key (kind, tier, query length) -> FIFO
  microbatch of up to ``max_batch`` matching requests -> one batched
  executor call.

Requests of other keys are never reordered within their own key, and
results are handed back per request.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import packets as pk
from repro_torch.core.intent import Intent


@dataclass
class ServeRequest:
    seq_id: int
    intent: Intent
    packet: pk.Packet
    query: np.ndarray                 # (B, L) or (L,) tokenised query
    arrival_s: float = 0.0


@dataclass
class ServeResult:
    seq_id: int
    intent: Intent
    tier_name: Optional[str]
    answer_logits: np.ndarray         # (B, V)
    mask_logits: Optional[np.ndarray] = None   # (B, H, W), Insight only
    tokens: Optional[np.ndarray] = None        # (B, T), generate mode only
    batch_size: int = 1               # microbatch this request rode in


def _batch_key(req: ServeRequest) -> Tuple[str, Optional[str], int]:
    """Requests stack only when kind, tier AND query length agree."""
    return (req.packet.kind, req.packet.tier_name,
            int(np.asarray(req.query).shape[-1]))


def _rows(req: ServeRequest) -> int:
    """Content rows this request contributes to a stacked device batch."""
    key = "ctx" if req.packet.kind == "context" else "codes"
    arr = req.packet.content.get(key)
    return int(arr.shape[0]) if arr is not None else 1


@dataclass
class MicrobatchScheduler:
    """Groups queued requests into same-(kind, tier) microbatches and runs
    them on the batched executor. ``generate=True`` serves multi-token
    answers through the prefill + flash-decode path; otherwise the
    single-token ``llm_reason`` stage runs."""
    executor: object                  # DualStreamExecutor
    max_batch: int = 8
    generate: bool = False
    _queue: Deque[ServeRequest] = field(default_factory=deque)
    n_microbatches: int = 0
    n_requests: int = 0

    def __post_init__(self):
        self._row_cap = max(self.executor.buckets)
        self.max_batch = max(1, min(self.max_batch, self._row_cap))

    def submit(self, req: ServeRequest) -> None:
        if _rows(req) > self._row_cap:
            raise ValueError(
                f"packet carries {_rows(req)} rows, above the largest "
                f"executor bucket {self._row_cap}; split it at the edge")
        self._queue.append(req)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def _take_microbatch(self, key: Optional[Tuple] = None
                         ) -> List[ServeRequest]:
        """Pop requests matching ``key`` (default: the head-of-line key)
        while the request count and stacked rows fit; FIFO within the key,
        other keys keep their order."""
        if not self._queue:
            return []
        if key is None:
            key = _batch_key(self._queue[0])
        taken: List[ServeRequest] = []
        kept: Deque[ServeRequest] = deque()
        rows, closed = 0, False
        for r in self._queue:
            if not closed and _batch_key(r) == key:
                if (len(taken) < self.max_batch
                        and rows + _rows(r) <= self._row_cap):
                    taken.append(r)
                    rows += _rows(r)
                    continue
                closed = True
            kept.append(r)
        self._queue = kept
        return taken

    def step(self) -> List[ServeResult]:
        """Serve one microbatch from the head-of-line key."""
        return self._execute(self._take_microbatch())

    def _execute(self, batch: List[ServeRequest]) -> List[ServeResult]:
        if not batch:
            return []
        self.n_microbatches += 1
        self.n_requests += len(batch)
        packets = [r.packet for r in batch]
        queries = [r.query for r in batch]
        kind = batch[0].packet.kind
        results: List[ServeResult] = []
        if self.generate:
            outs = self.executor.cloud_generate_batch(packets, queries)
            for r, out in zip(batch, outs):
                if kind == "insight":
                    mask, logits, tokens = out
                else:
                    mask, (logits, tokens) = None, out
                results.append(ServeResult(
                    r.seq_id, r.intent, r.packet.tier_name, logits,
                    mask_logits=mask, tokens=tokens, batch_size=len(batch)))
        elif kind == "insight":
            outs = self.executor.cloud_insight_batch(packets, queries)
            for r, (mask, logits) in zip(batch, outs):
                results.append(ServeResult(
                    r.seq_id, r.intent, r.packet.tier_name, logits,
                    mask_logits=mask, batch_size=len(batch)))
        else:
            outs = self.executor.cloud_context_batch(packets, queries)
            for r, logits in zip(batch, outs):
                results.append(ServeResult(
                    r.seq_id, r.intent, None, logits,
                    batch_size=len(batch)))
        return results

    def step_ready(self) -> List[ServeResult]:
        """Serve while a full microbatch of some key is queued."""
        results: List[ServeResult] = []
        while (key := self._ready_key()) is not None:
            results.extend(self._execute(self._take_microbatch(key)))
        return results

    def _ready_key(self) -> Optional[Tuple]:
        counts: Dict[Tuple, int] = {}
        rows: Dict[Tuple, int] = {}
        for r in self._queue:
            k = _batch_key(r)
            counts[k] = counts.get(k, 0) + 1
            rows[k] = rows.get(k, 0) + _rows(r)
            if counts[k] >= self.max_batch or rows[k] >= self._row_cap:
                return k
        return None

    def drain(self) -> List[ServeResult]:
        results: List[ServeResult] = []
        while self._queue:
            results.extend(self.step())
        return results

    def serve_all(self, reqs: Sequence[ServeRequest]) -> List[ServeResult]:
        """Submit everything, drain, and return results aligned with the
        input order."""
        for r in reqs:
            self.submit(r)
        by_id = {res.seq_id: res for res in self.drain()}
        return [by_id[r.seq_id] for r in reqs]

    @property
    def mean_batch_size(self) -> float:
        return self.n_requests / max(1, self.n_microbatches)
