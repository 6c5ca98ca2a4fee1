"""Fleet-scale multi-tenant admission (host copy of
``repro/engine/scheduler.py``): QoS classes, weighted-fair queues,
preemption picking, and per-operator rate limits.

The ``InflightDecoder`` used to admit strictly FIFO from one ``deque``,
so a burst of Insight prefills from one UAV starved every other
operator's Context traffic. This module makes admission a pluggable
policy:

**QoS classes.** Requests map to two classes by intent — Context is the
*latency* class (an operator is waiting on situational awareness),
Insight the *throughput* class (segmentation masks aggregate downstream)
— with an explicit integer ``priority`` override per request/session
layered on top. Higher priority is strictly served first; within a
priority band the classes share slots weighted-fairly.

**Weighted-fair admission.** ``QoSScheduler`` arbitrates the classes
with stride/deficit accounting: each class carries a pass counter that
advances by ``1 / weight`` per admission, and the backlogged class with
the lowest counter admits next. Over any backlogged interval class ``c``
receives ``weight_c / sum(weights)`` of the slots — Insight can't
monopolize, Context can't starve it either. A class returning from idle
is caught up to the backlog floor so it can't bank credit while empty.

**Preemption.** When an urgent request — deadline inside
``preempt_slack_s``, or a latency-class/priority request waiting past
``latency_patience_s`` — would otherwise keep queueing, the scheduler
nominates the lowest-ranked active decode as a victim. The decoder parks
it: private decode pages roll back (``PagePool.rollback_to``), the
prefix reference drops, the generated-so-far tokens ride the request
back to the *front* of its class queue, and on re-admission the row
replays them from its prefix. Greedy decoding is deterministic, so the
resumed request is token-exact with an uninterrupted run (pinned by
tests and the fleet-storm bench); the cost is re-decoding the replayed
tokens, surfaced as ``tokens_replayed``. ``max_resumes`` bounds how
often one request may be parked (anti-thrash), and a victim must rank
*strictly* below the preemptor, so preemption chains terminate.

**Overload control.** A token bucket per ``operator_id`` (shared across
every decoder spawned from one prototype) sheds arrivals from operators
exceeding their rate at the engine front door — before any edge compute
or cloud prefill — and a bounded per-class queue sheds the tail under
global overload. Both resolve the request with ``failure="rejected"``
and a reason (``rate_limit`` / ``queue_full``) instead of letting it
rot in a queue it can never clear.

``FifoScheduler`` preserves the old behavior exactly (one FIFO queue,
never rejects, never preempts) and is the engine default. Telemetry
(queue depth, time-in-queue, preemptions, rejections) lives on a single
object shared by a prototype and everything it ``spawn``s, so
``AveryEngine.stats()`` survives decoder retirement.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.intent import Intent

QOS_LATENCY = "latency"        # Context: an operator is waiting
QOS_THROUGHPUT = "throughput"  # Insight: aggregate throughput matters
QOS_CLASSES = (QOS_LATENCY, QOS_THROUGHPUT)


def qos_class(intent: Intent) -> str:
    """Intent -> QoS class (the class table in docs/engine.md)."""
    return QOS_LATENCY if intent is Intent.CONTEXT else QOS_THROUGHPUT


def _rank(intent: Intent, priority: int) -> Tuple[int, int]:
    """Total order used for strict-priority pops and preemption: the
    explicit priority band first, latency class over throughput within
    a band."""
    return (int(priority), 1 if qos_class(intent) is QOS_LATENCY else 0)


def jain_index(counts) -> float:
    """Jain's fairness index over per-operator served counts: 1.0 is
    perfectly even, 1/n is one operator taking everything."""
    xs = np.asarray(list(counts), dtype=np.float64)
    if xs.size == 0 or not np.any(xs):
        return 1.0
    return float(xs.sum() ** 2 / (xs.size * (xs ** 2).sum()))


@dataclass
class _TokenBucket:
    """Per-operator rate limiter on the mission clock."""
    rate_per_s: float
    burst: float
    tokens: float
    t_last: float

    def take(self, now: float) -> bool:
        self.tokens = min(self.burst, self.tokens
                          + max(0.0, now - self.t_last) * self.rate_per_s)
        self.t_last = max(self.t_last, now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclass
class SchedTelemetry:
    """Counters shared by a scheduler prototype and all its spawns —
    engine stats read these, so they survive decoder retirement."""
    preemptions: int = 0
    resumed_served: int = 0           # finished after >=1 preemption
    tokens_replayed: int = 0
    rejected_rate_limit: int = 0
    rejected_queue_full: int = 0
    expired_pending: int = 0          # dead on arrival at admission
    admitted: Dict[str, int] = field(
        default_factory=lambda: {c: 0 for c in QOS_CLASSES})
    # per-admission time-in-queue samples (mission seconds), bounded
    waits: Dict[str, Deque[float]] = field(
        default_factory=lambda: {c: deque(maxlen=4096)
                                 for c in QOS_CLASSES})

    def note_admitted(self, cls: str, wait_s: float) -> None:
        self.admitted[cls] += 1
        self.waits[cls].append(float(wait_s))

    def wait_percentile(self, cls: str, q: float) -> float:
        w = self.waits[cls]
        return float(np.percentile(list(w), q)) if w else 0.0


class _SchedulerBase:
    """Shared plumbing: the spawn/prototype split, telemetry, and the
    stats surface. A prototype lives on the engine (rate limiting +
    stats); each ``InflightDecoder`` gets a ``spawn()`` with its own
    queues but shared telemetry and token buckets. Constructing a
    scheduler and handing it straight to a decoder (no spawn) also
    works — the instance is then both."""

    def __init__(self) -> None:
        self.telemetry = SchedTelemetry()
        self._buckets: Dict[str, _TokenBucket] = {}
        self._children: List[Any] = []
        self._metrics: Optional[Any] = None

    # -- prototype side --

    def spawn(self):
        child = self._fresh()
        child.telemetry = self.telemetry
        child._buckets = self._buckets
        child._metrics = self._metrics
        self._children.append(child)
        return child

    def bind_metrics(self, registry: Any) -> None:
        """Attach the engine's :class:`MetricsRegistry`: admissions then
        also feed the per-class ``sched_wait_s:<cls>`` histograms (the
        bounded-deque percentiles in ``stats()`` stay authoritative for
        back-compat; the registry adds p99 and the full surface)."""
        self._metrics = registry
        for child in self._children:
            child._metrics = registry

    def _fresh(self):                          # pragma: no cover
        raise NotImplementedError

    def admission_check(self, operator_id: str,
                        now: float) -> Optional[str]:
        """Engine front door: may this operator submit at ``now``?
        Returns a rejection reason or None. Base: no rate limiting."""
        return None

    def _depth(self, cls: str) -> int:
        views = [self] + [c for c in self._children if len(c)]
        return sum(v._class_depth(cls) for v in views)

    def load(self) -> Dict[str, int]:
        """Live queue pressure, the policy's ``adapt_to_load`` input."""
        d = {c: self._depth(c) for c in QOS_CLASSES}
        return {"queue_depth": sum(d.values()),
                "queue_depth_latency": d[QOS_LATENCY],
                "queue_depth_throughput": d[QOS_THROUGHPUT]}

    def stats(self) -> Dict[str, float]:
        t = self.telemetry
        out: Dict[str, float] = {
            "sched_preemptions": t.preemptions,
            "sched_resumed_served": t.resumed_served,
            "sched_tokens_replayed": t.tokens_replayed,
            "sched_rejected_rate_limit": t.rejected_rate_limit,
            "sched_rejected_queue_full": t.rejected_queue_full,
            "sched_expired_pending": t.expired_pending,
        }
        for cls in QOS_CLASSES:
            out[f"sched_queue_depth_{cls}"] = self._depth(cls)
            out[f"sched_admitted_{cls}"] = t.admitted[cls]
            out[f"sched_wait_{cls}_p50_s"] = t.wait_percentile(cls, 50)
            out[f"sched_wait_{cls}_p95_s"] = t.wait_percentile(cls, 95)
        return out

    # -- decoder side (per-spawn queues) --

    def _class_depth(self, cls: str) -> int:   # pragma: no cover
        raise NotImplementedError

    def __len__(self) -> int:
        return sum(self._class_depth(c) for c in QOS_CLASSES)

    @property
    def has_pending(self) -> bool:
        return len(self) > 0

    def note_admitted(self, item, now: float) -> None:
        """Record one admission: accumulate the request's queue wait
        (summed across preemption round-trips) and sample it."""
        wait = max(0.0, now - item.t_enqueue)
        item.queue_wait += wait
        cls = qos_class(item.intent)
        self.telemetry.note_admitted(cls, wait)
        if self._metrics is not None:
            self._metrics.histogram(f"sched_wait_s:{cls}").observe(wait)

    def note_expired(self) -> None:
        self.telemetry.expired_pending += 1

    def note_preempted(self) -> None:
        self.telemetry.preemptions += 1

    def note_resumed_served(self) -> None:
        self.telemetry.resumed_served += 1

    def note_replayed(self, n: int = 1) -> None:
        self.telemetry.tokens_replayed += n

    def pick_preemption(self, active: Dict[int, Any],
                        now: float) -> Optional[Tuple[Any, int]]:
        """Nominate ``(pending_item, victim_slot)`` — the item is popped
        from its queue — or None. Base: never preempt."""
        return None


class FifoScheduler(_SchedulerBase):
    """Today's behavior, verbatim: one FIFO queue, arrival order, no
    rejection, no preemption. ``queue`` is the real deque (tests and
    benches seed it directly)."""

    def __init__(self) -> None:
        super().__init__()
        self.queue: Deque[Any] = deque()

    def _fresh(self) -> "FifoScheduler":
        return FifoScheduler()

    def _class_depth(self, cls: str) -> int:
        return sum(1 for it in self.queue
                   if qos_class(getattr(it, "intent", Intent.INSIGHT))
                   == cls)

    def __len__(self) -> int:
        return len(self.queue)

    def snapshot(self) -> List[Any]:
        return list(self.queue)

    def enqueue(self, item, now: float) -> Optional[str]:
        self.queue.append(item)
        return None

    def pop_next(self, now: float):
        return self.queue.popleft() if self.queue else None

    def requeue_preempted(self, item, now: float) -> None:
        self.queue.appendleft(item)

    def remove(self, seq_id: int) -> bool:
        for i, it in enumerate(self.queue):
            if it.seq_id == seq_id:
                del self.queue[i]
                return True
        return False


class QoSScheduler(_SchedulerBase):
    """Intent-aware QoS: per-class queues, strict priority bands,
    stride/deficit weighted-fair arbitration, token-bucket rate limits
    per operator, bounded queues, and preemption picking.

    ``rate_per_s``/``burst`` set a default per-operator limit (None
    disables); ``rate_overrides`` maps operator_id -> (rate, burst).
    ``max_queue`` bounds each class queue (None = unbounded).
    """

    def __init__(self,
                 weights: Optional[Dict[str, float]] = None,
                 max_queue: Optional[int] = None,
                 rate_per_s: Optional[float] = None,
                 burst: Optional[float] = None,
                 rate_overrides: Optional[
                     Dict[str, Tuple[float, float]]] = None,
                 preempt: bool = True,
                 preempt_slack_s: float = 0.25,
                 latency_patience_s: float = 0.5,
                 max_resumes: int = 2):
        super().__init__()
        self.weights = dict(weights or {QOS_LATENCY: 2.0,
                                        QOS_THROUGHPUT: 1.0})
        for cls in QOS_CLASSES:
            if self.weights.get(cls, 0.0) <= 0.0:
                raise ValueError(f"weight for {cls!r} must be positive")
        self.max_queue = max_queue
        self.rate_per_s = rate_per_s
        self.burst = burst if burst is not None else (
            2.0 * rate_per_s if rate_per_s else 1.0)
        self.rate_overrides = dict(rate_overrides or {})
        self.preempt = preempt
        self.preempt_slack_s = float(preempt_slack_s)
        self.latency_patience_s = float(latency_patience_s)
        self.max_resumes = int(max_resumes)
        self._queues: Dict[str, List[Any]] = {c: [] for c in QOS_CLASSES}
        # stride accounting: pass counter per class, +1/weight per pop
        self._pass: Dict[str, float] = {c: 0.0 for c in QOS_CLASSES}

    def _fresh(self) -> "QoSScheduler":
        return QoSScheduler(
            weights=self.weights, max_queue=self.max_queue,
            rate_per_s=self.rate_per_s, burst=self.burst,
            rate_overrides=self.rate_overrides, preempt=self.preempt,
            preempt_slack_s=self.preempt_slack_s,
            latency_patience_s=self.latency_patience_s,
            max_resumes=self.max_resumes)

    def _class_depth(self, cls: str) -> int:
        return len(self._queues[cls])

    def snapshot(self) -> List[Any]:
        return [it for c in QOS_CLASSES for it in self._queues[c]]

    # -- rate limiting (engine front door) --

    def admission_check(self, operator_id: str,
                        now: float) -> Optional[str]:
        rate = self.rate_overrides.get(operator_id,
                                       (self.rate_per_s, self.burst))
        if rate[0] is None:
            return None
        bucket = self._buckets.get(operator_id)
        if bucket is None:
            bucket = self._buckets[operator_id] = _TokenBucket(
                rate_per_s=float(rate[0]), burst=float(rate[1]),
                tokens=float(rate[1]), t_last=now)
        if bucket.take(now):
            return None
        self.telemetry.rejected_rate_limit += 1
        return "rate_limit"

    # -- queueing --

    def enqueue(self, item, now: float) -> Optional[str]:
        cls = qos_class(item.intent)
        q = self._queues[cls]
        if self.max_queue is not None and len(q) >= self.max_queue:
            self.telemetry.rejected_queue_full += 1
            return "queue_full"
        if not q:
            self._catch_up(cls)
        q.append(item)
        return None

    def _catch_up(self, cls: str) -> None:
        """A class returning from idle must not spend credit banked
        while empty: lift its pass counter to the backlog floor."""
        others = [self._pass[c] for c in QOS_CLASSES
                  if c is not cls and self._queues[c]]
        if others:
            self._pass[cls] = max(self._pass[cls], min(others))

    def pop_next(self, now: float):
        cands = [c for c in QOS_CLASSES if self._queues[c]]
        if not cands:
            return None
        # strict priority: only classes holding the top band compete
        head = {c: max(it.priority for it in self._queues[c])
                for c in cands}
        band = max(head.values())
        band_cands = [c for c in cands if head[c] == band]
        cls = min(band_cands,
                  key=lambda c: (self._pass[c], QOS_CLASSES.index(c)))
        self._pass[cls] += 1.0 / self.weights[cls]
        q = self._queues[cls]
        idx = next(i for i, it in enumerate(q) if it.priority == band)
        return q.pop(idx)

    def requeue_preempted(self, item, now: float) -> None:
        """A parked victim has seniority: front of its class queue
        (priority order at pop still holds — same-priority FIFO just
        resumes it first)."""
        cls = qos_class(item.intent)
        if not self._queues[cls]:
            self._catch_up(cls)
        self._queues[cls].insert(0, item)

    def remove(self, seq_id: int) -> bool:
        for q in self._queues.values():
            for i, it in enumerate(q):
                if it.seq_id == seq_id:
                    del q[i]
                    return True
        return False

    # -- preemption --

    def _urgent(self, item, cls: str, now: float) -> bool:
        if item.deadline is not None \
                and now + self.preempt_slack_s >= item.deadline:
            return True
        waited = now - item.t_enqueue
        if cls is QOS_LATENCY and waited >= self.latency_patience_s:
            return True
        return item.priority > 0 and waited >= self.latency_patience_s

    def pick_preemption(self, active: Dict[int, Any],
                        now: float) -> Optional[Tuple[Any, int]]:
        """The most urgent pending request may evict the lowest-ranked
        active decode — only one ranked *strictly* below it, never one
        already parked ``max_resumes`` times. Pops the item from its
        queue on success (the caller admits it into the freed slot)."""
        if not self.preempt or not active:
            return None
        best = None          # (rank, waited, cls, index)
        for cls in QOS_CLASSES:
            for i, item in enumerate(self._queues[cls]):
                if not self._urgent(item, cls, now):
                    continue
                key = (_rank(item.intent, item.priority),
                       now - item.t_enqueue)
                if best is None or key > best[0]:
                    best = (key, cls, i)
        if best is None:
            return None
        (rank, _), cls, idx = best
        victim = None        # (rank, tokens_done, slot)
        for slot, st in active.items():
            vr = _rank(st.req.intent, st.req.priority)
            if vr >= rank or st.req.resumes >= self.max_resumes:
                continue
            key = (vr, len(st.tokens))
            if victim is None or key < victim[0]:
                victim = (key, slot)
        if victim is None:
            return None
        return self._queues[cls].pop(idx), victim[1]
