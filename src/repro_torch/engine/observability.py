"""Engine observability (port of ``repro/engine/observability.py``):
span tracing, a metrics registry, a flight recorder.

Three instruments, all host-only (the standard library alone) and all on
the **mission clock** (no wall-clock reads; wall timings come from a
caller-injected ``wallclock``):

  * :class:`Tracer` — per-request lifecycle spans
    (``edge_encode -> transmit -> queue -> prefill|prefix_hit ->
    decode``, segmented across preemptions) plus point events
    (``decode_step``/``verify_step``, ``park``/``resume``, ``retry``,
    ``blackout``, ``cancelled``, ...), exportable as Chrome/Perfetto
    ``trace_event`` JSON (one track per operator, one per decode slot).
    Disabled (the default) every hook is a single attribute check; the
    engine guards each call site with ``if tracer.enabled`` so an
    untraced serve records nothing and allocates nothing.
  * :class:`MetricsRegistry` — typed :class:`Counter` / :class:`Gauge` /
    :class:`Histogram`. Histograms use fixed log-spaced buckets with
    percentile estimates read off the bucket edges: O(1) observe, O(1)
    memory, no unbounded sample lists.
  * :class:`FlightRecorder` — a bounded ring of the last N engine
    events that dumps to JSON when something dies (``CloudStageError``
    exhausting retries, a deadline cancellation, a ``PagePool``
    invariant failure), so chaos failures become diagnosable artifacts
    instead of bare asserts.

``validate_trace`` / ``validate_chrome_trace`` check the span-model
invariants (ordered, non-overlapping phase spans; park/resume pairing;
cancel events terminal) against live tracers and dumped artifacts alike.
"""
from __future__ import annotations

import json
import math
import os
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# phase spans a request may record, in lifecycle order (validation
# vocabulary; point events are open-ended)
PHASE_SPANS = ("edge_encode", "transmit", "queue", "prefill",
               "prefix_hit", "decode")
# Chrome-export track families: pid 1 = operators, pid 2 = decode
# slots, pid 3 = device stages (the stage profiler's wall-clock view,
# engine.profiler)
DEVICE_TRACK_PID = 3
_EPS = 1e-9


# ---------------------------------------------------------------------------
# span tracing
# ---------------------------------------------------------------------------


@dataclass
class Span:
    """One interval (or instant, ``t0 == t1``) on a request's timeline,
    in mission seconds."""
    name: str
    t0: float
    t1: float
    slot: Optional[int] = None        # decode slot, when bound to one
    args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class RequestTrace:
    """Everything recorded for one request: phase spans (non-
    overlapping lifecycle intervals) and point events (instants)."""
    request_id: int
    operator_id: str = ""
    intent: str = ""
    t_begin: float = 0.0
    spans: List[Span] = field(default_factory=list)
    points: List[Span] = field(default_factory=list)
    dropped: int = 0                  # events shed past the per-trace cap


class Tracer:
    """Near-zero-overhead span recorder keyed by request id.

    ``enabled=False`` (the default) makes every method an immediate
    return; call sites on hot paths additionally guard with
    ``if tracer.enabled`` so a disabled tracer costs one branch and
    leaves zero residue. ``max_requests`` caps live traces (oldest
    evicted first); ``max_events`` caps spans+points per trace.
    """

    def __init__(self, enabled: bool = False, max_requests: int = 4096,
                 max_events: int = 512):
        self.enabled = bool(enabled)
        self.max_requests = int(max_requests)
        self.max_events = int(max_events)
        self._traces: Dict[int, RequestTrace] = {}
        self.n_evicted = 0

    def __len__(self) -> int:
        return len(self._traces)

    def clear(self) -> None:
        self._traces = {}
        self.n_evicted = 0

    def _get(self, rid: int) -> RequestTrace:
        tr = self._traces.get(rid)
        if tr is None:
            tr = self._traces[rid] = RequestTrace(request_id=int(rid))
            if len(self._traces) > self.max_requests:
                oldest = next(iter(self._traces))
                del self._traces[oldest]
                self.n_evicted += 1
        return tr

    def begin(self, rid: int, operator_id: str = "", intent: str = "",
              t: float = 0.0) -> None:
        """Open a trace at submission time (idempotent)."""
        if not self.enabled:
            return
        tr = self._get(rid)
        tr.operator_id = operator_id
        tr.intent = str(intent)
        tr.t_begin = t

    def span(self, rid: int, name: str, t0: float, t1: float,
             slot: Optional[int] = None, **args: Any) -> None:
        """Record one phase span ``[t0, t1]``."""
        if not self.enabled:
            return
        tr = self._get(rid)
        if len(tr.spans) + len(tr.points) >= self.max_events:
            tr.dropped += 1
            return
        tr.spans.append(Span(name, t0, t1, slot=slot, args=args))

    def point(self, rid: int, name: str, t: float,
              slot: Optional[int] = None, **args: Any) -> None:
        """Record one instant event at ``t``."""
        if not self.enabled:
            return
        tr = self._get(rid)
        if len(tr.spans) + len(tr.points) >= self.max_events:
            tr.dropped += 1
            return
        tr.points.append(Span(name, t, t, slot=slot, args=args))

    def trace(self, rid: int) -> Optional[RequestTrace]:
        return self._traces.get(rid)

    def traces(self) -> List[RequestTrace]:
        return list(self._traces.values())

    # -- Chrome/Perfetto trace_event export --

    def to_chrome(self) -> Dict[str, Any]:
        """Export every trace as a Chrome ``trace_event`` JSON document
        (open in Perfetto / ``chrome://tracing``). Track layout: pid 1
        holds one thread per operator (the request-lifecycle view),
        pid 2 one thread per decode slot (the batch-residency view).
        Timestamps are mission seconds scaled to microseconds."""
        events: List[Dict[str, Any]] = []
        operators: Dict[str, int] = {}
        slots: Dict[int, int] = {}
        for tr in self._traces.values():
            op = tr.operator_id or "?"
            tid = operators.setdefault(op, len(operators) + 1)
            for sp in tr.spans:
                events.append(_chrome_span(sp, tr, pid=1, tid=tid,
                                           ph="X"))
                if sp.slot is not None:
                    stid = slots.setdefault(sp.slot, sp.slot + 1)
                    events.append(_chrome_span(sp, tr, pid=2, tid=stid,
                                               ph="X"))
            for pt in tr.points:
                events.append(_chrome_span(pt, tr, pid=1, tid=tid,
                                           ph="i"))
                if pt.slot is not None:
                    stid = slots.setdefault(pt.slot, pt.slot + 1)
                    events.append(_chrome_span(pt, tr, pid=2, tid=stid,
                                               ph="i"))
        meta = [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "args": {"name": "operators"}},
            {"ph": "M", "name": "process_name", "pid": 2, "tid": 0,
             "args": {"name": "decode slots"}},
        ]
        for op in sorted(operators):
            meta.append({"ph": "M", "name": "thread_name", "pid": 1,
                         "tid": operators[op], "args": {"name": op}})
        for s in sorted(slots):
            meta.append({"ph": "M", "name": "thread_name", "pid": 2,
                         "tid": slots[s], "args": {"name": f"slot {s}"}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        doc = self.to_chrome()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def _chrome_span(sp: Span, tr: RequestTrace, pid: int, tid: int,
                 ph: str) -> Dict[str, Any]:
    args = {"rid": tr.request_id, "intent": tr.intent}
    args.update(sp.args)
    ev: Dict[str, Any] = {"name": sp.name, "cat": "phase" if ph == "X"
                          else "event", "ph": ph, "pid": pid, "tid": tid,
                          "ts": sp.t0 * 1e6, "args": args}
    if ph == "X":
        ev["dur"] = max(0.0, sp.t1 - sp.t0) * 1e6
    else:
        ev["s"] = "t"
    return ev


# ---------------------------------------------------------------------------
# trace validation (the span-model invariants)
# ---------------------------------------------------------------------------


def validate_trace(tr: RequestTrace) -> List[str]:
    """Check one trace against the span-model invariants. Returns a
    list of problem descriptions (empty = valid):

      * every span has ``t1 >= t0``;
      * phase spans are recorded in monotonically ordered, non-
        overlapping lifecycle order (``next.t0 >= prev.t1``);
      * phase-span names come from :data:`PHASE_SPANS`;
      * ``resume`` events never outnumber ``park`` events, and a served
        request's parks are all resumed;
      * a ``cancelled`` point, if present, is the trace's last point.
    """
    problems: List[str] = []
    rid = tr.request_id
    prev: Optional[Span] = None
    for sp in tr.spans:
        if sp.name not in PHASE_SPANS:
            problems.append(f"rid {rid}: unknown phase span {sp.name!r}")
        if sp.t1 < sp.t0 - _EPS:
            problems.append(
                f"rid {rid}: span {sp.name} ends before it starts "
                f"({sp.t0} -> {sp.t1})")
        if prev is not None and sp.t0 < prev.t1 - _EPS:
            problems.append(
                f"rid {rid}: span {sp.name}@{sp.t0} overlaps "
                f"{prev.name} ending {prev.t1}")
        prev = sp
    kinds = [pt.name for pt in tr.points]
    n_park = kinds.count("park")
    n_resume = kinds.count("resume")
    if n_resume > n_park:
        problems.append(
            f"rid {rid}: {n_resume} resumes for {n_park} parks")
    if "served" in kinds and n_park != n_resume:
        problems.append(
            f"rid {rid}: served with {n_park} parks but "
            f"{n_resume} resumes")
    if "cancelled" in kinds and kinds[-1] != "cancelled":
        problems.append(
            f"rid {rid}: events continue after the cancel "
            f"(last is {kinds[-1]!r})")
    return problems


def validate_traces(tracer: Tracer) -> List[str]:
    problems: List[str] = []
    for tr in tracer.traces():
        problems.extend(validate_trace(tr))
    return problems


def validate_chrome_trace(doc: Dict[str, Any]) -> List[str]:
    """Validate a dumped ``trace_event`` document: rebuild each
    request's trace from the operator-track events (every event carries
    its ``rid``) and run :func:`validate_trace` over it."""
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["not a trace_event document (no traceEvents list)"]
    rebuilt: Dict[int, RequestTrace] = {}
    for ev in events:
        ph = ev.get("ph")
        if ph in ("X", "i") and ev.get("pid") == DEVICE_TRACK_PID:
            # device-stage events are batch-level (no rid); check the
            # timeline shape instead of the request lifecycle
            if not isinstance(ev.get("ts"), (int, float)):
                return [f"device event {ev.get('name')!r} has no "
                        f"numeric ts"]
            if ph == "X" and float(ev.get("dur", 0.0)) < 0.0:
                return [f"device span {ev.get('name')!r} has negative "
                        f"dur"]
            continue
        if ph not in ("X", "i") or ev.get("pid") != 1:
            continue
        rid = ev.get("args", {}).get("rid")
        if rid is None:
            return [f"event {ev.get('name')!r} carries no args.rid"]
        tr = rebuilt.setdefault(int(rid), RequestTrace(request_id=rid))
        t0 = float(ev["ts"]) / 1e6
        if ph == "X":
            tr.spans.append(Span(ev["name"], t0,
                                 t0 + float(ev.get("dur", 0.0)) / 1e6))
        else:
            tr.points.append(Span(ev["name"], t0, t0))
    if not rebuilt:
        return ["trace holds no request events"]
    problems: List[str] = []
    for rid in sorted(rebuilt):
        problems.extend(validate_trace(rebuilt[rid]))
    return problems


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


class Counter:
    """Monotone event count."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written level (queue depth, live slots)."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed log-bucket latency histogram: O(1) observe, O(1) memory,
    percentiles estimated from bucket upper edges and clamped to the
    observed [min, max] (exact at the extremes, one-bucket-resolution
    in between). Buckets span ``[lo, hi)`` with ``per_decade`` buckets
    per decade, plus an underflow and an overflow bucket."""

    def __init__(self, name: str, lo: float = 1e-4, hi: float = 1e4,
                 per_decade: int = 8):
        if lo <= 0 or hi <= lo:
            raise ValueError(f"need 0 < lo < hi, got [{lo}, {hi}]")
        self.name = name
        self.lo = float(lo)
        self.per_decade = int(per_decade)
        n = int(math.ceil(math.log10(hi / lo) * per_decade))
        # bucket i (1-indexed) holds values in (edge[i-1], edge[i]]
        self.edges = [lo * 10.0 ** (i / per_decade)
                      for i in range(1, n + 1)]
        self.counts = [0] * (n + 2)   # [underflow, buckets..., overflow]
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= self.lo:
            self.counts[0] += 1
            return
        idx = int(math.log10(v / self.lo) * self.per_decade) + 1
        if idx > len(self.edges):
            idx = len(self.edges) + 1
        elif v > self.edges[idx - 1]:   # float fuzz at a bucket edge
            idx += 1
        self.counts[idx] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (0..100) from the bucket edges;
        0.0 on an empty histogram."""
        if not self.count:
            return 0.0
        target = max(1, int(math.ceil(self.count * q / 100.0)))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                if i == 0:
                    edge = self.lo
                elif i > len(self.edges):
                    edge = self.vmax
                else:
                    edge = self.edges[i - 1]
                return min(max(edge, self.vmin), self.vmax)
        return self.vmax

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    def as_dict(self) -> Dict[str, float]:
        return {"count": self.count, "mean": self.mean,
                "p50": self.p50, "p95": self.p95, "p99": self.p99,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0}

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s observations into this histogram (bucket
        counts add; min/max widen). Both must share the same bucket
        geometry — merging is what aggregates per-shard or per-decoder
        histograms, and mismatched edges would silently misbin."""
        if (self.lo != other.lo or self.per_decade != other.per_decade
                or len(self.edges) != len(other.edges)):
            raise ValueError(
                f"histogram geometry mismatch: {self.name} "
                f"[lo={self.lo}, n={len(self.edges)}, "
                f"per_decade={self.per_decade}] vs {other.name} "
                f"[lo={other.lo}, n={len(other.edges)}, "
                f"per_decade={other.per_decade}]")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self


class MetricsRegistry:
    """Name-keyed instrument store. Instruments are created on first
    touch and live for the registry's lifetime; names use a
    ``base[:label]`` convention (``ttft_s:latency``,
    ``transmit_s:tier=Balanced``)."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, lo: float = 1e-4, hi: float = 1e4,
                  per_decade: int = 8) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(
                name, lo=lo, hi=hi, per_decade=per_decade)
        return h

    def as_dict(self) -> Dict[str, float]:
        """Flat snapshot of every instrument — the full surface,
        including dynamically labelled histograms (per tier, per
        operator) that ``AveryEngine.stats`` keeps out of its fixed key
        set."""
        out: Dict[str, float] = {}
        for name in sorted(self._counters):
            out[name] = self._counters[name].value
        for name in sorted(self._gauges):
            out[name] = self._gauges[name].value
        for name in sorted(self._histograms):
            for k, v in self._histograms[name].as_dict().items():
                out[f"{name}/{k}"] = v
        return out


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded ring of the engine's last ``capacity`` events. Always
    cheap enough to leave on (a deque append per event); ``dump``
    writes the ring plus context to JSON. With ``autodump_dir`` set the
    engine dumps automatically when a request dies hard (terminal cloud
    error, deadline cancellation) or an invariant trips (page-pool
    audit); dump filenames are derived from the dump
    counter, not the wall clock (mission replay stays deterministic)."""

    def __init__(self, capacity: int = 256,
                 autodump_dir: Optional[str] = None):
        self.capacity = int(capacity)
        self.autodump_dir = autodump_dir
        self._ring: deque = deque(maxlen=self.capacity)
        self.n_recorded = 0
        self.n_dumps = 0
        self.last_dump: Optional[str] = None

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, kind: str, t: float, request_id: int = -1,
               data: Optional[Dict[str, Any]] = None) -> None:
        self._ring.append({"kind": kind, "t": t, "rid": request_id,
                           "data": data or {}})
        self.n_recorded += 1

    def snapshot(self) -> List[Dict[str, Any]]:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def dump(self, reason: str, path: Optional[str] = None,
             stats: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write the ring to ``path`` (or, when None, to
        ``autodump_dir/flight_<n>_<reason>.json``; no-op without a
        directory). Returns the written path."""
        if path is None:
            if self.autodump_dir is None:
                return None
            path = os.path.join(self.autodump_dir,
                                f"flight_{self.n_dumps:03d}_{reason}.json")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        doc = {"reason": reason, "n_recorded": self.n_recorded,
               "capacity": self.capacity, "events": self.snapshot(),
               "stats": _jsonable(stats or {})}
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        self.n_dumps += 1
        self.last_dump = path
        return path


def _jsonable(d: Dict[str, Any]) -> Dict[str, Any]:
    return {str(k): (v if isinstance(v, (int, float, str, bool,
                                         type(None))) else str(v))
            for k, v in d.items()}
