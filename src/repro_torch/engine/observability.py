"""Engine observability (port of ``repro/engine/observability.py``):
the per-request span :class:`Tracer`, host-only and on the mission clock.

The tracer records lifecycle spans (``queue -> prefill|prefix_hit ->
decode``, segmented across preemptions) and point events
(``decode_step``, ``park``/``resume``) and exports them as Chrome/Perfetto
``trace_event`` JSON. Disabled (the default) every hook is one attribute
check. The metrics registry, the flight recorder and the trace validators
come with the engine front door (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


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
