"""Typed request/response surface of the AVERY engine (host copy of
``repro/engine/api.py``).

Every way into the system — the serving launcher, the mission simulator,
the fleet runtime, benchmarks — speaks these types. A ``Request`` is one
operator utterance (prompt + optional frame + tokenised query) at a
point in mission time; the engine classifies its intent, selects a tier
through the active ``ControlPolicy``, moves the packet over the active
``Transport``, and serves it on the cloud executor. The ``Response``
carries the semantic product (answer logits / mask / generated tokens)
plus the timing, energy, and batching telemetry the runtimes and
benchmarks report. ``StreamEvent``s record the request's lifecycle for
observability and tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.intent import Intent


@dataclass
class Request:
    """One operator utterance submitted to the engine."""
    prompt: str = ""
    intent: Optional[Intent] = None    # None -> classified from the prompt
    images: Optional[Any] = None       # edge frame(s) (real serving path)
    query: Optional[np.ndarray] = None  # (B, L) tokenised model query
    time_s: float = 0.0                # mission-clock submission time
    # scheduling: strict-priority override (0 = normal; higher admits
    # first and may preempt lower-ranked active decodes — see
    # engine/scheduler.py)
    priority: int = 0
    # filled in by the engine
    request_id: int = -1
    operator_id: str = ""


@dataclass
class StreamEvent:
    """Lifecycle marker: queued, tier_selected, transmitted, blackout,
    prefilled, joined_batch, served, infeasible, retry, cloud_error,
    cancelled, rejected. ``t`` is mission time: emit sites that pass no
    timestamp get the engine's mission-clock watermark stamped in, so a
    response's event stream is always orderable."""
    kind: str
    t: float = 0.0
    data: Dict[str, Any] = field(default_factory=dict)


# cap on a single request's event stream: retries and preemption round-
# trips multiply events, and a future that lives a whole mission must
# not accumulate them without bound (averylint AV602's contract)
MAX_STREAM_EVENTS = 256


@dataclass
class Response:
    request_id: int
    operator_id: str
    intent: Intent
    tier_name: Optional[str] = None    # None for Context-stream requests
    feasible: bool = True              # Algorithm-1 feasibility verdict
    # terminal failure taxonomy — exactly one of:
    #   None          served (the semantic product is present)
    #   "blackout"    every transmission attempt died on the uplink
    #   "deadline"    cancelled past IntentRequirements.max_latency_s
    #   "infeasible"  no admissible tier (strict policy idles the frame)
    #   "cloud_error" a cloud serving stage failed and retries ran out
    #   "rejected"    shed by admission control (operator over its rate
    #                 limit, or the scheduler's bounded queue was full)
    # ``feasible`` keeps its pre-failure-taxonomy semantics (False on
    # every failed response, and on served best-effort starved frames).
    failure: Optional[str] = None
    attempts: int = 1                  # transmission attempts (1 = no retry)
    # semantic products
    answer_logits: Optional[np.ndarray] = None
    mask_logits: Optional[np.ndarray] = None
    tokens: Optional[np.ndarray] = None
    iou: Optional[float] = None        # profiled-mode fidelity measurement
    # timing / energy / batching telemetry
    t_submit: float = 0.0
    t_delivered: float = 0.0           # packet delivery on the uplink
    edge_compute_s: float = 0.0
    edge_energy_j: float = 0.0
    # device batch this request rode in: the microbatch size, or (in-
    # flight path) the fractional mean of co-active slots over its steps
    batch_size: float = 1.0
    joined_step: Optional[int] = None  # in-flight: decode step it joined at
    # in-flight: whether the [ctx; query] prefix was served from the
    # shared prefix store (no prefill paid) — None outside that path
    prefix_hit: Optional[bool] = None
    # in-flight: whether this request decoded speculatively (Context-
    # stream drafts + paged multi-token verify) — None outside that path
    speculative: Optional[bool] = None
    # scheduling telemetry (in-flight path): total time queued before
    # admission (summed across preemption round-trips), times this
    # request was preempted-and-parked, and the mission-clock watermark
    # at resolution — (t_finished - t_submit) is the end-to-end latency
    # the fleet-storm bench reports per QoS class
    queue_wait_s: Optional[float] = None
    preemptions: int = 0
    t_finished: Optional[float] = None
    # in-flight path: time-to-first-token — admission (prefill or prefix
    # hit, when token 0 exists) minus submission, on the mission clock;
    # preemption round-trips don't move it (the first token stands)
    ttft_s: Optional[float] = None
    # cost/energy ledger of a profiled engine: analytic cloud FLOPs/HBM
    # bytes attributed to this request's prefill + decode steps, and the
    # joules they imply. The port's engine takes no profiler yet, so
    # these stay None.
    cloud_flops: Optional[float] = None
    cloud_hbm_bytes: Optional[float] = None
    cloud_energy_j: Optional[float] = None
    events: List[StreamEvent] = field(default_factory=list)

    @property
    def latency_s(self) -> float:
        return self.t_delivered - self.t_submit


class RequestFuture:
    """Handle for an in-flight request. ``result()`` drives the owning
    engine until the request is served (joining any running decode batch
    on the way), so callers can fire-and-collect without hand-managing
    the scheduler."""

    def __init__(self, request: Request, engine: "Any"):
        self.request = request
        self._engine = engine
        self._response: Optional[Response] = None
        self.events: List[StreamEvent] = []
        self.events_dropped = 0
        # engine-side bookkeeping: decision/rec of the latest attempt,
        # owning session, absolute deadline (None = no SLO)
        self.meta: Dict[str, Any] = {}
        self.attempts = 0

    def emit(self, kind: str, t: Optional[float] = None,
             **data: Any) -> None:
        """Record one lifecycle event. ``t=None`` stamps the engine's
        mission-clock watermark; every emit also feeds the engine's
        observability hook (flight recorder + tracer point events)."""
        if t is None:
            t = getattr(self._engine, "_now", 0.0)
        if len(self.events) < MAX_STREAM_EVENTS:
            self.events.append(StreamEvent(kind=kind, t=t, data=data))
        else:
            self.events_dropped += 1
        observe = getattr(self._engine, "_observe_event", None)
        if observe is not None:
            observe(self.request, kind, t, data)

    def done(self) -> bool:
        return self._response is not None

    def set_result(self, response: Response) -> None:
        response.events = self.events
        self._response = response

    def result(self) -> Response:
        if self._response is None:
            self._engine.drain()
        assert self._response is not None, "engine.drain() left request open"
        return self._response
