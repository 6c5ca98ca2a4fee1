"""Chaos injection for the serving path (port of
``repro/engine/faults.py``): deterministic, seeded faults on the
transport and on the cloud executor stages. Host-only: numpy and the
standard library.

AVERY's premise is survival under the unstable networks endemic to
disaster zones, so the fault model must be *drivable*: every failure the
engine claims to tolerate needs a switch that produces it on demand,
over any transport (a ``LoopbackTransport`` in a unit test, not just a
hand-built bandwidth trace), reproducibly (seeded — same schedule, same
faults), and observably (per-fault telemetry).

Two wrappers ship:

  * ``FaultInjector`` — wraps any ``Transport``. Scheduled **blackout
    windows** fail sends outright (``delivered=False`` with ``end_s`` at
    the window's end, the natural retry resume point), scheduled
    **latency-spike windows** delay delivery past a deadline without
    failing it, seeded Bernoulli **packet drops** model loss the sender
    can't predict, and **bandwidth-sense lies** feed the controller's
    Sense stage a wrong number inside chosen windows (the self-awareness
    loop acting on bad telemetry — the hardest fault to excuse).
  * ``FaultyExecutor`` — wraps a ``DualStreamExecutor`` and raises ``CloudStageError`` on chosen cloud stages
    mid-decode, by per-stage call index (``fail_at``) or a seeded rate
    (``p_fail``). Faults raise *before* delegating, so the wrapped
    executor, the KV pool, and the prefix store are never half-updated:
    a retried request re-admits against intact state.

The engine's fault tolerance (``RetryPolicy`` backoff + tier downshift,
per-request deadlines, ``InflightDecoder.cancel``) is exercised against
these wrappers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.packets import Packet
from repro_torch.engine.transport import Transport
from repro_torch.network.channel import TransmitRecord


class CloudStageError(RuntimeError):
    """A cloud serving stage failed mid-request (injected by
    ``FaultyExecutor``, or raised by a real backend). The in-flight
    decoder converts it into per-request ``cloud_error`` failures with
    pages released refcount-safely; the engine's ``RetryPolicy`` decides
    whether to re-run the request."""


@dataclass
class FaultInjector:
    """Deterministic fault-injecting ``Transport`` wrapper.

    Scheduled faults are half-open mission-time windows ``[start, end)``
    matched against the send time; random faults draw from one seeded
    stream in send order, so an identical request sequence sees an
    identical fault sequence (the chaos-determinism contract).

    ``blackouts``   — windows where every send fails (``delivered=False``,
                      ``end_s`` = window end: the link's comeback time).
    ``spikes``      — ``(start, end, extra_s)`` windows where delivered
                      sends arrive ``extra_s`` late (deadline killer).
    ``drop_rate``   — seeded Bernoulli per-send packet loss.
    ``sense_lies``  — ``(start, end, mbps)`` windows where ``bandwidth``
                      reports ``mbps`` instead of the truth, so the
                      controller Selects on bad telemetry.
    ``recorder``    — optional ``FlightRecorder``-compatible sink: every
                      injected fault is recorded as an engine event, so
                      a post-mortem flight dump shows the faults
                      interleaved with the lifecycle they broke.
    """
    inner: Transport
    seed: int = 0
    blackouts: Sequence[Tuple[float, float]] = ()
    spikes: Sequence[Tuple[float, float, float]] = ()
    drop_rate: float = 0.0
    sense_lies: Sequence[Tuple[float, float, float]] = ()
    recorder: Optional[Any] = None
    n_sends: int = 0
    n_blackout_failures: int = 0
    n_drops: int = 0
    n_spiked: int = 0
    n_sense_lies: int = 0

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)

    # ---- Transport protocol ----

    def bandwidth(self, t: float) -> float:
        for lo, hi, mbps in self.sense_lies:
            if lo <= t < hi:
                self.n_sense_lies += 1
                return float(mbps)
        return self.inner.bandwidth(t)

    def send(self, packet: Packet, t: float) -> TransmitRecord:
        self.n_sends += 1
        end = self._blackout_end(t)
        if end is not None:
            self.n_blackout_failures += 1
            self._note("fault_blackout", t, packet, until=end)
            return TransmitRecord(packet=packet, start_s=t, end_s=end,
                                  delivered=False)
        # one draw per non-blackout send keeps the stream aligned with
        # the send sequence whatever the drop rate is
        if self._rng.rand() < self.drop_rate:
            self.n_drops += 1
            self._note("fault_drop", t, packet)
            return TransmitRecord(packet=packet, start_s=t, end_s=t,
                                  delivered=False)
        rec = self.inner.send(packet, t)
        if rec.delivered:
            extra = sum(e for lo, hi, e in self.spikes if lo <= t < hi)
            if extra:
                self.n_spiked += 1
                self._note("fault_spike", t, packet, extra_s=extra)
                rec = TransmitRecord(packet=rec.packet, start_s=rec.start_s,
                                     end_s=rec.end_s + extra,
                                     delivered=True)
        return rec

    def _note(self, kind: str, t: float, packet: Packet,
              **data: Any) -> None:
        if self.recorder is not None:
            self.recorder.record(kind, t, request_id=packet.seq_id,
                                 data=data)

    # ---- schedule / telemetry ----

    def _blackout_end(self, t: float) -> Optional[float]:
        ends = [hi for lo, hi in self.blackouts if lo <= t < hi]
        return max(ends) if ends else None

    @property
    def records(self):
        return getattr(self.inner, "records", [])

    @property
    def records_dropped(self) -> int:
        return getattr(self.inner, "records_dropped", 0)

    def stats(self) -> Dict[str, float]:
        return {
            "fault_sends": self.n_sends,
            "fault_blackout_failures": self.n_blackout_failures,
            "fault_drops": self.n_drops,
            "fault_spiked": self.n_spiked,
            "fault_sense_lies": self.n_sense_lies,
        }


# the in-flight serving stages a FaultyExecutor can fail; edge stages
# and plain attributes delegate untouched
FAULTABLE_STAGES = ("cloud_prefix", "pool_write", "cloud_sam_feats",
                    "cloud_decode_rows", "cloud_verify_rows", "cloud_mask")


class FaultyExecutor:
    """Fault-injecting executor wrapper: raises ``CloudStageError`` on
    chosen cloud stages, *before* delegating to the wrapped executor, so
    no fault ever leaves the executor/pool half-updated.

    ``fail_at``  — ``{stage: iterable of 0-based call indices}`` that
                   raise (the deterministic chaos schedule).
    ``p_fail``   — seeded Bernoulli failure rate applied to every stage
                   in ``stages`` on calls not already planned.
    """

    def __init__(self, inner: Any,
                 fail_at: Optional[Dict[str, Sequence[int]]] = None,
                 p_fail: float = 0.0, seed: int = 0,
                 stages: Sequence[str] = FAULTABLE_STAGES):
        unknown = set(fail_at or ()) - set(FAULTABLE_STAGES)
        if unknown:
            raise ValueError(
                f"unknown faultable stages {sorted(unknown)}; choose from "
                f"{FAULTABLE_STAGES}")
        self._inner = inner
        self._fail_at = {k: set(v) for k, v in (fail_at or {}).items()}
        self._p_fail = float(p_fail)
        self._stages = tuple(stages)
        self._rng = np.random.RandomState(seed)
        self.calls: Dict[str, int] = {s: 0 for s in FAULTABLE_STAGES}
        self.n_faults = 0

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    def _gate(self, stage: str) -> None:
        i, self.calls[stage] = self.calls[stage], self.calls[stage] + 1
        hit = i in self._fail_at.get(stage, ())
        if not hit and self._p_fail and stage in self._stages:
            hit = bool(self._rng.rand() < self._p_fail)
        if hit:
            self.n_faults += 1
            raise CloudStageError(f"injected fault: {stage} call {i}")

    # ---- faultable in-flight stages ----

    def cloud_prefix(self, *a, **kw):
        self._gate("cloud_prefix")
        return self._inner.cloud_prefix(*a, **kw)

    def pool_write(self, *a, **kw):
        self._gate("pool_write")
        return self._inner.pool_write(*a, **kw)

    def cloud_sam_feats(self, *a, **kw):
        self._gate("cloud_sam_feats")
        return self._inner.cloud_sam_feats(*a, **kw)

    def cloud_decode_rows(self, *a, **kw):
        self._gate("cloud_decode_rows")
        return self._inner.cloud_decode_rows(*a, **kw)

    def cloud_verify_rows(self, *a, **kw):
        self._gate("cloud_verify_rows")
        return self._inner.cloud_verify_rows(*a, **kw)

    def cloud_mask(self, *a, **kw):
        self._gate("cloud_mask")
        return self._inner.cloud_mask(*a, **kw)
