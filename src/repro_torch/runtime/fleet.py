"""Multi-UAV fleet simulation (port of ``repro/runtime/fleet.py``;
beyond-paper; the paper's §6 future-work
item: "extending the framework to multi-UAV coordination ... whether
intent-driven semantic adaptation remains beneficial at larger system
scale").

Model: N UAVs share one uplink cell. The scheduler grants each UAV an
equal bandwidth share (B_t / N); each UAV is an ``OperatorSession`` on
one shared ``AveryEngine`` — its own ``ChannelTransport`` over the
share, its own controller policy — while the cloud executor, fidelity
oracle, and telemetry are engine-level and shared. This is the
conservative fair-share model — no cross-UAV coordination — so it
lower-bounds what a coordinating controller could do, and directly
answers the paper's question: adaptive tiering degrades gracefully with
fleet size while static tiers fall off a feasibility cliff.

The fleet loop is arrival-ordered: a heap merges the N per-UAV capture
clocks so frames hit the shared engine's admission path (scheduler
admission checks, rate limits, per-operator accounting) in mission-clock
order — the scheduler sees a fleet, not N sequential missions. Each
frame itself goes through ``mission_step``, the same code path
``run_mission`` drives, so fleet numbers and single-mission numbers
share per-frame semantics exactly."""
from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

from repro_torch.core.lut import SystemLUT
from repro_torch.engine import AveryEngine
from repro_torch.network.traces import BandwidthTrace
from repro_torch.runtime.mission import (FidelityOracle, MissionLog,
                                         MissionSpec, mission_session,
                                         mission_step)


@dataclass
class FleetResult:
    n_uavs: int
    logs: List[MissionLog]
    # shared-engine telemetry snapshot at drain (scheduler counters,
    # per-operator served counts, rejections)
    stats: Dict[str, Any] = field(default_factory=dict)

    @property
    def aggregate_pps(self) -> float:
        return sum(l.mean_pps for l in self.logs)

    @property
    def mean_iou(self) -> float:
        vals = [l.mean_iou for l in self.logs if l.frames]
        return float(np.mean(vals)) if vals else 0.0

    @property
    def infeasible_frac(self) -> float:
        total = sum(l.spec.duration_s for l in self.logs)
        return sum(l.infeasible_s for l in self.logs) / max(1.0, total)


def run_fleet(lut: SystemLUT, trace: BandwidthTrace, n_uavs: int,
              spec: MissionSpec, executor=None) -> FleetResult:
    """Equal-share scheduler: each UAV sees trace/N.

    All N UAV sessions ride one ``AveryEngine``. With ``executor``
    per-frame fidelity comes from real lisa-mini inference on the shared
    cloud executor: every session reports into one ``FidelityOracle``
    whose evaluation pool and per-(tier, scene) measurements are built
    once and memoised, so fleet cost does not scale with N on the cloud
    side. Without one, each UAV keeps its own oracle (per-seed scene
    variation), matching ``run_mission`` run N times."""
    share = BandwidthTrace(trace.samples / n_uavs,
                           name=f"{trace.name}/share{n_uavs}")
    engine = AveryEngine(lut=lut, executor=executor)
    shared_oracle = (FidelityOracle(lut, spec, executor=executor)
                     if executor is not None else None)
    sessions = []
    logs: List[MissionLog] = []
    for i in range(n_uavs):
        s = dataclasses.replace(spec, seed=spec.seed + 101 * i)
        oracle = (shared_oracle if shared_oracle is not None
                  else FidelityOracle(lut, s))
        sessions.append(mission_session(engine, share, s, oracle))
        logs.append(MissionLog(spec=s))
    # arrival-ordered merge: always step the UAV whose next capture is
    # earliest, so the shared admission path sees one interleaved
    # mission-clock stream
    heap = [(0.0, i) for i in range(n_uavs)]
    heapq.heapify(heap)
    steps = [0] * n_uavs
    while heap:
        t, i = heapq.heappop(heap)
        if t >= logs[i].spec.duration_s:
            continue
        t_next = mission_step(sessions[i], logs[i], lut, t)
        steps[i] += 1
        if steps[i] > 100_000:
            continue
        heapq.heappush(heap, (t_next, i))
    return FleetResult(n_uavs=n_uavs, logs=logs, stats=dict(engine.stats))
