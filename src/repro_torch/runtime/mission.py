"""Closed-loop mission simulator (port of ``repro/runtime/mission.py``) —
the paper's dynamic evaluation (§5.3).

Simulates a UAV streaming the Insight pathway over a fluctuating uplink
for ``duration_s`` (paper: 20 minutes, 8–20 Mbps). The per-frame
pipeline — Sense, tier selection, analytic edge compute (Jetson model at
the DEPLOYMENT geometry), packet transmission, fidelity measurement —
runs inside ``AveryEngine`` (``session.submit_frame``); this module owns
only mission time, the frame log, and the fidelity oracle.

Tier control is a ``ControlPolicy`` on the session: ``AdaptivePolicy``
is AVERY mode, ``StaticTierPolicy`` the §5.3.1 baselines,
``BestEffortPolicy`` the graceful-degradation fleet variant. The old
``mode="avery"|"static"`` / ``fallback=`` knobs still work via
``policy_from_mode`` (deprecation shim).

Frame capture pipelines with transmission (frame k+1 is computed while
packet k is in flight), so steady-state throughput is min(compute rate,
link rate) — matching the paper's PPS accounting.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.controller import MissionGoal
from repro_torch.core.intent import DEFAULT_REQUIREMENTS, Intent
from repro_torch.core.lut import SystemLUT, Tier
from repro_torch.data import floodseg
from repro_torch.engine import (AveryEngine, ChannelTransport,
                                ControlPolicy, policy_from_mode)
# re-exported for compatibility (formulas live with the device models now)
from repro_torch.network.energy import (edge_insight_flops,  # noqa: F401
                                        full_edge_flops)
from repro_torch.network.traces import BandwidthTrace


@dataclass(frozen=True)
class MissionSpec:
    duration_s: float = 1200.0
    goal: MissionGoal = MissionGoal.PRIORITIZE_ACCURACY
    # tier control: pass a ControlPolicy; the mode/static_tier/fallback
    # trio below is the pre-engine interface, mapped via policy_from_mode
    policy: Optional[ControlPolicy] = None
    mode: str = "avery"               # deprecated: "avery" | "static"
    static_tier: Optional[str] = None  # deprecated: tier for mode="static"
    finetuned: bool = False
    min_pps: float = 0.5              # F_I for Insight intents
    seed: int = 0
    # deprecated (use policy=BestEffortPolicy()): when no tier satisfies
    # F_I, transmit the lightest tier best-effort instead of idling
    fallback: bool = False

    def resolve_policy(self) -> ControlPolicy:
        if self.policy is not None:
            return self.policy
        return policy_from_mode(self.mode, self.static_tier, self.fallback)


@dataclass
class FrameResult:
    t_capture: float
    t_delivered: float
    tier: str
    payload_mb: float
    iou: Optional[float]
    edge_energy_j: float

    @property
    def latency_s(self) -> float:
        return self.t_delivered - self.t_capture


@dataclass
class MissionLog:
    spec: MissionSpec
    frames: List[FrameResult] = field(default_factory=list)
    infeasible_s: float = 0.0

    @property
    def mean_pps(self) -> float:
        if not self.frames:
            return 0.0
        return len(self.frames) / self.spec.duration_s

    @property
    def mean_iou(self) -> float:
        vals = [f.iou for f in self.frames if f.iou is not None]
        return float(np.mean(vals)) if vals else 0.0

    @property
    def total_edge_energy_j(self) -> float:
        return sum(f.edge_energy_j for f in self.frames)

    def pps_timeline(self, window_s: float = 60.0) -> np.ndarray:
        n = int(np.ceil(self.spec.duration_s / window_s))
        out = np.zeros(n)
        for f in self.frames:
            out[min(n - 1, int(f.t_delivered / window_s))] += 1
        return out / window_s

    def tier_timeline(self, window_s: float = 60.0) -> List[str]:
        n = int(np.ceil(self.spec.duration_s / window_s))
        buckets: List[List[str]] = [[] for _ in range(n)]
        for f in self.frames:
            buckets[min(n - 1, int(f.t_capture / window_s))].append(f.tier)
        return [max(set(b), key=b.count) if b else "-" for b in buckets]


class FidelityOracle:
    """Per-frame fidelity: real lisa-mini inference (executor mode) or the
    LUT expectation plus per-scene variation (fast mode).

    Executor mode pre-generates a small evaluation pool once (scenes,
    images resident on the executor's device, queries, and one CLIP
    context pass per pooled frame) and cycles through it, instead of
    rebuilding and re-transferring a fresh batch every frame; per-(tier,
    scene) IoUs are memoised since the pipeline is deterministic. It is
    defined for a lisa-mini executor: floodseg scenes are 32 px."""

    POOL_SIZE = 6

    def __init__(self, lut: SystemLUT, spec: MissionSpec, executor=None):
        self.lut = lut
        self.spec = spec
        self.executor = executor
        self.rng = np.random.RandomState(spec.seed + 77)
        self._pool: Optional[list] = None
        self._pool_i = 0
        self._memo: Dict[tuple, float] = {}

    def _ensure_pool(self) -> None:
        if self._pool is not None:
            return
        import torch
        self._pool = []
        for _ in range(self.POOL_SIZE):
            batch = floodseg.make_batch(self.rng, 1, "segment", augment=False)
            images = torch.as_tensor(batch["images"]).to(
                self.executor.device)
            _, ctx = self.executor.edge_context(images, 0, 0.0)
            self._pool.append({
                "images": images,
                "query": batch["query"],
                "mask": batch["mask"],
                "ctx": ctx,
            })

    def measure(self, tier: Tier) -> float:
        if self.executor is not None:
            self._ensure_pool()
            i = self._pool_i % len(self._pool)
            self._pool_i += 1
            key = (tier.name, i)
            if key not in self._memo:
                entry = self._pool[i]
                pkt = self.executor.edge_insight(
                    entry["images"], tier, 0, 0.0, ctx=entry["ctx"])
                mask_logits, _ = self.executor.cloud_insight(
                    pkt, entry["query"])
                pred = (mask_logits[0] > 0).astype(np.float64)
                gt = entry["mask"][0].astype(np.float64)
                inter = (pred * gt).sum()
                union = np.maximum(pred, gt).sum()
                self._memo[key] = float(inter / (union + 1e-6))
            return self._memo[key]
        base = tier.acc_finetuned if self.spec.finetuned else tier.acc_base
        return float(np.clip(base + self.rng.randn() * 0.02, 0.0, 1.0))


def mission_session(engine: AveryEngine, trace: BandwidthTrace,
                    spec: MissionSpec, oracle: FidelityOracle):
    """One UAV's ``OperatorSession`` for a profiled mission: its own
    bandwidth share and controller, the shared engine's cloud side."""
    reqs = DEFAULT_REQUIREMENTS[Intent.INSIGHT]
    if spec.min_pps != reqs.min_update_pps:
        reqs = dataclasses.replace(reqs, min_update_pps=spec.min_pps)
    return engine.session(
        f"uav-{spec.seed}",
        transport=ChannelTransport.from_trace(trace),
        policy=spec.resolve_policy(), goal=spec.goal,
        finetuned=spec.finetuned,
        requirements={**DEFAULT_REQUIREMENTS, Intent.INSIGHT: reqs},
        oracle=oracle)


def mission_step(sess, log: MissionLog, lut: SystemLUT, t: float) -> float:
    """One profiled mission frame at capture time ``t``: submit through
    the engine's admission path, account it on ``log``, and return the
    next capture time (pipelined capture — frame k+1 overlaps packet
    k's transmission). Shared by ``run_mission`` and the fleet loop so
    both drive the exact same per-frame semantics."""
    resp = sess.submit_frame(t)
    if not resp.feasible:
        log.infeasible_s += 1.0
        # a strict policy idles the frame; admission control sheds it
        # (``rejected``) — either way no frame transmits this second
        if resp.tier_name is None:
            return t + 1.0
    log.frames.append(FrameResult(
        t_capture=t, t_delivered=resp.t_delivered, tier=resp.tier_name,
        payload_mb=lut.by_name(resp.tier_name).payload_mb,
        iou=resp.iou, edge_energy_j=resp.edge_energy_j))
    return max(t + resp.edge_compute_s,
               resp.t_delivered - resp.edge_compute_s, t + 1e-3)


def run_mission(lut: SystemLUT, trace: BandwidthTrace, spec: MissionSpec,
                executor=None) -> MissionLog:
    """One UAV's mission on its own ``AveryEngine``; with ``executor``,
    per-frame fidelity comes from real lisa-mini inference on it."""
    engine = AveryEngine(lut=lut, executor=executor)
    oracle = FidelityOracle(lut, spec, executor=executor)
    sess = mission_session(engine, trace, spec, oracle)

    log = MissionLog(spec=spec)
    t = 0.0
    seq = 0
    while t < spec.duration_s:
        t = mission_step(sess, log, lut, t)
        seq += 1
        if seq > 100_000:
            break
    return log
