"""Control-policy plug point: how the engine picks an operating tier (host
copy of ``repro/engine/policy.py``).

The paper's §5.3 adaptive-vs-static comparison is a policy swap, not a
``mode=`` string: every policy maps (sensed bandwidth, intent,
requirements, LUT, mission goal) to a ``TierDecision``. Three ship:

  * ``AdaptivePolicy`` — Algorithm 1 verbatim (Sense/Gate/Evaluate/
    Select via ``core.controller.select_configuration``); an empty
    feasible set yields ``tier=None, feasible=False`` (the mission
    idles that frame).
  * ``StaticTierPolicy`` — the fixed-tier baselines (High Accuracy /
    Balanced / High Throughput); never checks feasibility, matching the
    paper's static baselines that keep transmitting into a degraded
    link.
  * ``BestEffortPolicy`` — adaptive with graceful degradation (the
    fleet finding): when no tier satisfies F_I it transmits the
    lightest tier anyway, reporting ``feasible=False`` so starvation is
    still accounted.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol, runtime_checkable

from repro_torch.core.controller import (MissionGoal, NoFeasibleInsightTier,
                                   PowerConfig, select_configuration)
from repro_torch.core.intent import Intent, IntentRequirements
from repro_torch.core.lut import SystemLUT, Tier


@dataclass(frozen=True)
class TierDecision:
    """A policy's verdict for one request."""
    stream: str                       # "context" | "insight"
    tier: Optional[Tier]              # None: Context stream or infeasible
    feasible: bool = True             # F_I/Q_I satisfied by the choice
    throughput_pps: float = 0.0       # induced update rate f*


@runtime_checkable
class ControlPolicy(Protocol):
    def select(self, bandwidth_mbps: float, intent: Intent,
               requirements: IntentRequirements, lut: SystemLUT, *,
               goal: MissionGoal = MissionGoal.PRIORITIZE_ACCURACY,
               finetuned: bool = False) -> TierDecision:
        ...

    # Policies may additionally expose
    #   allow_speculation(stats: SpecStats, cfg: SpeculativeConfig) -> bool
    # — the engine consults it before every speculative verify step, so
    # the drafting lever rides the same Sense/Evaluate/Select loop as
    # tier selection (a policy without the hook leaves drafting on).
    #
    # Policies may also expose
    #   adapt_to_load(decision, load, lut, bandwidth_mbps) -> TierDecision
    # — scheduler feedback as a self-awareness input: ``load`` is the
    # live queue pressure (engine.scheduler's ``load()`` dict) and the
    # policy may revise its fresh decision against it, e.g. downshift
    # the Insight tier under a deep backlog so admission latency is
    # traded against per-frame fidelity. A policy without the hook (or
    # one that returns the decision unchanged) keeps Select's verdict.


def _context_decision(bandwidth_mbps: float, lut: SystemLUT) -> TierDecision:
    return TierDecision(stream="context", tier=None, feasible=True,
                        throughput_pps=lut.context.max_pps(bandwidth_mbps))


@dataclass(frozen=True)
class AdaptivePolicy:
    """Algorithm 1: adaptive tier selection under the mission goal.

    ``overload_queue_depth`` arms the scheduler-feedback loop: once the
    engine's admission queues hold at least that many requests, fresh
    Insight decisions downshift one notch toward the lightest tier
    (smaller prefill payloads clear a backlog faster). None (default)
    disables the hook — existing behavior is untouched."""
    power: PowerConfig = field(default_factory=PowerConfig)
    overload_queue_depth: Optional[int] = None

    def select(self, bandwidth_mbps, intent, requirements, lut, *,
               goal=MissionGoal.PRIORITIZE_ACCURACY,
               finetuned=False) -> TierDecision:
        if intent is not Intent.INSIGHT:
            return _context_decision(bandwidth_mbps, lut)
        try:
            sel = select_configuration(bandwidth_mbps, self.power, goal,
                                       intent, requirements, lut,
                                       finetuned=finetuned)
        except NoFeasibleInsightTier:
            return TierDecision(stream="insight", tier=None, feasible=False)
        return TierDecision(stream="insight", tier=sel.tier, feasible=True,
                            throughput_pps=sel.throughput_pps)

    def allow_speculation(self, stats, cfg) -> bool:
        """Embodied self-awareness applied to the serving substrate:
        keep drafting while the observed acceptance rate earns its keep,
        disable it once enough samples show acceptance below the
        configured floor (a draft pass below the floor costs more small-
        model steps than the verify pass saves)."""
        if stats.drafted < cfg.min_draft_samples:
            return True                   # still warming up the estimate
        return stats.acceptance_rate >= cfg.acceptance_floor

    def adapt_to_load(self, decision: TierDecision, load: dict,
                      lut: SystemLUT,
                      bandwidth_mbps: float) -> TierDecision:
        """Scheduler feedback as embodied self-awareness: under a deep
        admission backlog, trade one notch of Insight fidelity for
        faster queue clearance (the heaviest tier strictly cheaper than
        Select's pick). Context decisions and shallow queues pass
        through untouched."""
        if (self.overload_queue_depth is None
                or decision.stream != "insight" or decision.tier is None
                or load.get("queue_depth", 0) < self.overload_queue_depth):
            return decision
        cheaper = [t for t in lut.tiers
                   if t.payload_mb < decision.tier.payload_mb]
        if not cheaper:
            return decision               # already the lightest
        tier = max(cheaper, key=lambda t: t.payload_mb)
        return TierDecision(stream="insight", tier=tier,
                            feasible=decision.feasible,
                            throughput_pps=tier.max_pps(bandwidth_mbps))


@dataclass(frozen=True)
class StaticTierPolicy:
    """Fixed-tier baseline: always transmit ``tier_name`` (§5.3.1)."""
    tier_name: str

    def select(self, bandwidth_mbps, intent, requirements, lut, *,
               goal=MissionGoal.PRIORITIZE_ACCURACY,
               finetuned=False) -> TierDecision:
        if intent is not Intent.INSIGHT:
            return _context_decision(bandwidth_mbps, lut)
        tier = lut.by_name(self.tier_name)
        return TierDecision(stream="insight", tier=tier, feasible=True,
                            throughput_pps=tier.max_pps(bandwidth_mbps))

    def allow_speculation(self, stats, cfg) -> bool:
        """Static baseline: never adapts — drafting stays on no matter
        what the acceptance rate says (mirroring the fixed-tier
        baselines that keep transmitting into a degraded link)."""
        return True

    def adapt_to_load(self, decision: TierDecision, load: dict,
                      lut: SystemLUT,
                      bandwidth_mbps: float) -> TierDecision:
        """Static baseline: queue pressure changes nothing."""
        return decision


@dataclass(frozen=True)
class BestEffortPolicy:
    """Adaptive with graceful degradation: infeasible frames transmit the
    lightest tier instead of idling, flagged ``feasible=False``."""
    inner: AdaptivePolicy = field(default_factory=AdaptivePolicy)

    def select(self, bandwidth_mbps, intent, requirements, lut, *,
               goal=MissionGoal.PRIORITIZE_ACCURACY,
               finetuned=False) -> TierDecision:
        decision = self.inner.select(bandwidth_mbps, intent, requirements,
                                     lut, goal=goal, finetuned=finetuned)
        if decision.stream == "insight" and decision.tier is None:
            tier = min(lut.tiers, key=lambda t: t.payload_mb)
            return TierDecision(stream="insight", tier=tier, feasible=False,
                                throughput_pps=tier.max_pps(bandwidth_mbps))
        return decision

    def allow_speculation(self, stats, cfg) -> bool:
        return self.inner.allow_speculation(stats, cfg)

    def adapt_to_load(self, decision: TierDecision, load: dict,
                      lut: SystemLUT,
                      bandwidth_mbps: float) -> TierDecision:
        return self.inner.adapt_to_load(decision, load, lut,
                                        bandwidth_mbps)


@dataclass(frozen=True)
class RetryPolicy:
    """Fault-tolerance policy: what the engine does when an attempt
    fails (uplink blackout, packet drop, or a cloud-stage error).

    A failed attempt retries after exponential backoff, and the retry
    **re-runs Select at the retry time** — the paper's adaptation loop
    applied to faults: the self-aware controller re-senses bandwidth and
    picks a tier for the world as it is *after* the failure. With
    ``downshift=True`` the retry is additionally forced onto a strictly
    cheaper compression tier than the failed attempt's (or the lightest
    tier, if the failure already happened at the bottom): a link that
    just ate a packet gets a smaller one next, whatever the sensed
    bandwidth claims (the sense lie / stale-estimate case).

    ``max_attempts`` bounds total attempts (first try included); the
    engine additionally stops retrying once the request's deadline
    (``IntentRequirements.max_latency_s``) would pass before the retry
    even starts.
    """
    max_attempts: int = 3
    backoff_base_s: float = 0.5
    backoff_factor: float = 2.0
    downshift: bool = True

    def backoff_s(self, attempt: int) -> float:
        """Backoff before the retry following failed attempt number
        ``attempt`` (1-based: the first retry waits ``backoff_base_s``)."""
        return self.backoff_base_s * self.backoff_factor ** (attempt - 1)

    def downshifted(self, decision: TierDecision, prev_tier,
                    lut: SystemLUT, bandwidth_mbps: float) -> TierDecision:
        """Post-Select downshift enforcement for a retry: keep the fresh
        decision when it is already strictly cheaper than the failed
        attempt's tier, otherwise force the heaviest tier still cheaper
        than it (or the lightest tier overall — a retry is degraded
        service by definition, so an infeasible re-Select degrades
        rather than idles)."""
        if (not self.downshift or prev_tier is None
                or decision.stream != "insight"):
            return decision
        if (decision.tier is not None
                and decision.tier.payload_mb < prev_tier.payload_mb):
            return decision
        cheaper = [t for t in lut.tiers
                   if t.payload_mb < prev_tier.payload_mb]
        tier = (max(cheaper, key=lambda t: t.payload_mb) if cheaper
                else min(lut.tiers, key=lambda t: t.payload_mb))
        return TierDecision(
            stream="insight", tier=tier,
            feasible=decision.feasible and decision.tier is not None,
            throughput_pps=tier.max_pps(bandwidth_mbps))


def policy_from_mode(mode: str, static_tier: Optional[str] = None,
                     fallback: bool = False) -> ControlPolicy:
    """Deprecation shim: map the pre-engine ``MissionSpec`` knobs
    (``mode="avery"|"static"``, ``static_tier=``, ``fallback=``) onto the
    policy objects. New code should pass a policy directly."""
    if mode == "static":
        if static_tier is None:
            raise ValueError("mode='static' requires static_tier")
        return StaticTierPolicy(static_tier)
    if mode != "avery":
        raise ValueError(f"unknown mission mode {mode!r}")
    return BestEffortPolicy() if fallback else AdaptivePolicy()
