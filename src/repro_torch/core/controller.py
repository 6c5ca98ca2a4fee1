"""AVERY onboard Split Controller — Algorithm 1, verbatim structure (host
copy of ``repro/core/controller.py``).

Four phases: Sense (bandwidth), Gate (intent -> admissible stream),
Evaluate (feasible Insight tiers under the F_I timeliness floor),
Select (mission-goal preference over the feasible set).

Deterministic, LUT-driven, O(|tiers|) — deliberately *not* an online
optimizer (paper §3.3). Runs on the host in the serving runtime; a pure
function of its inputs.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core.intent import Intent, IntentRequirements
from repro_torch.core.lut import SystemLUT, Tier


class MissionGoal(enum.Enum):
    PRIORITIZE_ACCURACY = "accuracy"
    PRIORITIZE_THROUGHPUT = "throughput"


@dataclass(frozen=True)
class PowerConfig:
    """Onboard compute-power budget P_cfg. In the paper's prototype this is
    the fixed Jetson operating mode (MODE_30W_ALL) — it scales the edge
    compute-latency/energy model, not the tier feasibility check (§4.4.2)."""
    name: str = "MODE_30W_ALL"
    power_watts: float = 30.0
    edge_flops_per_sec: float = 16e12   # Jetson AGX Xavier ~16 TOPS eqv.


@dataclass(frozen=True)
class SelectedConfig:
    stream: str                  # "context" | "insight"
    tier: Optional[Tier]         # None for the Context stream
    throughput_pps: float        # induced f*


class NoFeasibleInsightTier(Exception):
    """Raised when no profiled tier satisfies F_I at current bandwidth
    (Algorithm 1 lines 26-28)."""


def select_configuration(
    bandwidth_mbps: float,
    power_cfg: PowerConfig,
    mission_goal: MissionGoal,
    intent: Intent,
    requirements: IntentRequirements,
    lut: SystemLUT,
    finetuned: bool = False,
) -> SelectedConfig:
    """Algorithm 1 ``SelectConfiguration``. Raises NoFeasibleInsightTier if
    the feasible set is empty."""
    # --- Stage 1: Sense (bandwidth_mbps is the sensed value) ---
    b = float(bandwidth_mbps)

    # --- Stage 2: Gate ---
    if intent is not Intent.INSIGHT:
        ctx = lut.context
        return SelectedConfig(stream="context", tier=None,
                              throughput_pps=ctx.max_pps(b))

    # --- Stage 3: Evaluate feasible Insight tiers ---
    # Feasibility is F_I (timeliness) AND Q_I (fidelity floor): the paper's
    # formal model (§3.3) states Q(S_t, r_t) >= Q_I although Algorithm 1's
    # listing only shows the timeliness check; we enforce both.
    feasible: list[Tuple[Tier, float]] = []
    for tier in lut.tiers:
        f_max = tier.max_pps(b)                       # (B/8) / data_size
        q = tier.acc_finetuned if finetuned else tier.acc_base
        if f_max >= requirements.min_update_pps and \
                q >= requirements.min_fidelity:
            feasible.append((tier, f_max))
    if not feasible:
        raise NoFeasibleInsightTier(
            f"no Insight tier sustains F_I={requirements.min_update_pps} PPS "
            f"with Q_I={requirements.min_fidelity} at {b:.2f} Mbps")

    # --- Stage 4: Select tier by mission goal ---
    acc_key = (lambda tf: tf[0].acc_finetuned) if finetuned \
        else (lambda tf: tf[0].acc_base)
    if mission_goal is MissionGoal.PRIORITIZE_ACCURACY:
        tier, f = max(feasible, key=acc_key)
    else:
        tier, f = max(feasible, key=lambda tf: tf[1])
    return SelectedConfig(stream="insight", tier=tier, throughput_pps=f)


def min_bandwidth_for_tier(tier: Tier, min_pps: float) -> float:
    """Inverse of the feasibility check: the bandwidth (Mbps) below which
    ``tier`` violates F_I. Paper §3.3 quotes 11.68 Mbps for High-Accuracy
    at 0.5 PPS (= 2.92 MB * 8 * 0.5)."""
    return tier.payload_mb * 8.0 * min_pps
