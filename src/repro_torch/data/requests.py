"""Operator request generator for the mission simulator (paper §5.3.1;
host copy of ``repro/data/requests.py``, numpy only).

Emits a stream of timestamped operator queries with natural-language
prompts (for the intent gate) and tokenised queries (for the model).
Mission phases mirror the paper's workflow (§4.3): broad Context triage
interleaved with Insight escalations once targets are found.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.data import floodseg


@dataclass(frozen=True)
class OperatorRequest:
    time_s: float
    prompt: str                   # NL prompt fed to the intent gate
    kind: str                     # "segment" | "any" | "count"
    cls: str                      # target class


def mission_requests(seed: int, duration_s: float,
                     insight_fraction: float = 0.7,
                     mean_interval_s: float = 1.0
                     ) -> Iterator[OperatorRequest]:
    """Poisson request arrivals. ``insight_fraction`` of requests escalate
    to Insight-level grounding (the paper's dynamic evaluation drives the
    Insight stream; §5.3)."""
    rng = np.random.RandomState(seed)
    t = 0.0
    while True:
        t += rng.exponential(mean_interval_s)
        if t >= duration_s:
            return
        cls = "person" if rng.rand() < 0.5 else "vehicle"
        if rng.rand() < insight_fraction:
            yield OperatorRequest(t, floodseg.INSIGHT_PROMPTS[cls],
                                  "segment", cls)
        else:
            yield OperatorRequest(t, floodseg.CONTEXT_PROMPTS[cls],
                                  "any", cls)
