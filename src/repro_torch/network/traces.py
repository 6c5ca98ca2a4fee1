"""Scripted bandwidth traces (paper §5.3.1; host copy of
``repro/network/traces.py``).

The paper's 20-minute trace emulates a disaster environment with stable
periods, high volatility, and sustained drops, within 8–20 Mbps (uplink
proxy for degraded 5G). ``paper_trace`` reproduces that structure;
``random_trace`` generates seeded variants for property tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass(frozen=True)
class BandwidthTrace:
    """Piecewise-per-second bandwidth (Mbps)."""
    samples: np.ndarray           # (T,) one sample per second
    name: str = "trace"

    @property
    def duration_s(self) -> float:
        return float(len(self.samples))

    def at(self, t: float) -> float:
        i = min(len(self.samples) - 1, max(0, int(t)))
        return float(self.samples[i])

    def mean(self) -> float:
        return float(np.mean(self.samples))


def paper_trace(seed: int = 0, duration_s: int = 1200) -> BandwidthTrace:
    """20 minutes: stable -> volatile -> sustained drop -> recovery ->
    volatile -> stable, clipped to [8, 20] Mbps."""
    rng = np.random.RandomState(seed)
    segs: List[np.ndarray] = []

    def stable(n, level, jitter=0.4):
        return level + rng.randn(n) * jitter

    def volatile(n, lo=9.0, hi=19.5):
        # Ornstein-Uhlenbeck-ish walk with occasional jumps
        out = np.empty(n)
        x = (lo + hi) / 2
        for i in range(n):
            x += 0.25 * ((lo + hi) / 2 - x) + rng.randn() * 2.2
            if rng.rand() < 0.05:
                x = rng.uniform(lo, hi)
            out[i] = x
        return out

    def drop(n, level=8.6, jitter=0.3):
        return level + np.abs(rng.randn(n)) * jitter

    n = duration_s
    plan = [(0.20, lambda k: stable(k, 18.0)),
            (0.15, lambda k: volatile(k)),
            (0.20, lambda k: drop(k)),
            (0.10, lambda k: stable(k, 14.0, 0.8)),
            (0.20, lambda k: volatile(k)),
            (0.15, lambda k: stable(k, 17.0))]
    for frac, fn in plan:
        segs.append(fn(int(round(frac * n))))
    samples = np.concatenate(segs)[:n]
    if len(samples) < n:
        samples = np.concatenate([samples, stable(n - len(samples), 17.0)])
    return BandwidthTrace(np.clip(samples, 8.0, 20.0), name=f"paper-{seed}")


def random_trace(seed: int, duration_s: int = 300, lo: float = 8.0,
                 hi: float = 20.0) -> BandwidthTrace:
    rng = np.random.RandomState(seed)
    x = rng.uniform(lo, hi)
    out = np.empty(duration_s)
    for i in range(duration_s):
        x = np.clip(x + rng.randn() * 1.5, lo, hi)
        out[i] = x
    return BandwidthTrace(out, name=f"rand-{seed}")


def constant_trace(mbps: float, duration_s: int = 300) -> BandwidthTrace:
    return BandwidthTrace(np.full(duration_s, mbps), name=f"const-{mbps}")
