"""System Configuration LUT (host copy of ``repro/core/lut.py``): one row
per Insight operating tier (compression ratio r, expected Average IoU for
the base and fine-tuned models, compressed payload size)."""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import List


@dataclass(frozen=True)
class Tier:
    name: str
    ratio: float                 # bottleneck compression ratio r
    acc_base: float              # Average IoU, base/original model
    acc_finetuned: float         # Average IoU, flood fine-tuned model
    payload_mb: float            # compressed Insight packet size

    def max_pps(self, bandwidth_mbps: float) -> float:
        """f_i,max = (B/8) / data_size (bandwidth Mbit/s, payload MB)."""
        return (bandwidth_mbps / 8.0) / self.payload_mb


@dataclass(frozen=True)
class ContextConfig:
    """The lightweight Context stream's fixed operating point."""
    name: str = "Context"
    payload_mb: float = 0.002    # pooled CLIP features
    max_pps_cap: float = 30.0    # sensor frame-rate cap

    def max_pps(self, bandwidth_mbps: float) -> float:
        return min(self.max_pps_cap, (bandwidth_mbps / 8.0) / self.payload_mb)


@dataclass(frozen=True)
class SystemLUT:
    tiers: List[Tier]
    context: ContextConfig = field(default_factory=ContextConfig)

    def by_name(self, name: str) -> Tier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(name)

    def sorted_by_fidelity(self, finetuned: bool = False) -> List[Tier]:
        key = ((lambda t: t.acc_finetuned) if finetuned
               else (lambda t: t.acc_base))
        return sorted(self.tiers, key=key, reverse=True)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"tiers": [asdict(t) for t in self.tiers],
                       "context": asdict(self.context)}, f, indent=2)

    @staticmethod
    def load(path: str) -> "SystemLUT":
        with open(path) as f:
            raw = json.load(f)
        return SystemLUT(tiers=[Tier(**t) for t in raw["tiers"]],
                         context=ContextConfig(**raw["context"]))


def paper_lut() -> SystemLUT:
    """Paper Table 3, verbatim (LISA-7B on Flood-ReasonSeg)."""
    return SystemLUT(tiers=[
        Tier("High Accuracy", 0.25, 0.8442, 0.8112, 2.92),
        Tier("Balanced", 0.10, 0.8289, 0.7920, 1.35),
        Tier("High Throughput", 0.05, 0.8067, 0.7848, 0.83),
    ])
