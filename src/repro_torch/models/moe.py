"""Dense FFN (port of ``repro/models/moe.py:dense_mlp``). The MoE router
and expert paths wait for the architecture-zoo slice (ROADMAP.md)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import ACTIVATIONS, fan_in_init, linear
from repro_torch.models.config import ModelConfig


def init_dense_mlp(generator: torch.Generator, cfg: ModelConfig, d_ff: int,
                   layers: Optional[int], device=None) -> dict:
    """Stacked dense-FFN weights with a leading layer axis; ``layers=None``
    for one unstacked layer."""
    d, dt = cfg.d_model, cfg.pdtype
    names = ("w_gate", "w_up") if cfg.gated_mlp else ("w_up",)
    p = {n: fan_in_init(generator, (d, d_ff), dt, device, layers)
         for n in names}
    p["w_down"] = fan_in_init(generator, (d_ff, d), dt, device, layers)
    return p


def dense_mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = ACTIVATIONS[cfg.mlp_act]
    if cfg.gated_mlp:
        return linear(act(linear(x, p["w_gate"])) * linear(x, p["w_up"]),
                      p["w_down"])
    return linear(act(linear(x, p["w_up"])), p["w_down"])
