"""Learning-rate schedules as functions of the step counter (port of
``repro/optim/schedules.py``).

``step`` is a 0-d int32 tensor on the device; each schedule returns a
float32 0-d tensor on that device. Nothing is read to the host, so a
train step that calls one never waits for the card.
"""
from __future__ import annotations

import math

import torch


def _lr(step: torch.Tensor, lr: float) -> torch.Tensor:
    return torch.full((), lr, dtype=torch.float32, device=step.device)


def _warm(step: torch.Tensor, warmup_steps: int) -> torch.Tensor:
    return torch.clamp((step + 1) / max(1, warmup_steps), max=1.0)


def constant(lr: float):
    def sched(step):
        return _lr(step, lr)
    return sched


def linear_warmup(lr: float, warmup_steps: int):
    def sched(step):
        return _lr(step, lr) * _warm(step, warmup_steps)
    return sched


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    def sched(step):
        t = torch.clamp((step - warmup_steps)
                        / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                   * t))
        return _lr(step, lr) * _warm(step, warmup_steps) * cos
    return sched
