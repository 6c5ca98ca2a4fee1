"""AdamW with decoupled weight decay and global-norm gradient clipping,
and SGD with momentum (port of ``repro/optim/adamw.py``).

A small optimizer over a dict / list / tuple tree of tensors, the
reference's own rather than ``torch.optim``. Moments are kept in float32
whatever the parameters' dtype (bf16 parameters, float32 optimizer
state); each update is computed in float32 and rounded back to the
parameter's dtype (round to nearest even).

``apply(params, state, grads)`` returns new parameter and state trees and
leaves its arguments untouched, as the reference's does. A gradient leaf
that is ``None`` (autograd's answer for a parameter the loss never read)
counts as zeros, as JAX's gradient does: the moments still decay and the
weight decay still applies. The step counter, the schedule's rate, the
clip scale and every update stay on the device: nothing is read to the
host.

``apply(..., sumsq=)`` is the hook of a sharded step
(``sharding.training``), whose ``grads`` are one rank's blocks: it hands
in the sum of squares of the whole gradient (every element counted once
over the ranks), from which the global norm for clipping is taken in
place of the blocks' own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch.models.stack import leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    apply: Callable[[Any, Any, Any], Tuple[Any, Any]]


def sum_of_squares(grads):
    """The sum of squares over every leaf, in float32 (0 for a tree of
    ``None``)."""
    total = 0
    for g in leaves(grads):
        if g is not None:
            total = total + torch.sum(torch.square(g.float()))
    return total


def _global_norm(grads, sumsq=None) -> torch.Tensor:
    """sqrt(sum of squares + 1e-12) over every leaf, in float32, or from
    ``sumsq`` where given."""
    if sumsq is None:
        sumsq = sum_of_squares(grads)
    return torch.sqrt(sumsq + 1e-12)


def _clip_by_global_norm(grads, max_norm: float, sumsq=None):
    """float32 gradients scaled by min(1, max_norm / norm); ``None``
    stays ``None``."""
    scale = torch.clamp(max_norm / _global_norm(grads, sumsq), max=1.0)
    return tree_map(lambda g: None if g is None else g.float() * scale,
                    grads)


def _as_schedule(schedule):
    if callable(schedule):
        return schedule
    lr_value = float(schedule)
    return lambda step: torch.full((), lr_value, dtype=torch.float32,
                                   device=step.device)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    device = next(leaves(params)).device
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw(schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01, clip_norm: float = 1.0) -> Optimizer:
    schedule = _as_schedule(schedule)

    def init(params):
        return {"step": _step0(params),
                "m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    def apply(params, state, grads, sumsq=None):
        step = state["step"] + 1
        lr = schedule(step)
        grads = _clip_by_global_norm(grads, clip_norm, sumsq)

        def first(mo, g):
            return b1 * mo if g is None else b1 * mo + (1 - b1) * g

        def second(vo, g):
            return b2 * vo if g is None else b2 * vo + (1 - b2) * g * g

        m = tree_map(first, state["m"], grads)
        v = tree_map(second, state["v"], grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(p, mo, vo):
            mhat = mo / bc1
            vhat = vo / bc2
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * \
                p.float()
            return (p.float() - lr * delta).to(p.dtype)

        params = tree_map(upd, params, m, v)
        return params, {"step": step, "m": m, "v": v}

    return Optimizer(init=init, apply=apply)


def sgd(schedule, momentum: float = 0.9, clip_norm: float = 1.0) -> Optimizer:
    schedule = _as_schedule(schedule)

    def init(params):
        return {"step": _step0(params), "m": tree_map(_zeros_f32, params)}

    def apply(params, state, grads, sumsq=None):
        step = state["step"] + 1
        lr = schedule(step)
        grads = _clip_by_global_norm(grads, clip_norm, sumsq)
        m = tree_map(lambda mo, g: momentum * mo if g is None
                     else momentum * mo + g, state["m"], grads)
        params = tree_map(lambda p, mo: (p.float() - lr * mo).to(p.dtype),
                          params, m)
        return params, {"step": step, "m": m}

    return Optimizer(init=init, apply=apply)
