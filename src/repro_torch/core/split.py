"""Depth-wise split of any stacked model into an edge head and cloud tail
(port of ``repro/core/split.py``).

Because every layer group carries its parameters with a leading layer
axis (``repro_torch.models.stack``), splitting at depth k slices that
axis: each side's leaves are views of the full model's tensors, so no
weight is copied.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Tuple

import torch

from repro_torch.models import stack
from repro_torch.models.config import ModelConfig


def _slice_group(gparams: Any, lo: int, hi: int) -> Any:
    return stack.layer_slice(gparams, slice(lo, hi))


def split_layer_groups(cfg: ModelConfig, k: int
                       ) -> Tuple[List[stack.GroupSpec], List[stack.GroupSpec]]:
    """GroupSpec lists for head (layers [0,k)) and tail (layers [k,L))."""
    head, tail = [], []
    off = 0
    for spec in stack.layer_groups(cfg):
        n = spec.count
        if k <= off:
            tail.append(spec)
        elif k >= off + n:
            head.append(spec)
        else:
            head.append(dataclasses.replace(spec, count=k - off))
            tail.append(dataclasses.replace(spec, count=n - (k - off)))
        off += n
    return head, tail


def split_group_params(cfg: ModelConfig, groups: list,
                       k: int) -> Tuple[list, list]:
    """Split the ``groups`` param list at absolute layer index k (aligned
    with split_layer_groups)."""
    head, tail = [], []
    off = 0
    for spec, gp in zip(stack.layer_groups(cfg), groups):
        n = spec.count
        if k <= off:
            tail.append(gp)
        elif k >= off + n:
            head.append(gp)
        else:
            head.append(_slice_group(gp, 0, k - off))
            tail.append(_slice_group(gp, k - off, n))
        off += n
    return head, tail


@dataclass(frozen=True)
class SplitPlan:
    """Static description of a depth-wise split; the apply methods take
    the (sliced) parameter dicts as explicit arguments."""
    cfg: ModelConfig
    split_layer: int

    def __post_init__(self):
        if not 0 < self.split_layer < self.cfg.num_layers:
            raise ValueError(f"split@{self.split_layer} invalid for "
                             f"{self.cfg.num_layers}L")

    @property
    def head_specs(self):
        return split_layer_groups(self.cfg, self.split_layer)[0]

    @property
    def tail_specs(self):
        return split_layer_groups(self.cfg, self.split_layer)[1]

    def split_params(self, params: dict) -> Tuple[dict, dict]:
        """Full model params -> (edge_params, cloud_params). The edge gets
        the embeddings + head groups; the cloud gets tail groups + final
        norm + output head. Hybrid shared-attention params go to both
        sides (the same tensors)."""
        hg, tg = split_group_params(self.cfg, params["groups"],
                                    self.split_layer)
        edge = {"groups": hg}
        cloud = {"groups": tg, "final_norm": params["final_norm"]}
        for key in ("embed", "feat_proj", "vision_proj"):
            if key in params:
                edge[key] = params[key]
        for key in ("head", "mtp"):
            if key in params:
                cloud[key] = params[key]
        if "shared_attn" in params:
            edge["shared_attn"] = params["shared_attn"]
            cloud["shared_attn"] = params["shared_attn"]
        if self.cfg.tie_embeddings:
            cloud["embed"] = params["embed"]
        return edge, cloud

    def head_apply(self, edge_params: dict, x: torch.Tensor, positions,
                   mask) -> torch.Tensor:
        """Edge prefix over an already-embedded activation x (B,S,d)."""
        for spec, gp in zip(self.head_specs, edge_params["groups"]):
            x, _, _ = stack.group_forward(
                gp, self.cfg, spec, x, positions, mask,
                shared_attn=edge_params.get("shared_attn"))
        return x

    def tail_apply(self, cloud_params: dict, x: torch.Tensor, positions,
                   mask) -> torch.Tensor:
        for spec, gp in zip(self.tail_specs, cloud_params["groups"]):
            x, _, _ = stack.group_forward(
                gp, self.cfg, spec, x, positions, mask,
                shared_attn=cloud_params.get("shared_attn"))
        return x
