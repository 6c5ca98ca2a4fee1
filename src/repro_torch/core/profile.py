"""Offline profiling -> System Configuration LUT (port of
``repro/core/profile.py``, its serving half).

Payload sizes are computed for the TARGET DEPLOYMENT geometry (LISA-7B:
4096 SAM tokens x d=1280 bf16 = 10.49 MB boundary activation, the paper's
figure), so tier feasibility against the 8–20 Mbps trace matches the
paper's operating regime. ``random_init_system`` builds the no-offline-phase
system that serving smoke runs, the mission runtime and the chip check
use: random weights and one bottleneck per tier over the published LUT.

The offline phase itself (``build_lut``, which measures each tier's IoU on
trained models, and ``train_full_system``) comes with the LISA system's
training (ROADMAP.md, Queue 1 item 6b) and raises until then.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.lisa7b import LISAPipelineConfig
from repro_torch.core import bottleneck as bn
from repro_torch.core import packets as pk
from repro_torch.core.lut import SystemLUT

TIER_NAMES = {0.25: "High Accuracy", 0.10: "Balanced", 0.05: "High Throughput"}
_TRAINING = ("comes with the LISA system's training (ROADMAP.md, Queue 1 "
             "item 6b)")


def deployment_payload_mb(deploy: LISAPipelineConfig, ratio: float) -> float:
    """Insight packet size at the deployment geometry (SAM codes + scales
    + CLIP context features)."""
    d = deploy.sam.d_model
    orig_bytes = 2 if deploy.sam.param_dtype == "bfloat16" else 4
    rank = bn.rank_for_ratio(d, ratio, orig_bytes)
    nbytes = pk.insight_payload_bytes(
        deploy.sam_tokens, rank,
        clip_tokens=deploy.clip_tokens, clip_dim=deploy.clip.d_model)
    return nbytes / 1e6


def deployment_context_mb(deploy: LISAPipelineConfig) -> float:
    return pk.context_payload_bytes(deploy.clip_tokens,
                                    deploy.llm.d_model) / 1e6


def build_lut(pcfg: LISAPipelineConfig, params_original: dict,
              params_finetuned: dict, bottlenecks: Dict[float, dict],
              deploy: Optional[LISAPipelineConfig] = None,
              eval_batches: int = 6) -> SystemLUT:
    """Profile each tier on trained models. Not ported yet."""
    raise NotImplementedError(f"build_lut {_TRAINING}")


def train_full_system(pcfg: LISAPipelineConfig,
                      ratios: Sequence[float] = (0.25, 0.10, 0.05),
                      steps: int = 300, bn_steps: int = 200,
                      ft_steps: int = 150, batch_size: int = 16,
                      seed: int = 0, log=print):
    """The end-to-end offline phase. Not ported yet."""
    raise NotImplementedError(f"train_full_system {_TRAINING}")


def random_init_system(pcfg: LISAPipelineConfig, seed: int = 0,
                       lut: Optional[SystemLUT] = None, params=None,
                       device: DeviceLike = None):
    """Random-init weights + per-tier bottlenecks over a published LUT (the
    serving plumbing and its throughput depend only on the geometry, not
    on the weight values). The weights are the port's own
    ``vlm.init_lisa`` draws from a generator seeded with ``seed`` (the
    reference's distributions, not its bits); tier i's bottleneck draws
    from a generator seeded with i, as the reference keys it. Pass
    ``params`` to skip the weight init and only build the bottlenecks.
    ``device`` defaults to cuda. Returns (params, bottlenecks-by-tier-name,
    lut)."""
    from repro_torch.core import vlm
    from repro_torch.core.lut import paper_lut
    dev = resolve_device(device)
    if lut is None:
        lut = paper_lut()
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = vlm.init_lisa(pcfg, gen, dev)
    d = pcfg.sam.d_model
    bns = {}
    for i, t in enumerate(lut.tiers):
        gen = torch.Generator(device=dev)
        gen.manual_seed(i)
        bns[t.name] = bn.init_bottleneck(
            gen, bn.BottleneckSpec(d, bn.rank_for_ratio(d, t.ratio, 4), 4),
            device=dev)
    return params, bns, lut
