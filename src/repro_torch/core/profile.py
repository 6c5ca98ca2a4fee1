"""Offline profiling -> System Configuration LUT (port of
``repro/core/profile.py``).

Accuracies are measured on the *trained* proxy models (original and
fine-tuned, ``core/training.py``); payload sizes are computed for the
TARGET DEPLOYMENT geometry (LISA-7B: 4096 SAM tokens x d=1280 bf16 =
10.49 MB boundary activation, the paper's figure), so tier feasibility
against the 8–20 Mbps trace matches the paper's operating regime.
``random_init_system`` builds the no-offline-phase system that serving
smoke runs, the mission runtime and the chip check use: random weights and
one bottleneck per tier over the published LUT.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.lisa7b import LISAPipelineConfig
from repro_torch.core import bottleneck as bn
from repro_torch.core import packets as pk
from repro_torch.core import training
from repro_torch.core.lut import ContextConfig, SystemLUT, Tier

TIER_NAMES = {0.25: "High Accuracy", 0.10: "Balanced", 0.05: "High Throughput"}


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
              eval_batches: int = 6, device: DeviceLike = None
              ) -> SystemLUT:
    """Profile each tier: Average IoU for both model variants + deployment
    payload size. ``bottlenecks`` maps ratio -> trained pair; tiers come
    out by ratio, largest first."""
    if deploy is None:
        from repro_torch.configs.lisa7b import CONFIG as deploy
    tiers = []
    for ratio, bp in sorted(bottlenecks.items(), reverse=True):
        acc_base = training.evaluate_insight(
            pcfg, params_original, bn_params=bp, batches=eval_batches,
            device=device)
        acc_ft = training.evaluate_insight(
            pcfg, params_finetuned, bn_params=bp, batches=eval_batches,
            device=device)
        tiers.append(Tier(
            name=TIER_NAMES.get(ratio, f"r={ratio}"),
            ratio=ratio,
            acc_base=acc_base["avg_iou"],
            acc_finetuned=acc_ft["avg_iou"],
            payload_mb=deployment_payload_mb(deploy, ratio),
        ))
    ctx = ContextConfig(payload_mb=deployment_context_mb(deploy))
    return SystemLUT(tiers=tiers, context=ctx)


def train_full_system(pcfg: LISAPipelineConfig,
                      ratios: Sequence[float] = (0.25, 0.10, 0.05),
                      steps: int = 300, bn_steps: int = 200,
                      ft_steps: int = 150, batch_size: int = 16,
                      seed: int = 0, log=print, device: DeviceLike = None
                      ) -> Tuple[dict, dict, Dict[float, dict]]:
    """End-to-end offline phase: train the original model, fine-tune the
    flood variant, distillation-train one bottleneck per ratio (against
    the original model, as the paper trains compression models once).
    Every parameter comes back detached: the serving side hands them to
    kernel wrappers that refuse inputs which require grad."""
    log("[profile] training original lisa-mini ...")
    params = training.train_lisa(pcfg, steps=steps, batch_size=batch_size,
                                 seed=seed, log=log, device=device)
    log("[profile] fine-tuning flood variant ...")
    params_ft = training.finetune_lisa(pcfg, params, steps=ft_steps,
                                       batch_size=batch_size, seed=seed + 1,
                                       log=log, device=device)
    bns = {}
    for r in ratios:
        log(f"[profile] training bottleneck r={r} ...")
        bns[r] = training.train_bottleneck(pcfg, params, r, steps=bn_steps,
                                           batch_size=batch_size, seed=seed,
                                           log=log, device=device)
    return params, params_ft, bns


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
