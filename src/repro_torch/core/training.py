"""Training drivers for the LISA proxy pipeline and its bottleneck tiers
(port of ``repro/core/training.py``).

Two model variants mirror the paper's LUT columns (§5.1):
  * "original"  — trained on the broad mixture (both classes, context +
    insight queries, heavy photometric augmentation) — the stand-in for
    pre-trained LISA;
  * "finetuned" — the original weights further specialised on the
    flood-proxy Insight distribution (the stand-in for LoRA flood
    fine-tuning on Flood-ReasonSeg).

Bottleneck pairs are distillation-trained per compression ratio with the
pipeline frozen (paper Fig. 5: "pre-trained compression models").

The batches are the reference's, drawn from ``numpy`` RandomStates in the
same order. Initial weights come from ``torch`` generators seeded as the
reference keys its draws (its distributions, not its bits). Each step is
``models.model.value_and_grad`` and one update of the port's AdamW under
``torch.no_grad``, so the trained parameters never require grad; no step
reads a value back to the host but the logged ones. Every function runs
on the card unless ``device`` says otherwise; the parameters passed in
are tensors on that device.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, optim, resolve_device
from repro_torch.configs.lisa7b import LISAPipelineConfig
from repro_torch.core import bottleneck as bn
from repro_torch.core import vlm
from repro_torch.data import floodseg
from repro_torch.models.model import value_and_grad
from repro_torch.models.stack import tree_map


def _to_device(batch: Dict[str, np.ndarray], dev: torch.device
               ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def mixed_loss(params, pcfg, ins_batch, ctx_batch):
    li, mi = vlm.insight_loss(params, pcfg, ins_batch)
    lc, mc = vlm.context_loss(params, pcfg, ctx_batch)
    return li + 0.5 * lc, {**mi, "ctx_ce": mc["answer_ce"]}


def lisa_step(opt, pcfg, params, state, ins, ctx):
    """One step of ``train_lisa``: (params, state, loss, metrics)."""
    loss, metrics, grads = value_and_grad(
        lambda q: mixed_loss(q, pcfg, ins, ctx), params)
    with torch.no_grad():
        params, state = opt.apply(params, state, grads)
    return params, state, loss, metrics


def train_lisa(pcfg: LISAPipelineConfig, steps: int = 300,
               batch_size: int = 16, seed: int = 0, lr: float = 3e-4,
               params: Optional[dict] = None,
               insight_only: bool = False,
               log_every: int = 50,
               log: Callable[[str], None] = print,
               device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    if params is None:
        params = vlm.init_lisa(pcfg, _generator(seed, dev), dev)
    opt = optim.adamw(optim.cosine_with_warmup(lr, steps // 10, steps))
    state = opt.init(params)
    for i in range(steps):
        ins = _to_device(floodseg.make_batch(rng, batch_size, "segment"),
                         dev)
        kind = "any" if (i % 2 == 0 or insight_only) else "count"
        ctx = _to_device(floodseg.make_batch(rng, batch_size, kind), dev)
        params, state, loss, metrics = lisa_step(opt, pcfg, params, state,
                                                 ins, ctx)
        if log_every and (i % log_every == 0 or i == steps - 1):
            log(f"  step {i:4d} loss={float(loss):.4f} "
                f"bce={float(metrics['bce']):.4f} "
                f"dice={float(metrics['dice']):.4f}")
    return params


def finetune_lisa(pcfg: LISAPipelineConfig, params: dict, steps: int = 150,
                  batch_size: int = 16, seed: int = 1,
                  lr: float = 1e-4, log=print,
                  device: DeviceLike = None) -> dict:
    """Flood-specialisation pass (stand-in for the paper's LoRA FT)."""
    return train_lisa(pcfg, steps=steps, batch_size=batch_size, seed=seed,
                      lr=lr, params=params, insight_only=True, log=log,
                      device=device)


def bottleneck_step(opt, pcfg, frozen, bn_params, state, ins,
                    recon_weight):
    """One step of ``train_bottleneck``: (bn_params, state, loss). Only the
    pair's leaves get gradients; ``frozen`` is the detached pipeline."""
    def loss_fn(bp):
        task, _ = vlm.insight_loss(frozen, pcfg, ins, bn_params=bp)
        a = vlm.sam_head(frozen, pcfg, ins["images"])
        return task + recon_weight * bn.recon_loss(bp, a), {}

    loss, _, grads = value_and_grad(loss_fn, bn_params)
    with torch.no_grad():
        bn_params, state = opt.apply(bn_params, state, grads)
    return bn_params, state, loss


def train_bottleneck(pcfg: LISAPipelineConfig, params: dict, ratio: float,
                     steps: int = 200, batch_size: int = 16, seed: int = 0,
                     lr: float = 1e-3, recon_weight: float = 0.1,
                     log_every: int = 50, log=print,
                     device: DeviceLike = None) -> dict:
    """Distillation-train one bottleneck pair at ``ratio`` with the
    pipeline frozen (gradients flow only into the encoder/decoder)."""
    dev = resolve_device(device)
    d = pcfg.sam.d_model
    orig_bytes = pcfg.sam.adtype.itemsize
    spec = bn.BottleneckSpec(d, bn.rank_for_ratio(d, ratio, orig_bytes),
                             orig_bytes)
    rng = np.random.RandomState(seed + int(ratio * 1000))
    bn_params = bn.init_bottleneck(
        _generator(seed + int(ratio * 1000), dev), spec, device=dev)
    opt = optim.adamw(lr)
    state = opt.init(bn_params)
    frozen = tree_map(torch.Tensor.detach, params)
    for i in range(steps):
        ins = _to_device(floodseg.make_batch(rng, batch_size, "segment"),
                         dev)
        bn_params, state, loss = bottleneck_step(opt, pcfg, frozen,
                                                 bn_params, state, ins,
                                                 recon_weight)
        if log_every and (i % log_every == 0 or i == steps - 1):
            log(f"  bn(r={ratio}) step {i:4d} loss={float(loss):.4f}")
    return bn_params


@torch.inference_mode()
def evaluate_insight(pcfg: LISAPipelineConfig, params: dict,
                     bn_params: Optional[dict] = None, batches: int = 8,
                     batch_size: int = 32, seed: int = 999,
                     device: DeviceLike = None) -> Dict[str, float]:
    """Average IoU (mean of gIoU and cIoU, paper Table 3) on held-out
    un-augmented scenes, counted on the host in float64."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    inters, unions, gious = [], [], []
    for _ in range(batches):
        b = floodseg.make_batch(rng, batch_size, "segment", augment=False)
        ml, _ = vlm.insight_forward(
            params, pcfg, torch.from_numpy(b["images"]).to(dev),
            torch.from_numpy(b["query"]).to(dev), bn_params=bn_params)
        pred = (ml.cpu().numpy() > 0).astype(np.float64)
        gt = b["mask"].astype(np.float64)
        inter = (pred * gt).sum(axis=(1, 2))
        union = np.maximum(pred, gt).sum(axis=(1, 2))
        inters.append(inter.sum())
        unions.append(union.sum())
        gious.append((inter / (union + 1e-6)).mean())
    giou = float(np.mean(gious))
    ciou = float(sum(inters) / (sum(unions) + 1e-6))
    return {"giou": giou, "ciou": ciou, "avg_iou": 0.5 * (giou + ciou)}


@torch.inference_mode()
def evaluate_context(pcfg: LISAPipelineConfig, params: dict,
                     batches: int = 8, batch_size: int = 32, seed: int = 999,
                     device: DeviceLike = None) -> float:
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    accs = []
    for _ in range(batches):
        b = floodseg.make_batch(rng, batch_size, "any", augment=False)
        logits = vlm.context_forward(
            params, pcfg, torch.from_numpy(b["images"]).to(dev),
            torch.from_numpy(b["query"]).to(dev))
        accs.append(float(np.mean(np.argmax(logits.cpu().numpy(), -1)
                                  == b["answer"])))
    return float(np.mean(accs))
