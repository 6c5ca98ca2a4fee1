"""Training launcher (port of ``repro/launch/train.py``).

Generic arch training on synthetic LM data (``data/lm.py``'s Zipf
stream), on the card unless ``--device`` says otherwise:

    python -m repro_torch.launch.train --arch phi4-mini-3.8b --reduced \\
        --steps 50 --batch 8 --seq 128
    python -m repro_torch.launch.train --arch phi4-mini-3.8b --reduced \\
        --steps 2 --device cpu --out /tmp/ckpt

The parameters are written with ``checkpoint.save_pytree`` to
``<out>/<config name>``, in the reference's format.

The AVERY offline phase (lisa-mini, its flood fine-tune, one bottleneck
pair per tier and the LUT), whose checkpoints and ``lut.json`` land under
``--out`` (``lisa_mini_original/``, ``lisa_mini_finetuned/``,
``bottleneck_r{ratio}/``):

    python -m repro_torch.launch.train --lisa --steps 300
    python -m repro_torch.launch.train --lisa --steps 4 --ft-steps 2 \
        --bn-steps 2 --device cpu --out /tmp/lisa
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import DeviceLike, optim, resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data import lm
from repro_torch.models import init_params, make_train_step
from repro_torch.models.stack import count_params


def train_arch(arch: str, reduced: bool, steps: int, batch: int, seq: int,
               lr: float, out: str, device: DeviceLike = None) -> None:
    dev = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    print(f"[train] {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"params={count_params(cfg)/1e6:.1f}M")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    opt = optim.adamw(optim.cosine_with_warmup(lr, max(1, steps // 10), steps))
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    stream = lm.lm_stream(0, cfg, batch, seq)
    t0 = time.time()
    for i in range(steps):
        batch_np = next(stream)
        params, state, metrics = step_fn(
            params, state, {k: torch.from_numpy(v).to(dev)
                            for k, v in batch_np.items()})
        if i % max(1, steps // 10) == 0 or i == steps - 1:
            print(f"  step {i:5d} loss={float(metrics['loss']):.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
    if out:
        save_pytree(os.path.join(out, cfg.name), params)
        print(f"[train] saved params to {out}/{cfg.name}")


def train_lisa_system(steps: int, bn_steps: int, ft_steps: int, out: str,
                      device: DeviceLike = None) -> None:
    from repro_torch.configs.lisa_mini import CONFIG as pcfg
    from repro_torch.core import profile as prof
    params, params_ft, bns = prof.train_full_system(
        pcfg, steps=steps, bn_steps=bn_steps, ft_steps=ft_steps,
        device=device)
    lut = prof.build_lut(pcfg, params, params_ft, bns, device=device)
    os.makedirs(out, exist_ok=True)
    save_pytree(os.path.join(out, "lisa_mini_original"), params)
    save_pytree(os.path.join(out, "lisa_mini_finetuned"), params_ft)
    for r, bp in bns.items():
        save_pytree(os.path.join(out, f"bottleneck_r{r}"), bp)
    lut.save(os.path.join(out, "lut.json"))
    print("[train] LUT:")
    for t in lut.tiers:
        print(f"  {t.name:16s} r={t.ratio:<5} base={t.acc_base:.4f} "
              f"ft={t.acc_finetuned:.4f} payload={t.payload_mb:.2f}MB")
    print(f"[train] artifacts saved under {out}/")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_IDS, default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lisa", action="store_true",
                    help="the AVERY offline phase: lisa-mini, its "
                         "fine-tune, the bottleneck tiers and the LUT")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--bn-steps", type=int, default=200)
    ap.add_argument("--ft-steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default="benchmarks/artifacts/checkpoints")
    ap.add_argument("--device", default="cuda",
                    help="where to train: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.lisa:
        train_lisa_system(args.steps, args.bn_steps, args.ft_steps, args.out,
                          args.device)
    elif args.arch:
        train_arch(args.arch, args.reduced, args.steps, args.batch, args.seq,
                   args.lr, args.out, args.device)
    else:
        ap.error("pass --arch <id> or --lisa")


if __name__ == "__main__":
    main()
