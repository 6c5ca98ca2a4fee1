"""Serving launcher (port of ``repro/launch/serve.py``).

Local mode: closed-loop dual-stream serving of the lisa-mini system over a
simulated channel, through the ``AveryEngine`` front door — batched
operator requests, intent gating, Algorithm-1 tier control, the paged
in-flight batch or closed microbatches — on the card. By default it first
runs the offline phase on a small budget (trains lisa-mini, its flood
fine-tune and one bottleneck pair per tier, then profiles the LUT);
``--smoke`` serves random-init weights over the paper's LUT instead:

  python -m repro_torch.launch.serve --batching inflight --duration 20
  python -m repro_torch.launch.serve --smoke --duration 20 --seed 1
  python -m repro_torch.launch.serve --smoke --batching inflight --device cpu

The pod-disaggregated ``--dryrun`` comes with the dry-run (ROADMAP.md,
Queue 1 item 5b) and raises until then; tensor-parallel serving itself is
``AveryEngine(mesh=)`` (``sharding.serving``).
"""
import argparse

import numpy as np


def serve_local(duration_s: float, seed: int, max_batch: int = 8,
                smoke: bool = False, batching: str = "microbatch",
                device: str = "cuda") -> None:
    """Closed-loop local serving through the ``AveryEngine`` front door.

    Without ``smoke`` the offline phase runs first on a small budget
    (``train_full_system`` and ``build_lut``); ``smoke=True`` serves
    random-init weights over the paper LUT, so the whole engine path
    (intent gate, policy, transport, batched cloud serving) runs in
    seconds. ``batching`` picks the cloud discipline:
    closed tier-bucketed microbatches or the token-level in-flight batch
    (``"inflight"``). ``device`` is where the executor serves: ``cuda``
    (the default; raises without a card) or ``cpu``."""
    import torch

    from repro_torch.configs.lisa_mini import CONFIG as pcfg
    from repro_torch.core import profile as prof
    from repro_torch.core.intent import Intent
    from repro_torch.core.streams import DualStreamExecutor
    from repro_torch.core.vlm import iou_metrics
    from repro_torch.data import floodseg, requests
    from repro_torch.engine import (AdaptivePolicy, AveryEngine,
                                    ChannelTransport)
    from repro_torch.network import paper_trace

    if smoke:
        print("[serve] smoke mode: random-init weights, paper LUT")
        params, bns_by_name, lut = prof.random_init_system(pcfg, seed=seed,
                                                           device=device)
    else:
        print("[serve] training lisa-mini system (offline phase, small "
              "budget)")
        params, params_ft, bns = prof.train_full_system(
            pcfg, steps=120, bn_steps=80, ft_steps=60, log=lambda s: None,
            device=device)
        lut = prof.build_lut(pcfg, params, params_ft, bns, eval_batches=2,
                             device=device)
        bns_by_name = {lut.tiers[i].name: bns[r]
                       for i, r in enumerate(sorted(bns, reverse=True))}
    execu = DualStreamExecutor(pcfg=pcfg, params=params,
                               bottlenecks=bns_by_name, lut=lut,
                               device=device)
    trace = paper_trace(seed=seed, duration_s=int(duration_s))
    engine = AveryEngine(
        lut=lut, executor=execu,
        transport=ChannelTransport.from_trace(trace),
        policy=AdaptivePolicy(), max_batch=max_batch, batching=batching)
    session = engine.session("operator-0")
    rng = np.random.RandomState(seed)

    # edge loop: each operator request goes through the engine — intent
    # gate, tier policy, edge encode, channel, cloud scheduler; full
    # microbatches are served as soon as they form (continuous batching),
    # stragglers at the end of the stream
    truth = {}
    futures = []
    for req in requests.mission_requests(seed, duration_s):
        batch = floodseg.make_batch(rng, 1, req.kind, augment=False,
                                    cls=req.cls)
        fut = session.submit(prompt=req.prompt, images=batch["images"],
                             query=batch["query"], time_s=req.time_s)
        truth[fut.request.request_id] = batch
        futures.append(fut)
    engine.drain()

    ious, ctx_correct = [], []
    for fut in futures:
        res = fut.result()
        if not res.feasible:           # no tier sustained F_I: never served
            continue
        batch = truth[res.request_id]
        if res.intent is Intent.CONTEXT:
            ctx_correct.append(
                float(np.argmax(res.answer_logits[0]) == batch["answer"][0]))
        else:
            m = iou_metrics(torch.as_tensor(res.mask_logits),
                            torch.as_tensor(batch["mask"]))
            ious.append(float(m["avg_iou"]))
    stats = engine.stats
    detail = (f"{stats['inflight_steps']:.0f} in-flight decode steps (mean "
              f"{stats['mean_live_slots']:.1f} live slots"
              if batching == "inflight" else
              f"{stats['n_microbatches']:.0f} microbatches (mean batch "
              f"{stats['mean_batch_size']:.1f}")
    print(f"[serve] served {len(ctx_correct)} context + {len(ious)} insight "
          f"requests over {duration_s:.0f}s in {detail}, "
          f"{stats['compiled_stages']:.0f} compiled cloud stages)")
    if ctx_correct:
        print(f"[serve] context answer accuracy: {np.mean(ctx_correct):.3f}")
    if ious:
        print(f"[serve] insight Average IoU:     {np.mean(ious):.3f}")
    lat = [r.latency_s for r in engine.transport.records]
    print(f"[serve] mean packet latency: {np.mean(lat):.3f}s "
          f"(p95 {np.percentile(lat, 95):.3f}s)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--dryrun", action="store_true",
                    help="pod-disaggregated dry-run (not ported yet)")
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=8,
                    help="cloud scheduler microbatch / in-flight slot cap")
    ap.add_argument("--smoke", action="store_true",
                    help="random-init weights + paper LUT (no offline "
                         "phase)")
    ap.add_argument("--batching", choices=("microbatch", "inflight"),
                    default="microbatch",
                    help="cloud serving discipline: closed microbatches or "
                         "token-level in-flight batching")
    ap.add_argument("--device", default="cuda",
                    help="where the executor serves: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.dryrun:
        raise NotImplementedError(
            "the pod-disaggregated dry-run is not ported yet (ROADMAP.md, "
            "Queue 1 item 5b)")
    serve_local(args.duration, args.seed, args.max_batch,
                smoke=args.smoke, batching=args.batching, device=args.device)


if __name__ == "__main__":
    main()
