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

Pod-disaggregated split serving (the reference's DESIGN.md §4.1): on a
mesh with a "pod" axis, pod 0 ("edge") runs the SAM head and the
bottleneck encoder, ``Mesh.ppermute`` carries only the codes and scales
across "pod", and pod 1 ("cloud") decodes and finishes (``split_serve``).
``--dryrun`` reckons that step on the 2x16x16 production mesh on the meta
device, as the reference compiles it on 512 fake devices, and prints the
pod link's bytes with and without the bottleneck:

  python -m repro_torch.launch.serve --dryrun

``--split-selftest`` runs ``split_serve`` over two ranks of lisa-mini
(spawned by this module; gloo, ``--device cpu`` or the card) and writes
each rank's outputs. Tensor-parallel serving is ``AveryEngine(mesh=)``
(``sharding.serving``); the sharded train step is ``sharding.training``.
"""
import argparse
import os
import sys
from typing import Any, Dict, Optional, Tuple

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


# ---------------------------------------------------------------------------
# pod-disaggregated split serving
# ---------------------------------------------------------------------------

SPLIT_RATIO = 0.25              # the bottleneck of the split step
SPLIT_BATCH = 32                # images a serve step (2 a device row)
SPLIT_QUERY = 8                 # query tokens an image


def split_serve(params: dict, bnp: dict, pcfg: Any, images, query,
                mesh: Any, use_kernel: bool = False):
    """One pod-disaggregated split serve step on this rank of ``mesh`` (a
    mesh with a "pod" axis; ``launch.mesh.make_named_mesh``): the
    reference's ``split_serve`` body (``inner``), which every rank runs.
    The edge (pod 0) computes the SAM head and the compressed codes; the
    ppermute moves only the codes and scales from pod 0 to pod 1 (pod 0
    receives zeros, as ``jax.lax.ppermute`` leaves a rank no pair names);
    every rank then decodes, runs the SAM tail, the CLIP context, the LLM
    and the mask decoder. ``use_kernel`` sends encode and decode through
    their CUDA kernels. Returns (mask logits, answer logits)."""
    from repro_torch.core import bottleneck as bn
    from repro_torch.core import vlm
    a = vlm.sam_head(params, pcfg, images)                       # edge
    codes, scales = bn.encode(bnp, a, use_kernel=use_kernel)
    codes = mesh.ppermute(codes, "pod", [(0, 1)])                # the link
    scales = mesh.ppermute(scales, "pod", [(0, 1)])
    a_hat = bn.decode(bnp, codes, scales, out_dtype=pcfg.sam.adtype,
                      use_kernel=use_kernel)                     # cloud
    feats = vlm.sam_tail(params, pcfg, a_hat)
    ctx = vlm.clip_encode(params, pcfg, images)
    ans, seg = vlm.llm_reason(params, pcfg, ctx, query)
    return vlm.mask_decode(params, pcfg, feats, seg), ans


class _LinkCounter:
    """A stand-in for a local mesh on the meta device: ``ppermute``
    records the bytes each device receives (its result, as the
    reference's ``collective_bytes`` reads them) and returns zeros."""

    def __init__(self):
        from repro_torch.launch.dryrun import empty_collectives
        self.collectives = empty_collectives()

    def ppermute(self, tensor, axis, perm):
        import torch

        from repro_torch.launch.dryrun import charge
        charge(self.collectives, "collective-permute", tensor.nbytes)
        return torch.zeros_like(tensor)


def split_reckoning(pcfg: Any = None, batch: int = SPLIT_BATCH,
                    ratio: float = SPLIT_RATIO) -> Dict[str, Any]:
    """The split serve step reckoned on the 2x16x16 production mesh, as
    the reference's ``serve_dryrun`` compiles it: the images and queries
    cut over "data" (its ``shard_map`` in_specs), the weights and the
    bottleneck whole on every device. ``split_serve`` runs on the meta
    device at one device's share, its ppermutes counted. Returns the
    mesh's shape, the per-device collectives, the per-device argument
    bytes by tree, and the boundary payload of the whole batch raw
    (bf16) and bottlenecked (int8 codes and a 4-byte scale a token)."""
    import torch

    from repro_torch.configs.lisa7b import CONFIG as LISA7B
    from repro_torch.core import bottleneck as bn
    from repro_torch.core import vlm
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import specs as sh
    pcfg = LISA7B if pcfg is None else pcfg
    mesh = make_production_mesh(multi_pod=True)
    d = pcfg.sam.d_model
    rank = bn.rank_for_ratio(d, ratio, 2)
    meta = torch.device("meta")
    params = vlm.init_lisa(pcfg, torch.Generator(), device=meta)
    bnp = bn.init_bottleneck(torch.Generator(),
                             bn.BottleneckSpec(d, rank, 2), device=meta)
    size = pcfg.image_size
    # the SAM activation dtype: bf16 at LISA-7B, as the reference's
    images = torch.empty((batch, size, size, 3), dtype=pcfg.sam.adtype,
                         device=meta)
    query = torch.empty((batch, SPLIT_QUERY), dtype=torch.int32, device=meta)
    cut = (("data",),)
    dev_bytes = {
        "params": sh.device_bytes(params, sh.tree_map_with_path(
            lambda _, t: (None,) * t.dim(), params), mesh),
        "bottleneck": sh.device_bytes(bnp, {"enc": (), "dec": ()}, mesh),
        "images": sh.device_bytes(images, cut, mesh),
        "query": sh.device_bytes(query, cut, mesh)}
    dev_bytes["total"] = sum(dev_bytes.values())
    link = _LinkCounter()
    local = batch // mesh.shape["data"]
    with torch.no_grad():
        split_serve(params, bnp, pcfg, images[:local], query[:local], link)
    return {"mesh": dict(mesh.shape), "rank": rank, "batch": batch,
            "collectives": link.collectives, "device_bytes": dev_bytes,
            "raw_bytes": batch * pcfg.sam_tokens * d * 2,
            "comp_bytes": batch * pcfg.sam_tokens * (rank + 4)}


def serve_dryrun() -> Dict[str, Any]:
    """The pod-disaggregated split serve step reckoned on the 2x16x16
    mesh (``split_reckoning``): prints the reference's lines, the
    per-device argument bytes in place of its ``memory_analysis``."""
    r = split_reckoning()
    raw, comp = r["raw_bytes"], r["comp_bytes"]
    db = r["device_bytes"]
    print("[serve-dryrun] pod-disaggregated split serve step reckoned on "
          f"{r['mesh']}")
    print(f"[serve-dryrun] collective-permute bytes (per device): "
          f"{r['collectives']['collective-permute']:.3g}")
    print(f"[serve-dryrun] boundary payload: uncompressed={raw/1e6:.2f}"
          f"MB vs bottlenecked={comp/1e6:.2f}MB "
          f"({raw/comp:.1f}x reduction on the pod link)")
    print("[serve-dryrun] per-device argument bytes: " + ", ".join(
        f"{k}={v}" for k, v in db.items()))
    return r


def split_inputs(pcfg: Any, batch: int, seed: int, device: Any):
    """Seeded split-step inputs: images (batch, S, S, 3) uniform in [0, 1)
    in the SAM activation dtype, queries (batch, SPLIT_QUERY) int32 below
    the vocabulary."""
    import torch
    rng = np.random.RandomState(seed)
    size = pcfg.image_size
    images = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
    query = rng.randint(0, pcfg.llm.vocab_size, (batch, SPLIT_QUERY))
    return (torch.from_numpy(images).to(device, pcfg.sam.adtype),
            torch.from_numpy(query.astype(np.int32)).to(device))


def _split_rank(args) -> int:
    """One rank of ``--split-selftest``: lisa-mini from ``--weights``
    (``params`` and ``split_bn``), one device's two images, ``split_serve``
    over ``{"pod": 2}``; writes ``rank<r>.npz`` into ``--out``."""
    import torch
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.configs.lisa_mini import CONFIG as pcfg
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    device = mesh_lib.init_rank(args.rank, args.world, args.init,
                                args.device)
    try:
        tree = bridge.load_checkpoint(args.weights, device)
        mesh = mesh_lib.make_named_mesh({"pod": args.world})
        images, query = split_inputs(pcfg, 2, args.seed, device)
        with torch.inference_mode():
            masks, ans = split_serve(tree["params"], tree["split_bn"], pcfg,
                                     images, query, mesh)
        np.savez(os.path.join(args.out, f"rank{args.rank}.npz"),
                 masks=masks.float().cpu().numpy(),
                 answers=ans.float().cpu().numpy(),
                 sent=mesh.sent_bytes, received=mesh.received_bytes)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--dryrun", action="store_true",
                    help="reckon the pod-disaggregated split serve step on "
                         "the 2x16x16 mesh")
    ap.add_argument("--split-selftest", action="store_true",
                    help="run split_serve over two ranks of lisa-mini "
                         "(--weights, --out)")
    ap.add_argument("--weights", default=None,
                    help="checkpoint-store directory of lisa-mini "
                         "{params, split_bn} (--split-selftest)")
    ap.add_argument("--out", default=None,
                    help="directory for each rank's rank<r>.npz "
                         "(--split-selftest)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds the selftest's ranks may take")
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
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dryrun:
        serve_dryrun()
        return
    if args.split_selftest:
        if args.rank is not None:
            _split_rank(args)
            return
        from repro_torch.launch import mesh as mesh_lib
        rest = list(argv if argv is not None else sys.argv[1:])
        outs = mesh_lib.spawn_ranks(
            ["-m", "repro_torch.launch.serve", *rest], 2, args.timeout)
        for r, o in enumerate(outs):
            print(f"--- rank {r} ---\n{o}", end="")
        return
    serve_local(args.duration, args.seed, args.max_batch,
                smoke=args.smoke, batching=args.batching, device=args.device)


if __name__ == "__main__":
    main()
