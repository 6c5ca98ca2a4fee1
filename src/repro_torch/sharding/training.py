"""The sharded train step: FSDP, data- and tensor-parallel
``make_train_step`` over the ranks of a ("data", "model") mesh.

The reference has no module for it: its sharded step is
``jax.jit(make_train_step(cfg, opt), in_shardings=(psh, osh, bsh),
out_shardings=(psh, osh, None))`` over ``param_specs(fsdp=)``,
``opt_state_specs`` and ``batch_specs`` (the train branch of
``repro/launch/dryrun.py:build_lowerable``; ``tests/test_sharding.py``
lowers it on a (1, 1) mesh), and GSPMD partitions it into a step that
computes the unsharded step's function over the global batch. Here each
rank is a process over ``torch.distributed`` (``launch.mesh``): it holds
its blocks of the parameters and of AdamW's moments (``specs.shard_tree``
with those specs) and its share of the batch, and runs one step of its
own; reassembled, the ranks' results are the unsharded step's.

What one rank's step does (``make_sharded_train_step``):
  * FSDP: each leaf whose spec names "data" is gathered over "data" before
    use; its gradient is reduce-scattered back to the rank's shard. The
    gathered block stays saved for the backward, so a leaf is gathered
    once a step.
  * tensor parallelism: the model code runs on the rank's "model" blocks
    (``dryrun.local_config``: H/m query and K/m kv heads where attention
    cuts on whole heads) inside ``common.tensor_parallel``. Its sums over
    "model" are Megatron's conjugate pair: ``reduce`` (g: the sum forward,
    the gradient as it is backward) and ``block_input`` (f: the identity
    forward, the gradient summed backward), once a block.
  * the blocks the model code cannot run on a local cut, the share rule's
    (``dryrun.runs_whole``: attention whose cut splits heads, MoE expert
    tensors, Mamba mixers, audio / VLM input projections): their leaves are
    gathered over "model" before use and the block runs whole on the
    replicated activations, so every rank computes the same whole gradient
    and its block is a slice of it. MLA attention cut over "model" is
    refused: its replicated projections before the cut heads would need a
    conjugate sum of their own.
  * data parallelism: the model code runs on the rank's share of the batch
    inside ``common.data_parallel``, which makes the cross-entropy's mean,
    the MoE router's statistics, its capacity and the order in which
    tokens fill it the whole batch's; the gradient of every leaf FSDP does
    not cut is summed over "data".
  * the global norm, for clipping and ``grad_norm``, counts each element
    once: a rank adds the squares of the blocks it owns (index 0 on every
    axis the leaf's spec does not cut), and one sum over every rank gives
    the whole (``optim.adamw``'s ``sumsq`` hook).
  * AdamW is elementwise: each rank updates its own blocks; ``step`` is
    replicated.
Every collective goes through the mesh (``launch.mesh``), which counts it
by kind under a label: "tp", "fsdp-gather", "fsdp-scatter", "dp",
"whole", "stat", "norm". ``launch.dryrun.held_to_reckoning`` holds those
counts to the reckoning of the same step.

The rank entry (spawned by itself through ``launch.mesh.spawn_ranks``)
runs steps of saved cases (``save_case``: a config, whole weights, a
whole batch and AdamW's settings) on a mesh and writes each rank's blocks,
metrics, collectives, walls and peak memory (``load_outputs``,
``assemble``)::

    PYTHONPATH=src python -m repro_torch.sharding.training \\
        --case CASE.pt [--case ...] --data 2 --model 1 --fsdp \\
        --out DIR [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch import optim
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as model_lib
from repro_torch.models.common import data_parallel, tensor_parallel
from repro_torch.models.config import (HybridConfig, MLAConfig, ModelConfig,
                                       MoEConfig, SSMConfig)
from repro_torch.optim.adamw import sum_of_squares
from repro_torch.sharding import specs as sh

DATA, MODEL = "data", "model"


# ---------------------------------------------------------------------------
# the collectives as autograd functions
# ---------------------------------------------------------------------------


class _Sum(torch.autograd.Function):
    """g: ``t`` summed over ``axes`` forward; the gradient, the same on
    every rank above the sum, passes as it is."""

    @staticmethod
    def forward(ctx, t, mesh, axes, label):
        return mesh.all_reduce(t, axes, label)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


class _SumGrad(torch.autograd.Function):
    """f: the identity forward; the input's gradient, a partial one on
    each rank of a column-cut block, summed over "model" backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, (MODEL,), "tp"), None


class _Gather(torch.autograd.Function):
    """A leaf's blocks over ``axis`` gathered along ``dim``. Backward,
    FSDP's (``scatter``): the gradient summed over the axis and cut back
    to this rank's block; a whole-run block's: the gradient is the same
    on every rank, and this rank's block is its slice."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim, label, scatter):
        ctx.mesh, ctx.axis, ctx.dim, ctx.scatter = mesh, axis, dim, scatter
        ctx.part = t.shape[dim]
        return mesh.all_gather(t, axis, dim, label)

    @staticmethod
    def backward(ctx, grad):
        if ctx.scatter:
            g = ctx.mesh.reduce_scatter(grad, ctx.axis, ctx.dim,
                                        "fsdp-scatter")
        else:
            i = ctx.mesh.coords[ctx.axis]
            g = grad.narrow(ctx.dim, i * ctx.part, ctx.part).contiguous()
        return g, None, None, None, None, None


class TrainTensorParallel:
    """The object ``common.tensor_parallel`` installs for a training rank:
    the cut layer kinds, this rank's place on "model", and the conjugate
    pair over it."""

    def __init__(self, mesh: Any, kinds):
        self.mesh = mesh
        self.kinds = frozenset(kinds)
        self.index = mesh.coords[MODEL]
        self.size = mesh.shape[MODEL]

    def sharded(self, kind: str) -> bool:
        return kind in self.kinds

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(t, self.mesh, (MODEL,), "tp")

    def block_input(self, x: torch.Tensor) -> torch.Tensor:
        return _SumGrad.apply(x, self.mesh)


class DataParallel:
    """The object ``common.data_parallel`` installs for a training rank:
    its share of a batch split over "data" in rank order."""

    def __init__(self, mesh: Any):
        self.mesh = mesh
        self.size = mesh.shape[DATA]
        self.index = mesh.coords[DATA]

    def total(self, t: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(t, self.mesh, (DATA,), "stat")

    def before(self, t: torch.Tensor) -> torch.Tensor:
        rows = self.mesh.all_gather(t.detach()[None], DATA, 0, "stat")
        return rows[:self.index].sum(0)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def batch_cut(batch: Any, mesh: Any) -> bool:
    """Whether ``batch_specs`` cuts every batched leaf of the whole
    ``batch`` over the mesh's batch axes."""
    bspecs = sh.batch_specs(batch, mesh)
    return all(any(e is not None for e in s)
               for _, t, s in sh.spec_pairs(batch, bspecs) if t.dim())


def train_plan(cfg: ModelConfig, mesh: Any, fsdp: bool = False):
    """(specs of the whole tree, ``dryrun.Plan``, the local config, the
    tensor-parallel kinds the model code sums) of ``cfg`` on ``mesh``."""
    aparams = dryrun.abstract_params(cfg)
    specs = sh.param_specs(cfg, aparams, mesh, fsdp=fsdp)
    plan = dryrun.cut_plan(cfg, aparams, specs, mesh)
    if plan.attn == "local" and cfg.attn_type == "mla":
        raise ValueError(f"{cfg.name}: MLA attention cut over 'model' is "
                         f"not supported by the sharded train step")
    kinds = plan.kinds - {"attn"} if plan.attn == "shared" else plan.kinds
    for path, _, spec in sh.spec_pairs(aparams, specs):
        if MODEL in spec and not dryrun.runs_whole(path, plan) and not (
                ("attn" in path and "attn" in kinds)
                or (path[-1] in ("w_gate", "w_up", "w_down")
                    and "mlp" in kinds)
                or (path == ("embed",) and "embed" in kinds)
                or (path == ("head",) and "head" in kinds)):
            raise ValueError(f"{'/'.join(path)} is cut over 'model' "
                             f"({spec}) outside any block the step cuts")
    return specs, plan, dryrun.local_config(cfg, plan), kinds


def make_sharded_train_step(cfg: ModelConfig, optimizer: Any, mesh: Any,
                            fsdp: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` for this rank of the local ``mesh``: every argument and
    result this rank's blocks (``specs.shard_tree`` over
    ``param_specs(cfg, ..., fsdp=)``, ``opt_state_specs`` and
    ``batch_specs``; a mesh with "data" ranks must cut the batch over
    them, ``batch_cut``), the metrics (``loss_fn``'s and ``grad_norm``) the
    whole batch's, the same on every rank. On a one-rank mesh it is
    ``model.make_train_step``, bit for bit, with no collective."""
    if mesh.coords is None:
        raise ValueError("make_sharded_train_step needs a local mesh "
                         "(launch.mesh.make_local_mesh)")
    specs, plan, lcfg, kinds = train_plan(cfg, mesh, fsdp)
    tp = (TrainTensorParallel(mesh, kinds)
          if mesh.shape.get(MODEL, 1) > 1 else None)
    dp = DataParallel(mesh) if mesh.shape.get(DATA, 1) > 1 else None

    def working(blocks):
        def gathered(path, t, spec):
            for dim, e in enumerate(spec):
                if e == DATA:
                    t = _Gather.apply(t, mesh, DATA, dim, "fsdp-gather",
                                      True)
            if dryrun.runs_whole(path, plan):
                for dim, e in enumerate(spec):
                    if e == MODEL:
                        t = _Gather.apply(t, mesh, MODEL, dim, "whole",
                                          False)
            return t
        return sh.map_with_specs(gathered, blocks, specs)

    def loss(blocks, batch):
        with contextlib.ExitStack() as scopes:
            if tp is not None:
                scopes.enter_context(tensor_parallel(tp))
            if dp is not None:
                scopes.enter_context(data_parallel(dp))
            return model_lib.loss_fn(working(blocks), lcfg, batch)

    def owned(spec):
        return all(mesh.coords[a] == 0 for a in mesh.axis_names
                   if mesh.shape[a] > 1 and a not in spec)

    def train_step(params, opt_state, batch):
        _, metrics, grads = model_lib.value_and_grad(
            lambda p: loss(p, batch), params)
        if dp is not None:
            grads = sh.map_with_specs(
                lambda path, g, spec: g if g is None or DATA in spec
                else mesh.all_reduce(g, (DATA,), "dp"), grads, specs)
        mine = [g for _, g, spec in sh.spec_pairs(grads, specs)
                if g is not None and owned(spec)]
        sumsq = sum_of_squares(mine)
        if not torch.is_tensor(sumsq):
            sumsq = torch.zeros((), dtype=torch.float32,
                                device=next(iter(metrics.values())).device)
        sumsq = mesh.all_reduce(sumsq, mesh.axis_names, "norm")
        params, opt_state = optimizer.apply(params, opt_state, grads,
                                            sumsq=sumsq)
        metrics["grad_norm"] = torch.sqrt(sumsq)
        return params, opt_state, metrics
    return train_step


# ---------------------------------------------------------------------------
# blocks and the whole tree
# ---------------------------------------------------------------------------


def _axes(entry: Any) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def assemble(blocks: Sequence[Any], specs: Any,
             shape: Dict[str, int]) -> Any:
    """The whole tree from every rank's blocks (``blocks[r]`` rank r's,
    cut by ``specs`` on a mesh of ``shape``): each leaf built from the
    ranks' blocks at their places. Raises ``AssertionError`` where two
    ranks that hold the same block hold different bits (a replicated
    leaf that drifted)."""
    meshes = [Mesh(shape, rank=r) for r in range(len(blocks))]

    def build(path, first, spec):
        whole = first.new_empty([d * math.prod(shape[a] for a in _axes(e))
                                 for d, e in zip(first.shape, spec)])
        held: Dict[tuple, torch.Tensor] = {}
        for r, m in enumerate(meshes):
            t = _at(blocks[r], path)
            key = tuple(m.coords[a] for e in spec for a in _axes(e))
            if key in held:
                if not torch.equal(held[key], t):
                    raise AssertionError(f"{'/'.join(path)}: ranks holding "
                                         f"block {key} differ")
                continue
            held[key] = t
            sh.block(whole, spec, m, m.coords).copy_(t)
        return whole
    return sh.map_with_specs(build, blocks[0], specs)


def _at(tree: Any, path) -> Any:
    for k in path:
        tree = tree[int(k[1:-1])] if k.startswith("[") else tree[k]
    return tree


# ---------------------------------------------------------------------------
# cases and the rank entry
# ---------------------------------------------------------------------------

_SUB = {"moe": MoEConfig, "mla": MLAConfig, "ssm": SSMConfig,
        "hybrid": HybridConfig}


def config_from_dict(d: Dict[str, Any]) -> ModelConfig:
    kw = dict(d)
    for name, cls in _SUB.items():
        if kw.get(name) is not None:
            kw[name] = cls(**kw[name])
    return ModelConfig(**kw)


def save_case(path: str, cfg: ModelConfig, params: Any, batch: Any,
              lr: float, eps: float, steps: int,
              tf32: Optional[bool] = None) -> None:
    """A case for the rank entry: the config, the whole weights and batch
    (moved to the host) and AdamW's rate and eps, run ``steps`` steps;
    ``tf32`` set, the card's float32 products and convolutions take TF32
    or not while the case runs (None: torch's settings as they are)."""
    def host(tree):
        return sh.tree_map_with_path(lambda _, t: t.detach().cpu(), tree)
    torch.save({"config": dataclasses.asdict(cfg), "params": host(params),
                "batch": host(batch), "lr": lr, "eps": eps,
                "steps": steps, "tf32": tf32}, path)


@contextlib.contextmanager
def _tf32(allow: Optional[bool]):
    """Products and convolutions with TF32 allowed or not inside the block
    (nothing changed for None); restored on exit."""
    if allow is None:
        yield
        return
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def _timed(dev: torch.device, fn):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def run_case(path: str, mesh: Any, dev: torch.device,
             fsdp: bool) -> Dict[str, Any]:
    """This rank's run of the case at ``path``: its blocks cut from the
    whole weights and batch, ``steps`` sharded steps, and what each step
    counted. Returns its blocks (params, m, v on the host), ``step``, and
    a step's metrics, collectives, wall and collectives' seconds, the
    peak memory (on the card) and the seconds to load and cut the case."""
    t0 = time.perf_counter()
    case = torch.load(path, weights_only=True)
    cfg = config_from_dict(case["config"])
    if mesh.shape[DATA] > 1 and not batch_cut(case["batch"], mesh):
        raise ValueError(f"{path}: the batch does not cut over "
                         f"{mesh.shape[DATA]} data ranks")
    specs = sh.param_specs(cfg, case["params"], mesh, fsdp=fsdp)
    blocks = sh.map_with_specs(
        lambda _, t, s: sh.block(t, s, mesh, mesh.coords).to(dev,
                                                             copy=True),
        case["params"], specs)
    batch = sh.map_with_specs(
        lambda _, t, s: sh.block(t, s, mesh, mesh.coords).to(dev,
                                                             copy=True),
        case["batch"], sh.batch_specs(case["batch"], mesh))
    del case["params"]
    opt = optim.adamw(case["lr"], eps=case["eps"])
    state = opt.init(blocks)
    step = make_sharded_train_step(cfg, opt, mesh, fsdp=fsdp)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out: Dict[str, Any] = {"metrics": [], "collectives": [], "wall_s": [],
                           "collective_s": [],
                           "setup_s": time.perf_counter() - t0}
    with _tf32(case["tf32"]):
        for _ in range(case["steps"]):
            mesh.reset_counts()
            (blocks, state, metrics), wall = _timed(
                dev, lambda: step(blocks, state, batch))
            out["metrics"].append({k: v.item() for k, v in metrics.items()})
            out["collectives"].append(mesh.collectives)
            out["wall_s"].append(wall)
            out["collective_s"].append(mesh.collective_s)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)

    def host(tree):
        return sh.tree_map_with_path(lambda _, t: t.cpu(), tree)
    out.update(params=host(blocks), m=host(state["m"]), v=host(state["v"]),
               step=int(state["step"]))
    return out


def output_path(out_dir: str, case: str, rank: int) -> str:
    name = os.path.splitext(os.path.basename(case))[0]
    return os.path.join(out_dir, f"{name}.rank{rank}.pt")


def load_outputs(out_dir: str, case: str, world: int) -> List[Dict]:
    """Every rank's output of the case at ``case`` (its path)."""
    return [torch.load(output_path(out_dir, case, r), weights_only=True)
            for r in range(world)]


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.launch import mesh as mesh_lib
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", action="append", required=True,
                    help="a case file (save_case); repeatable")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", required=True,
                    help="directory each rank writes its outputs to")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds all ranks may take")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is None:
        rest = list(argv if argv is not None else sys.argv[1:])
        outs = mesh_lib.spawn_ranks(
            ["-m", "repro_torch.sharding.training", *rest],
            args.data * args.model, args.timeout)
        for r, o in enumerate(outs):
            print(f"--- rank {r} ---\n{o}", end="")
        return 0
    import torch.distributed as dist
    torch.set_num_threads(1)
    dev = mesh_lib.init_rank(args.rank, args.world, args.init, args.device)
    try:
        mesh = mesh_lib.make_local_mesh(model=args.model)
        if mesh.shape[DATA] != args.data:
            raise ValueError(f"{args.world} ranks at model={args.model} make "
                             f"data={mesh.shape[DATA]}, not {args.data}")
        for case in args.case:
            out = run_case(case, mesh, dev, args.fsdp)
            t0 = time.perf_counter()
            torch.save(out, output_path(args.out, case, args.rank))
            saved = time.perf_counter() - t0
            peak = ("" if out["peak_bytes"] is None else
                    f", peak {out['peak_bytes'] / 2 ** 30:.2f} GiB")
            print(f"{os.path.basename(case)} on {mesh.shape} (fsdp "
                  f"{args.fsdp}): loss "
                  f"{[m['loss'] for m in out['metrics']]}, step walls "
                  f"{[round(w * 1e3, 1) for w in out['wall_s']]} ms, "
                  f"collectives {[round(c * 1e3, 1) for c in out['collective_s']]}"
                  f" ms{peak}; loaded and cut in {out['setup_s']:.1f} s, "
                  f"written in {saved:.1f} s", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
