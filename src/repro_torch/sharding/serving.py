"""Sharded paged serving: tensor-parallel prefill / decode / verify of the
serving stack over a mesh of ranks (port of ``repro/sharding/serving.py``).

A ``ShardedServingContext`` wraps a ``DualStreamExecutor`` and re-exposes
the paged in-flight stages (``cloud_prefix`` / ``pool_write`` /
``cloud_decode_rows`` / ``cloud_verify_rows``) plus the Context-stream
draft stages on this rank's slice of the LLM, so ``InflightDecoder``,
``DualStreamExecutor`` and the engine work unchanged on top. Every other
stage (edge, SAM tail, mask decode, the closed microbatch paths) is the
wrapped executor's, replicated on every rank.

Layout (the megatron discipline the training specs already use):

  * params: the LLM is cut once by the ``specs.param_specs`` key-path
    rules. ``wq``/``wk``/``wv`` (and biases), ``w_gate`` and ``w_up`` are
    column-parallel, so a rank computes H/m query heads over K/m kv heads
    and d_ff/m of the MLP; ``wo`` and ``w_down`` are row-parallel, and the
    ranks' partial products are summed (``all_reduce``) in float32 and
    rounded once; ``embed`` is vocab-sharded (a masked local lookup, then
    a sum) and so is the answer head (the rank's logit columns in a
    zero-filled full row, then a sum; adding zeros is exact). Norms and
    ``seg_proj`` replicate. A collective runs only where a weight's spec
    was cut: where ``_maybe`` falls back to replication, that layer
    computes whole on every rank and sums nothing (``models.common``'s
    ``row_linear`` / ``embed_rows`` / ``vocab_linear``).
  * paged KV pool: the kv-heads axis over "model", the page axis whole
    (``specs.serving_specs``), so a page-table gather stays local to the
    rank and page-table updates never cross ranks.
  * page tables, positions, token ids, logits: replicated. The sums come
    out the same on every rank, so every rank holds the same logits bit
    for bit and chooses the same tokens.

SPMD, as the reference's single program is: every rank runs the same host
loop (engine, decoder, pool) on the same submissions, and the replicated
logits keep the loops in lockstep.

Kernels, the one departure from the reference: it pins
``use_flash_decode=False`` because its Pallas kernels run in interpret
mode and cannot lower inside a GSPMD partition, and it says to turn the
kernel on per shard on real hardware. This context keeps the executor's
``flash_decode``: on CUDA each rank's paged decode, paged verify and
draft decode launch the hand-written kernels on its K/m heads. On the CPU
the plain versions run, as everywhere in the port.

Exactness: sharding changes where each head's arithmetic runs and the
order of the output projections' sums, not the computation.

Run the selftest; the module spawns its ranks itself (``launch.mesh``)::

    PYTHONPATH=src python -m repro_torch.sharding.serving --model=2 \\
        [--device cpu] [--weights DIR] [--engine] [--out FILE]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import vlm
from repro_torch.core.streams import DualStreamExecutor
from repro_torch.models.common import tensor_parallel
from repro_torch.sharding import specs as sh

MODEL_AXIS = "model"


class TensorParallel:
    """The collectives of one rank's slice of a model (the object
    ``models.common.tensor_parallel`` installs): which layers are cut
    (``kinds``: "attn", "mlp", "embed", "head"), this rank's place on the
    "model" axis, and the sum over it through the owning context's
    ``all_reduce``."""

    def __init__(self, owner: "ShardedServingContext", kinds):
        self.owner = owner
        self.kinds = frozenset(kinds)
        self.index = owner.mesh.coords[MODEL_AXIS]
        self.size = owner.model_shards

    def sharded(self, kind: str) -> bool:
        return kind in self.kinds

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.owner.all_reduce(t)

    def block_input(self, x: torch.Tensor) -> torch.Tensor:
        return x


class PoolPlacement:
    """``PagePool(placement=)`` of a sharded context: each k/v leaf of the
    pool tree as this rank's block of its kv-heads axis (second-to-last,
    ``specs.serving_specs``), the page axis whole. A pool made from this
    rank's prefill is that block already and passes as it is; a whole
    pool is cut. ``split`` is how many blocks the axis is cut into (1
    where ``_maybe`` leaves it whole): the pool's byte counts scale by it."""

    def __init__(self, mesh: Any, kv_heads: int):
        self.mesh = mesh
        self.kv_heads = kv_heads
        self.split = (mesh.shape[MODEL_AXIS] if sh._maybe(
            kv_heads, MODEL_AXIS, mesh) else 1)

    def __call__(self, kv: Dict) -> Dict:
        heads = {leaf.shape[-2] for _, leaf in sh.leaves_with_paths(kv)}
        if heads == {self.kv_heads // self.split}:
            return kv
        if heads != {self.kv_heads}:
            raise ValueError(f"pool leaves hold {sorted(heads)} kv heads, "
                             f"neither {self.kv_heads} nor this rank's "
                             f"{self.kv_heads // self.split}")
        return sh.shard_tree(kv, sh.serving_specs(kv, self.mesh), self.mesh,
                             self.mesh.coords)


class ShardedServingContext:
    """Executor facade that runs the paged serving stack tensor-parallel.

    Holds this rank's slice of the LLM (cut once at construction) inside
    an executor of its own (``shard``: the same ``DualStreamExecutor``
    stages over the local heads), and runs those stages under
    ``models.common.tensor_parallel``. ``params`` stays the whole tree, as
    the reference's context holds the sharded whole. Edge stages, SAM
    tail, mask decode and the closed microbatch paths delegate to the
    wrapped executor. ``all_reduces`` counts the sums this rank joined.
    """

    def __init__(self, executor: Any, mesh: Any):
        if mesh.coords is None:
            raise ValueError("ShardedServingContext needs a local mesh "
                             "(launch.mesh.make_local_mesh), not an "
                             "abstract one")
        self.inner = executor
        self.mesh = mesh
        self.pcfg = executor.pcfg
        self.page_size = executor.page_size
        self.max_new_tokens = executor.max_new_tokens
        self.lut = executor.lut
        self.device = executor.device
        self.params = executor.params
        self.model_shards = (mesh.shape[MODEL_AXIS]
                             if MODEL_AXIS in mesh.axis_names else 1)
        self.all_reduces = 0
        self.place_pool = PoolPlacement(mesh, self.pcfg.llm.num_kv_heads)
        self._cuts: Dict[Tuple[int, ...], Tuple[List[Any], dict]] = {}
        local, pcfg, self.tp = self._cut(executor.pcfg, executor.params)
        self.shard = DualStreamExecutor(
            pcfg=pcfg, params=local, bottlenecks={}, lut=executor.lut,
            buckets=executor.buckets,
            max_new_tokens=executor.max_new_tokens,
            flash_decode=executor.flash_decode,
            page_size=executor.page_size, device=executor.device)

    def __getattr__(self, name: str) -> Any:
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    @property
    def num_compiled_stages(self) -> int:
        return self.inner.num_compiled_stages

    # ---- the collective ----

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the mesh's "model" axis, in place."""
        dist.all_reduce(t, group=self.mesh.model_group)
        self.all_reduces += 1
        return t

    # ---- this rank's slice of an LLM ----

    def _cut(self, pcfg: Any, params: dict
             ) -> Tuple[dict, Any, TensorParallel]:
        """This rank's slice of a LISA LLM (``params["llm"]`` and the
        replicated ``seg_proj``, what the LLM stages read): (local params,
        the pipeline config with the local head counts, its
        ``TensorParallel``). A slice of the same weights is cut once."""
        llm = pcfg.llm
        if llm.arch_type != "dense" or llm.attn_type != "gqa":
            raise ValueError(f"sharded serving runs a dense GQA LLM, not "
                             f"{llm.arch_type}/{llm.attn_type}")
        view = {"llm": params["llm"], "seg_proj": params["seg_proj"]}
        specs = sh.param_specs(llm, view, self.mesh)
        m = self.model_shards
        group = specs["llm"]["groups"][0]
        kinds = set()
        cols = [s[-1] for n, s in group["attn"].items() if n != "wo"]
        if group["attn"]["wo"][-2] == MODEL_AXIS:
            if any(c != MODEL_AXIS for c in cols) or llm.num_kv_heads % m:
                raise ValueError(f"attention of {llm.num_heads} heads over "
                                 f"{llm.num_kv_heads} kv heads does not cut "
                                 f"at head boundaries into {m}")
            kinds.add("attn")
            llm = llm.replace(num_heads=llm.num_heads // m,
                              num_kv_heads=llm.num_kv_heads // m,
                              head_dim=llm.resolved_head_dim)
        elif any(c is not None for c in cols):
            raise ValueError("q/k/v columns cut while wo's rows are whole")
        mlp = group["mlp"]
        if mlp["w_down"][-2] == MODEL_AXIS:
            if any(s[-1] != MODEL_AXIS for n, s in mlp.items()
                   if n != "w_down"):
                raise ValueError("w_down's rows cut while the up "
                                 "projections' columns are whole")
            kinds.add("mlp")
            llm = llm.replace(d_ff=llm.d_ff // m)
        if specs["llm"]["embed"][0] == MODEL_AXIS:
            kinds.add("embed")
        if specs["llm"]["answer_head"][-1] == MODEL_AXIS:
            kinds.add("head")
        leaves = [t for _, t in sh.leaves_with_paths(view)]
        key = tuple(id(t) for t in leaves)
        if key not in self._cuts:
            # the source leaves ride along so their ids stay theirs
            self._cuts[key] = (leaves, sh.shard_tree(view, specs, self.mesh,
                                                     self.mesh.coords))
        local = self._cuts[key][1]
        return (local, dataclasses.replace(pcfg, llm=llm),
                TensorParallel(self, kinds))

    # ---- the paged in-flight stages (InflightDecoder's contract) ----

    def cloud_prefix(self, ctx, query) -> Tuple[np.ndarray, Dict]:
        with tensor_parallel(self.tp):
            return self.shard.cloud_prefix(ctx, query)

    def pool_write(self, pool: Dict, paged_kv: Dict, page_ids) -> Dict:
        return self.shard.pool_write(pool, paged_kv, page_ids)

    def cloud_decode_rows(self, pool: Dict, page_table, positions, tokens,
                          pos, write_slot) -> Tuple[Any, Any, Dict]:
        with tensor_parallel(self.tp):
            return self.shard.cloud_decode_rows(pool, page_table, positions,
                                                tokens, pos, write_slot)

    def cloud_verify_rows(self, pool: Dict, page_table, positions, tokens,
                          pos, write_slot, chunk_len
                          ) -> Tuple[Any, Any, Dict]:
        with tensor_parallel(self.tp):
            return self.shard.cloud_verify_rows(pool, page_table, positions,
                                                tokens, pos, write_slot,
                                                chunk_len)

    # ---- the Context draft stages (DraftModel's fns_factory hook) ----

    def draft_fns(self, pcfg: Any, width: int, params: dict
                  ) -> Tuple[Callable, Callable, Callable]:
        """Sharded draft-model stages: the contract of
        ``speculative._draft_fns`` (prefill, step, insert) over this
        rank's slice of the draft, whose contiguous ring cache then holds
        this rank's kv heads. The draft may run another geometry
        (``lisa_nano``) than the target: its slice is cut by its own
        parameter tree. ``params`` is the tree every call passes again
        (the draft's whole tree); the stages run its slice."""
        from repro_torch.engine.speculative import DraftModel
        local, lcfg, tp = self._cut(pcfg, params)

        def prefill(p, ctx, query):
            with tensor_parallel(tp):
                return vlm.llm_prefill(local, lcfg, ctx, query, width=width)

        def step(p, cache, tokens, pos):
            with tensor_parallel(tp):
                return vlm.llm_decode_step(local, lcfg, cache, tokens, pos)

        return prefill, step, DraftModel._insert_row


# ---------------------------------------------------------------------------
# selftest: sharded decode + verify token-exact vs unsharded generate
# ---------------------------------------------------------------------------


def same_on_all_ranks(arrays: List[np.ndarray], device: Any) -> bool:
    """Whether every rank holds the same bits in ``arrays``: rank 0's,
    broadcast, against this rank's (float64 holds float32 and int32
    exactly)."""
    flat = np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in arrays])
    mine = torch.from_numpy(flat).to(device)
    theirs = mine.clone()
    dist.broadcast(theirs, src=0)
    return bool(torch.equal(mine, theirs))


def selftest_requests(executor: Any, n_requests: int) -> List[Tuple]:
    """The selftest's (packet, query, intent) triples: Insight at two
    tiers and Context, from ``floodseg`` frames of ``RandomState(3)``."""
    from repro_torch.core.intent import Intent
    from repro_torch.data import floodseg
    rng = np.random.RandomState(3)
    lut = executor.lut
    reqs = []
    for i in range(n_requests):
        kind = "any" if i % 3 == 2 else "segment"
        b = floodseg.make_batch(rng, 1, kind, augment=False)
        if kind == "any":
            pkt, _ = executor.edge_context(b["images"], i, 0.0)
            reqs.append((pkt, b["query"], Intent.CONTEXT))
        else:
            pkt = executor.edge_insight(b["images"], lut.tiers[i % 2], i, 0.0)
            reqs.append((pkt, b["query"], Intent.INSIGHT))
    return reqs


def _selftest(model: int = 2, n_requests: int = 3, answer_tokens: int = 3,
              executor: Any = None, device: Any = "cuda",
              weights: Optional[str] = None) -> Dict[str, Any]:
    """End-to-end exactness pin on the local mesh: sharded paged decode
    and sharded speculative verify against the unsharded one-shot generate
    path, and every rank's outputs bit-equal. The in-process test hands in
    its ``executor``; else a lisa-mini one is built from ``weights`` (a
    checkpoint-store directory of ``{"params", "bottlenecks"}``) or from
    random weights. Returns what each mode served, for the caller."""
    from repro_torch.core.intent import Intent
    from repro_torch.core.paging import PagePool
    from repro_torch.engine.inflight import InflightDecoder
    from repro_torch.engine.speculative import SpeculativeConfig
    from repro_torch.launch.mesh import make_local_mesh

    if executor is None:
        executor = _mini_executor(device, weights, answer_tokens)
    mesh = make_local_mesh(model=model)
    ctx = ShardedServingContext(executor, mesh)
    reqs = selftest_requests(executor, n_requests)
    out: Dict[str, Any] = {"kinds": sorted(ctx.tp.kinds),
                           "model_shards": ctx.model_shards,
                           "packets": [p for p, _, _ in reqs],
                           "queries": [q for _, q, _ in reqs]}
    for mode, spec in (("decode", None),
                       ("verify", SpeculativeConfig(draft_tokens=2))):
        pool = PagePool(page_size=ctx.page_size, placement=ctx.place_pool,
                        shards=ctx.model_shards)
        dec = InflightDecoder(ctx, slots=2, pool=pool, spec=spec)
        done: Dict[int, Dict] = {}
        before = ctx.all_reduces
        for i, (pkt, q, it) in enumerate(reqs):
            dec.submit(i, it, pkt, q,
                       lambda o: done.setdefault(o["seq_id"], o))
        dec.drain()
        served = []
        for i, (pkt, q, it) in enumerate(reqs):
            ref = executor.cloud_generate_batch([pkt], [q])[0]
            got = done[i]
            assert np.array_equal(got["tokens"], ref[-1]), (mode, i)
            np.testing.assert_allclose(
                got["answer_logits"],
                ref[-2] if it is Intent.CONTEXT else ref[1], atol=1e-3)
            arrs = [np.asarray(got["tokens"]),
                    np.asarray(got["answer_logits"])]
            if it is Intent.INSIGHT:
                np.testing.assert_allclose(got["mask_logits"], ref[0],
                                           atol=1e-3)
                arrs.append(np.asarray(got["mask_logits"]))
            served.append(arrs)
        stats = pool.stats()
        assert stats["kv_pool_bytes"] > 0
        assert stats["kv_pool_bytes_per_shard"] \
            == stats["kv_pool_bytes"] // ctx.model_shards
        if mesh.size > 1:
            assert same_on_all_ranks([a for arrs in served for a in arrs],
                                     executor.device), mode
        out[mode] = {"served": served, "pool": stats,
                     "all_reduces": ctx.all_reduces - before}
    print(f"sharded serving selftest: decode + speculative verify "
          f"token-exact on mesh {mesh.shape} (model_shards="
          f"{ctx.model_shards}, ranks={mesh.size}, sharded "
          f"{sorted(ctx.tp.kinds) or 'nothing'}, all-reduces "
          f"{out['decode']['all_reduces']} + {out['verify']['all_reduces']})",
          flush=True)
    return out


def _engine_selftest(executor: Any, model: int = 2) -> Dict[str, Any]:
    """``AveryEngine(mesh=)`` against the unsharded engine on the same
    executor: the selftest's requests through ``submit_packet``, plain,
    with ``speculative=2`` (the serving weights draft) and with
    ``speculative="nano"`` (the ``lisa_nano`` draft, its own slice);
    tokens equal, logits and masks within atol 1e-3, ``stats()``
    telemetry of the mesh."""
    from repro_torch.engine.engine import AveryEngine
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(model=model)
    reqs = selftest_requests(executor, 3)
    out: Dict[str, Any] = {}
    for name, spec in (("plain", None), ("speculative", 2),
                       ("nano", "nano")):
        runs = []
        for m in (mesh, None):
            eng = AveryEngine(executor.lut, executor=executor, mesh=m,
                              batching="inflight", max_batch=2,
                              speculative=spec)
            futs = [eng.submit_packet(p, q, it, time_s=0.4 * i)
                    for i, (p, q, it) in enumerate(reqs)]
            eng.drain()
            runs.append(([f.result() for f in futs], eng.stats))
        (sharded, stats), (plain, _) = runs
        for a, b in zip(sharded, plain):
            assert np.array_equal(a.tokens, b.tokens), spec
            np.testing.assert_allclose(a.answer_logits, b.answer_logits,
                                       atol=1e-3)
            if b.mask_logits is not None:
                np.testing.assert_allclose(a.mask_logits, b.mask_logits,
                                           atol=1e-3)
        assert stats["mesh_devices"] == mesh.size
        assert stats["model_shards"] == mesh.shape[MODEL_AXIS]
        assert stats["kv_pool_bytes_per_shard"] \
            == stats["kv_pool_bytes"] // mesh.shape[MODEL_AXIS]
        if mesh.size > 1:
            assert same_on_all_ranks(
                [np.asarray(r.tokens) for r in sharded]
                + [np.asarray(r.answer_logits) for r in sharded],
                executor.device), spec
        out[name] = {
            "tokens": [np.asarray(r.tokens) for r in sharded],
            "stats": {k: stats[k] for k in (
                "mesh_devices", "model_shards", "kv_pool_bytes",
                "kv_pool_bytes_per_shard", "kv_shards")}}
    print(f"sharded serving selftest: AveryEngine(mesh=) token-exact with "
          f"the unsharded engine on mesh {mesh.shape}", flush=True)
    return out


def _mini_executor(device: Any, weights: Optional[str],
                   answer_tokens: int) -> Any:
    from repro_torch import bridge
    from repro_torch.configs.lisa_mini import CONFIG as PCFG
    from repro_torch.core import profile as prof
    from repro_torch.core.lut import paper_lut
    from repro_torch.core.streams import on_card
    lut = paper_lut()
    if weights is not None:
        tree = bridge.load_checkpoint(weights, device)
        params, bns = tree["params"], tree["bottlenecks"]
    else:
        params, bns, _ = prof.random_init_system(PCFG, lut=lut, device=device)
    return DualStreamExecutor(
        pcfg=PCFG, params=params, bottlenecks=bns, lut=lut,
        max_new_tokens=answer_tokens, flash_decode=on_card(device),
        page_size=4, device=device)


def _write(path: str, result: Dict[str, Any]) -> None:
    """The selftest's outputs as one ``.npz``: per mode and request the
    served arrays, the packets' contents, and the pool's telemetry."""
    arrays: Dict[str, np.ndarray] = {}
    for i, (pkt, q) in enumerate(zip(result["packets"], result["queries"])):
        arrays[f"query_{i}"] = np.asarray(q)
        arrays[f"kind_{i}"] = np.asarray(pkt.kind)
        arrays[f"tier_{i}"] = np.asarray(pkt.tier_name or "")
        for k, v in pkt.content.items():
            arrays[f"content_{i}_{k}"] = np.asarray(v)
    for mode in ("decode", "verify"):
        for i, arrs in enumerate(result[mode]["served"]):
            for j, a in enumerate(arrs):
                arrays[f"{mode}_{i}_{j}"] = a
        for k, v in result[mode]["pool"].items():
            arrays[f"{mode}_pool_{k}"] = np.asarray(v)
        arrays[f"{mode}_all_reduces"] = np.asarray(
            result[mode]["all_reduces"])
    arrays["kinds"] = np.asarray(",".join(result["kinds"]))
    for name, run in result.get("engine", {}).items():
        for i, t in enumerate(run["tokens"]):
            arrays[f"engine_{name}_{i}"] = t
        for k, v in run["stats"].items():
            arrays[f"engine_{name}_{k}"] = np.asarray(v)
    np.savez(path, **arrays)


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.launch import mesh as mesh_lib
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", type=int, default=2,
                    help="ranks on the model axis (spawned by this module)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--weights", default=None,
                    help="checkpoint-store directory of lisa-mini "
                    "{params, bottlenecks} (default: random weights)")
    ap.add_argument("--engine", action="store_true",
                    help="also hold AveryEngine(mesh=) to the unsharded "
                    "engine")
    ap.add_argument("--out", default=None,
                    help="rank 0 writes the served outputs to this .npz")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds all ranks may take")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is None:
        # the parent: one process a rank, this module again in each
        rest = list(argv if argv is not None else sys.argv[1:])
        outs = mesh_lib.spawn_ranks(
            ["-m", "repro_torch.sharding.serving", *rest], args.model,
            args.timeout)
        for r, o in enumerate(outs):
            print(f"--- rank {r} ---\n{o}", end="")
        return 0
    torch.set_num_threads(1)
    device = mesh_lib.init_rank(args.rank, args.world, args.init,
                                args.device)
    try:
        with torch.inference_mode():
            executor = _mini_executor(device, args.weights, 3)
            result = _selftest(model=args.model, executor=executor)
            if args.engine:
                result["engine"] = _engine_selftest(executor, args.model)
        if args.out and args.rank == 0:
            _write(args.out, result)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
