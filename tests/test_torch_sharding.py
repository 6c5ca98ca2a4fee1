"""Tensor-parallel paged serving (``repro_torch.sharding``,
``launch/mesh.py``) against the reference.

* Spec parity: the port's key-path rules give the reference's
  ``PartitionSpec`` entries leaf by leaf (``param_specs`` with and without
  FSDP, ``cache_specs``, ``batch_specs``, ``opt_state_specs``) for the ten
  architectures at full size (the port's trees on the meta device, the
  reference's from ``jax.eval_shape``) on the abstract 16x16 and 2x16x16
  meshes, and the reference test's two ``serving_specs`` cases.
* ``make_local_mesh`` clamps and raises as the reference's does, and over
  four initialised ranks builds the (2, 2) mesh whose "model" groups sum
  their own data row.
* One rank: the reference's passing 1x1 test
  (``test_sharded_context_token_exact_on_local_mesh``) twinned on bridged
  ``random_init_system`` lisa-mini weights: the port's selftest at
  ``model=1`` against the reference's ``ShardedServingContext`` on its
  1x1 mesh, tokens equal, logits and masks within atol 1e-3 (the
  reference selftest's), pool telemetry equal.
* Two ranks over gloo, in a subprocess (``python -m
  repro_torch.sharding.serving``, which spawns its ranks) on the
  reference's weights written by its checkpoint store: plain decode and
  speculative verify. Tokens equal the reference's *unsharded*
  ``cloud_generate_batch`` on the same packets, logits and masks within
  atol 1e-3 (they reach 2.0e-6; three ranks, where nothing is cut, read
  1.7e-6: the port's own distance from the reference), the ranks bit-equal (the selftest broadcasts rank 0's
  outputs), each rank's pool half the logical bytes; ``AveryEngine(mesh=)``
  token-exact with the unsharded port engine, plain, drafting with the
  serving weights and with the ``lisa_nano`` draft.
* Fallback: three ranks, where lisa-mini's 4 heads, 256-wide MLP and
  64-token vocab do not divide, so every spec replicates: the same tokens,
  and not one all-reduce.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs.lisa_mini import CONFIG as JP
from repro.core import DualStreamExecutor as JExecutor
from repro.core import packets as jpk
from repro.core.intent import Intent as JIntent
from repro.core.paging import PagePool as JPagePool
from repro.core.profile import random_init_system
from repro.engine.inflight import InflightDecoder as JDecoder
from repro.engine.speculative import SpeculativeConfig as JSpecConfig
from repro.launch import mesh as jmesh
from repro.launch.dryrun import (SHAPES, abstract_cache, abstract_params,
                                 adapt_config, cache_width, input_specs)
from repro.sharding import serving as jserving
from repro.sharding import specs as jsh
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.configs import get_lisa_config
from repro_torch.core import lut as tlut
from repro_torch.core.streams import DualStreamExecutor as TExecutor
from repro_torch.engine.engine import AveryEngine
from repro_torch.launch import mesh as tmesh
from repro_torch.sharding import serving as tserving
from repro_torch.sharding import specs as tsh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TP = get_lisa_config("lisa-mini")
T = 3                                       # max_new_tokens
ATOL = 1e-3                                 # the reference selftest's
SUBPROCESS_TIMEOUT_S = 240


def _abstract_mesh(sizes, names):
    from jax.sharding import AbstractMesh
    try:
        return AbstractMesh(tuple(zip(names, sizes)))
    except TypeError:
        return AbstractMesh(sizes, names)


MESHES = {
    "16x16": (lambda: _abstract_mesh((16, 16), ("data", "model")),
              lambda: tmesh.make_production_mesh()),
    "2x16x16": (lambda: _abstract_mesh((2, 16, 16),
                                       ("pod", "data", "model")),
                lambda: tmesh.make_production_mesh(multi_pod=True)),
}


def _port_cfg(jcfg):
    """The port's ModelConfig with the reference config's fields."""
    sub = {"moe": tmodels.MoEConfig, "mla": tmodels.MLAConfig,
           "ssm": tmodels.SSMConfig, "hybrid": tmodels.HybridConfig}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in sub.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return tmodels.ModelConfig(**kw)


def _ref_flat(specs):
    """Reference specs by key path (``groups/[0]/attn/wq``)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    out = {}
    for path, spec in flat:
        names = [str(k.key) if hasattr(k, "key") else f"[{k.idx}]"
                 for k in path]
        out["/".join(names)] = spec
    return out


def _port_flat(specs):
    out = {}

    def walk(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, pre + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, pre + (f"[{i}]",))
        else:
            out["/".join(pre)] = t
    walk(specs, ())
    return out


def _assert_same_specs(port, ref):
    got, want = _port_flat(port), _ref_flat(ref)
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in want if P(*got[k]) != want[k]}
    assert not bad, bad


def _meta(tree):
    """ShapeDtypeStructs as meta tensors (shapes are all the rules read)."""
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), tree)


# ---- spec parity ----


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_state_specs_equal_reference(arch, mesh):
    jm, tm = MESHES[mesh][0](), MESHES[mesh][1]()
    jcfg = jget_config(arch)
    cfg = tconfigs.get_config(arch)
    aparams = abstract_params(jcfg)
    params = tmodels.init_params(cfg, torch.Generator(), device="meta")
    for fsdp in (False, True):
        want = jsh.param_specs(jcfg, aparams, jm, fsdp=fsdp)
        got = tsh.param_specs(cfg, params, tm, fsdp=fsdp)
        _assert_same_specs(got, want)
        aopt = {"step": None, "m": None, "v": None}
        jopt = jsh.opt_state_specs(jcfg, aopt, want, jm)
        topt = tsh.opt_state_specs(cfg, aopt, got, tm)
        assert topt["step"] == () and jopt["step"] == P()
        _assert_same_specs(topt["m"], jopt["m"])
        _assert_same_specs(topt["v"], jopt["v"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_reference(arch):
    """Caches at the decode_32k shape (where the reference's dry-run serves
    the arch) and the train_4k batch, on both abstract meshes."""
    for mesh in MESHES:
        jm, tm = MESHES[mesh][0](), MESHES[mesh][1]()
        shape = SHAPES["decode_32k"]
        jcfg = adapt_config(jget_config(arch), shape)
        if jcfg is not None:
            cfg = _port_cfg(jcfg)
            cache = tmodels.init_cache(cfg, shape.global_batch,
                                       cache_width(jcfg, shape),
                                       device="meta")
            _assert_same_specs(tsh.cache_specs(cfg, cache, tm),
                               jsh.cache_specs(jcfg, abstract_cache(
                                   jcfg, shape), jm))
        jcfg = jget_config(arch)
        batch = input_specs(jcfg, SHAPES["train_4k"])
        _assert_same_specs(tsh.batch_specs(_meta(batch), tm),
                           jsh.batch_specs(batch, jm))


def _sds(shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def test_serving_specs_equal_reference():
    """``tests/test_sharding.py``'s two serving cases: KV leaves (pool,
    paged prefix, draft ring) shard the kv-heads axis over "model" with the
    page/batch axes whole; non-divisible kv heads, page tables, positions,
    tokens, logits and per-row scalars replicate."""
    jm, tm = MESHES["16x16"][0](), MESHES["16x16"][1]()
    cases = [
        {"groups": [{"k": _sds((4, 64, 16, 32, 8)),
                     "v": _sds((4, 64, 16, 32, 8))}]},
        {"k": _sds((4, 1, 3, 16, 32, 8))},
        {"k": _sds((4, 8, 64, 32, 8))},
        {"groups": [{"k": _sds((4, 64, 16, 6, 8)),
                     "v": _sds((4, 64, 16, 6, 8))}],
         "page_table": jax.ShapeDtypeStruct((8, 6), jnp.int32),
         "positions": jax.ShapeDtypeStruct((8, 96), jnp.int32),
         "tokens": jax.ShapeDtypeStruct((8, 1), jnp.int32),
         "logits": _sds((8, 32000)),
         "pos": jax.ShapeDtypeStruct((8,), jnp.int32)},
    ]
    for tree in cases:
        _assert_same_specs(tsh.serving_specs(_meta(tree), tm),
                           jsh.serving_specs(tree, jm))
    pool = tsh.serving_specs(_meta(cases[0]), tm)
    assert pool["groups"][0]["k"] == (None, None, None, "model", None)


def test_shard_tree_cuts_each_named_axis():
    """``shard_tree`` gives rank (data 1, model 2) of a 2x4 mesh its
    block: a column-parallel leaf's last axis, a batch leaf's first axis
    over "data", a replicated leaf shared, not copied."""
    mesh = tmesh.Mesh({"data": 2, "model": 4}, rank=6)
    assert mesh.coords == {"data": 1, "model": 2}
    w = torch.arange(2 * 8 * 16.).reshape(2, 8, 16)
    b = torch.arange(6 * 3.).reshape(6, 3)
    norm = torch.ones(8)
    tree = {"wq": w, "tokens": b, "norm": norm}
    specs = {"wq": (None, None, "model"), "tokens": ("data", None),
             "norm": (None,)}
    out = tsh.shard_tree(tree, specs, mesh, mesh.coords)
    assert torch.equal(out["wq"], w[:, :, 8:12])
    assert torch.equal(out["tokens"], b[3:])
    assert out["norm"] is norm


def test_make_local_mesh_clamps_and_rejects():
    """As the reference's ``make_local_mesh`` (tests/test_sharding.py:156):
    more model shards than ranks clamps to the ranks there are (here this
    process alone), a model axis below 1 raises."""
    mesh = tmesh.make_local_mesh(model=8)
    assert mesh.size == 1
    assert mesh.shape["model"] >= 1 and mesh.shape["data"] >= 1
    assert mesh.coords == {"data": 0, "model": 0}
    with pytest.raises(ValueError):
        tmesh.make_local_mesh(model=0)


# one rank of a four-rank world: a (2, 2) local mesh, each data row's
# "model" group summing its own ranks; model=3 does not divide 4
RANK_MESH = """
import sys
sys.path.insert(0, {src!r})
import torch
import torch.distributed as dist
from repro_torch.launch import mesh as m
a = sys.argv
r, w, i = (a[a.index(k) + 1] for k in ("--rank", "--world", "--init"))
m.init_rank(int(r), int(w), i, "cpu")
try:
    m.make_local_mesh(model=3)
except ValueError:
    print("model=3 refused")
mesh = m.make_local_mesh(model=2)
t = torch.tensor([float(r)])
dist.all_reduce(t, group=mesh.model_group)
print("shape", mesh.shape, "coords", mesh.coords, "sum", t.item())
dist.destroy_process_group()
"""


def test_make_local_mesh_groups_each_data_row():
    """Over four initialised ranks, ``make_local_mesh(model=2)`` is the
    (2, 2) mesh: each rank's coordinates row-major, and an all-reduce
    over its "model" group sums its data row's two ranks only (0 + 1,
    2 + 3); a model axis that does not divide the world raises."""
    outs = tmesh.spawn_ranks(
        ["-c", RANK_MESH.format(src=str(ROOT / "src"))], 4, 120)
    for r, out in enumerate(outs):
        row = r // 2
        assert "model=3 refused" in out, out
        assert (f"shape {{'data': 2, 'model': 2}} coords {{'data': {row}, "
                f"'model': {r % 2}}} sum {float(4 * row + 1)}") in out, out


# ---- serving: the reference's weights and packets ----


@pytest.fixture(scope="module")
def system():
    params, bns, lut = random_init_system(JP, seed=0)
    jex = JExecutor(pcfg=JP, params=params, bottlenecks=bns, lut=lut,
                    max_new_tokens=T, flash_decode=False, page_size=4)
    tex = TExecutor(pcfg=TP, params=jax.tree.map(np.asarray, params),
                    bottlenecks=jax.tree.map(np.asarray, bns),
                    lut=tlut.paper_lut(), max_new_tokens=T,
                    flash_decode=True, page_size=4, device="cpu")
    return jex, tex, params, bns


def _ref_packet(pkt):
    c = {k: np.asarray(v) for k, v in pkt.content.items()}
    if pkt.kind == "context":
        return jpk.make_context_packet(pkt.seq_id, pkt.created_at, c["ctx"])
    return jpk.make_insight_packet(pkt.seq_id, pkt.created_at, pkt.tier_name,
                                   c["codes"], c["scales"],
                                   clip_feats=c["clip"])


def _ref_outputs(jex, packets, queries):
    """The reference's unsharded one-shot generate path on each packet:
    (tokens, answer logits, mask logits or None)."""
    out = []
    for pkt, q in zip(packets, queries):
        ref = jex.cloud_generate_batch([pkt], [q])[0]
        if pkt.kind == "context":
            out.append((np.asarray(ref[-1]), np.asarray(ref[0]), None))
        else:
            out.append((np.asarray(ref[-1]), np.asarray(ref[1]),
                        np.asarray(ref[0])))
    return out


def _held(served, ref, label):
    """Tokens equal; logits (and masks) within ATOL. Returns the largest
    float difference."""
    worst = 0.0
    for i, (arrs, (tok, logits, mask)) in enumerate(zip(served, ref)):
        assert np.array_equal(arrs[0], tok), (label, i)
        worst = max(worst, float(np.abs(arrs[1] - logits).max()))
        if mask is not None:
            worst = max(worst, float(np.abs(arrs[2] - mask).max()))
    assert worst <= ATOL, (label, worst)
    return worst


def _ref_sharded_stats(jex, packets, queries):
    """The reference's ``ShardedServingContext`` on its 1x1 local mesh
    (its own passing test's setting): per mode, the tokens and the pool's
    ``stats()``."""
    mesh = jmesh.make_local_mesh(model=1)
    ctx = jserving.ShardedServingContext(jex, mesh)
    out = {}
    for mode, spec in (("decode", None),
                       ("verify", JSpecConfig(draft_tokens=2))):
        pool = JPagePool(page_size=ctx.page_size, placement=ctx.place_pool,
                         shards=ctx.model_shards)
        dec = JDecoder(ctx, slots=2, pool=pool, spec=spec)
        done = {}
        for i, (pkt, q) in enumerate(zip(packets, queries)):
            it = JIntent.CONTEXT if pkt.kind == "context" else JIntent.INSIGHT
            dec.submit(i, it, pkt, q,
                       lambda o: done.setdefault(o["seq_id"], o))
        dec.drain()
        out[mode] = ([np.asarray(done[i]["tokens"])
                      for i in range(len(packets))], pool.stats())
    return out


POOL_KEYS = ("kv_pool_bytes", "kv_pool_bytes_per_shard", "kv_shards")


@pytest.fixture(scope="module")
def one_rank(system):
    jex, tex, _, _ = system
    with torch.inference_mode():
        res = tserving._selftest(model=1, executor=tex)
    packets = [_ref_packet(p) for p in res["packets"]]
    ref = _ref_outputs(jex, packets, res["queries"])
    return res, packets, ref


def test_one_rank_context_equals_reference(system, one_rank):
    jex = system[0]
    res, packets, ref = one_rank
    jstats = _ref_sharded_stats(jex, packets, res["queries"])
    for mode in ("decode", "verify"):
        _held(res[mode]["served"], ref, mode)
        jtokens, jpool = jstats[mode]
        assert all(np.array_equal(a[0], b)
                   for a, b in zip(res[mode]["served"], jtokens)), mode
        got = res[mode]["pool"]
        assert {k: got[k] for k in POOL_KEYS} \
            == {k: jpool[k] for k in POOL_KEYS}, mode
        assert res[mode]["all_reduces"] == 0
    assert res["kinds"] == [] and res["model_shards"] == 1


def _run_module(args, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.sharding.serving", *args,
         "--device", "cpu", "--timeout", str(SUBPROCESS_TIMEOUT_S - 20)],
        capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S,
        env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc.stdout


@pytest.fixture(scope="module")
def weights_dir(system, tmp_path_factory):
    """The reference's weights, written by its checkpoint store."""
    from repro.checkpoint.store import save_pytree
    _, _, params, bns = system
    path = tmp_path_factory.mktemp("weights") / "lisa_mini"
    save_pytree(str(path), {"params": params, "bottlenecks": bns})
    return str(path)


def _served(npz, mode, n):
    out = []
    for i in range(n):
        arrs = [npz[f"{mode}_{i}_{j}"] for j in range(3)
                if f"{mode}_{i}_{j}" in npz]
        out.append(arrs)
    return out


def _packets_of(npz, n):
    from repro_torch.core import packets as tpk
    pkts, queries = [], []
    for i in range(n):
        kind = str(npz[f"kind_{i}"])
        content = {k.split("_", 2)[2]: npz[k] for k in npz.files
                   if k.startswith(f"content_{i}_")}
        tier = str(npz[f"tier_{i}"]) or None
        pkts.append(_ref_packet(tpk.Packet(
            kind=kind, tier_name=tier, seq_id=i, created_at=0.0,
            payload_bytes=0, content=content)))
        queries.append(npz[f"query_{i}"])
    return pkts, queries


def test_two_ranks_over_gloo_equal_unsharded_reference(system, one_rank,
                                                       weights_dir,
                                                       tmp_path):
    jex = system[0]
    out = tmp_path / "two.npz"
    log = _run_module(["--model=2", "--weights", weights_dir, "--engine",
                       "--out", str(out)], tmp_path)
    assert log.count("token-exact") == 4, log      # 2 ranks x 2 checks
    npz = np.load(out)
    packets, queries = _packets_of(npz, 3)
    ref = _ref_outputs(jex, packets, queries)
    one_pool = one_rank[0]["decode"]["pool"]
    assert str(npz["kinds"]) == "attn,embed,head,mlp"
    for mode in ("decode", "verify"):
        _held(_served(npz, mode, 3), ref, mode)
        total = int(npz[f"{mode}_pool_kv_pool_bytes"])
        assert int(npz[f"{mode}_pool_kv_shards"]) == 2
        assert int(npz[f"{mode}_pool_kv_pool_bytes_per_shard"]) \
            == total // 2
        # the logical pool is the one rank's whole pool of the same run
        assert total == one_rank[0][mode]["pool"]["kv_pool_bytes"]
        assert int(npz[f"{mode}_all_reduces"]) > 0
    assert one_pool["kv_shards"] == 1
    for run in ("plain", "speculative", "nano"):
        assert int(npz[f"engine_{run}_mesh_devices"]) == 2
        assert int(npz[f"engine_{run}_model_shards"]) == 2
        for i, (tok, _, _) in enumerate(ref):
            assert np.array_equal(npz[f"engine_{run}_{i}"], tok), (run, i)


def test_three_ranks_replicate_and_reduce_nothing(system, weights_dir,
                                                  tmp_path):
    jex = system[0]
    out = tmp_path / "three.npz"
    _run_module(["--model=3", "--weights", weights_dir, "--out", str(out)],
                tmp_path)
    npz = np.load(out)
    assert str(npz["kinds"]) == ""
    packets, queries = _packets_of(npz, 3)
    ref = _ref_outputs(jex, packets, queries)
    for mode in ("decode", "verify"):
        _held(_served(npz, mode, 3), ref, mode)
        assert int(npz[f"{mode}_all_reduces"]) == 0
        assert int(npz[f"{mode}_pool_kv_shards"]) == 3


def test_engine_mesh_refusals(system):
    tex = system[1]
    mesh = tmesh.make_local_mesh(model=1)
    with pytest.raises(ValueError, match="executor"):
        AveryEngine(tlut.paper_lut(), executor=None, mesh=mesh,
                    batching="inflight")
    with pytest.raises(ValueError, match="inflight"):
        AveryEngine(tlut.paper_lut(), executor=tex, mesh=mesh,
                    batching="microbatch")
