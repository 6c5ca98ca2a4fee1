"""The dry-run (``repro_torch.launch.dryrun``), ``launch/serve.py
--dryrun``, the placement hints and the split serve step against the
reference, without any compile.

* ``SHAPES``, ``adapt_config`` (skipped combos included), ``cache_width``,
  ``input_specs`` and ``model_flops`` equal the reference's for the ten
  architectures and four shapes.
* Per-device argument bytes (params with and without FSDP, AdamW's state,
  batch, cache) equal, exactly, the sum over the reference's leaves of
  ``NamedSharding(AbstractMesh, spec).shard_shape(shape)`` times the
  itemsize, on the 16x16 and 2x16x16 meshes.
* ``serve_dryrun``'s payload line is the reference's arithmetic to the
  digit; its per-device bytes are the reference's LISA-7B and bottleneck
  trees' bytes and one device's share of the batch.
* The reckoning: on a 1x1 mesh a reduced dense prefill counts the FLOPs of
  the products the port computes; on a 2x2 mesh three reduced archs
  (dense, moe, hybrid) count FLOPs, bytes and every collective exactly
  affine in depth; on a 1x2 mesh a cut Mamba mixer's and a cut MoE
  layer's sums are the docstring's bytes; the two private autograd calls
  the share rule reads still exist and behave.
* The hints record the reference's specs under ``seq_shard``,
  ``shard_cache_hd`` and the scatter dispatch (the reference's
  ``with_sharding_constraint`` recorded under a 1x1 mesh), and the
  model's outputs are bit-equal with the hints on and off.
* ``split_serve`` over two gloo ranks (a subprocess) at lisa-mini on the
  reference's ``random_init_system`` weights: pod 1's masks and answer
  logits against the reference's composition of its stage functions on
  the same inputs, pod 0's against that composition on zero codes (atol
  1e-3, the reference selftest's); the bytes that crossed the link.
"""
import dataclasses
import os
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro import optim as joptim
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs.lisa7b import CONFIG as JLISA7B
from repro.configs.lisa_mini import CONFIG as JP
from repro.core import bottleneck as jbn
from repro.core import vlm as jvlm
from repro.core.profile import random_init_system
from repro.launch import dryrun as jdr
from repro.sharding import specs as jsh
from repro_torch import configs as tconfigs
from repro_torch.configs import get_lisa_config
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel
from repro_torch.sharding import specs as tsh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
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


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


# ---- shapes, configs, inputs ----


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_configs_inputs_and_model_flops_equal_reference(arch):
    assert list(tdr.SHAPES) == list(jdr.SHAPES)
    assert tdr.SLIDING_WINDOW == jdr.SLIDING_WINDOW
    for name, js in jdr.SHAPES.items():
        assert dataclasses.asdict(tdr.SHAPES[name]) == dataclasses.asdict(js)
        jc = jdr.adapt_config(jget_config(arch), js)
        tc = tdr.adapt_config(tconfigs.get_config(arch), tdr.SHAPES[name])
        assert (jc is None) == (tc is None), name
        if jc is None:
            continue
        assert tc.sliding_window == jc.sliding_window, name
        assert tdr.cache_width(tc, tdr.SHAPES[name]) \
            == jdr.cache_width(jc, js), name
        want = jdr.input_specs(jc, js)
        got = tdr.input_specs(tc, tdr.SHAPES[name])
        assert set(got) == set(want), name
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (name, k)
            assert got[k].device.type == "meta"
            assert _dtype(got[k]) == str(np.dtype(want[k].dtype)), (name, k)
        assert tdr.model_flops(tc, tdr.SHAPES[name]) \
            == jdr.model_flops(jc, js), name


def test_skipped_combos_are_the_references(tmp_path):
    skipped = {(a, s) for a in ARCH_IDS for s, js in jdr.SHAPES.items()
               if jdr.adapt_config(jget_config(a), js) is None}
    assert skipped == {("hubert-xlarge", "decode_32k"),
                       ("hubert-xlarge", "long_500k")}
    for arch, shape in sorted(skipped):
        for multi_pod in (False, True):
            rec = tdr.run_combo(arch, shape, multi_pod,
                                out_dir=str(tmp_path))
            assert rec["skipped"] == "encoder-only: no decode step"
            assert "error" not in rec and "flops" not in rec
    assert len(list(tmp_path.iterdir())) == 4


# ---- per-device bytes ----


def _ref_bytes(tree, specs, mesh):
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        shape = NamedSharding(mesh, spec).shard_shape(leaf.shape)
        total += int(np.prod(shape, dtype=np.int64)) * np.dtype(
            leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_device_bytes_equal_reference_shard_shapes(arch):
    jcfg = jget_config(arch)
    aparams = jdr.abstract_params(jcfg)
    aopt = jax.eval_shape(joptim.adamw(3e-4).init, aparams)
    for mesh_name, (jmesh, tmesh_) in MESHES.items():
        amesh, pmesh = jmesh(), tmesh_()
        for name, js in jdr.SHAPES.items():
            jc = jdr.adapt_config(jcfg, js)
            if jc is None:
                continue
            tc = tdr.adapt_config(tconfigs.get_config(arch),
                                  tdr.SHAPES[name])
            batch = jdr.input_specs(jc, js)
            for fsdp in (False, True):
                pspecs = jsh.param_specs(jc, aparams, amesh, fsdp=fsdp)
                want = {"params": _ref_bytes(aparams, pspecs, amesh),
                        "batch": _ref_bytes(batch, jsh.batch_specs(
                            batch, amesh), amesh)}
                if js.kind == "train":
                    want["opt_state"] = _ref_bytes(aopt, jsh.opt_state_specs(
                        jc, aopt, pspecs, amesh), amesh)
                if js.kind == "decode":
                    acache = jdr.abstract_cache(jc, js)
                    want["cache"] = _ref_bytes(acache, jsh.cache_specs(
                        jc, acache, amesh), amesh)
                want["total"] = sum(want.values())
                got = tdr.device_bytes(tc, tdr.SHAPES[name], pmesh,
                                       fsdp=fsdp)
                assert got == want, (mesh_name, name, fsdp)


# ---- the serve dry-run ----


def test_serve_dryrun_payload_line_and_bytes_equal_reference(capsys):
    r = tserve.serve_dryrun()
    out = capsys.readouterr().out
    d = JLISA7B.sam.d_model
    rank = jbn.rank_for_ratio(d, 0.25, 2)
    B = 32
    raw_bytes = B * JLISA7B.sam_tokens * d * 2
    comp_bytes = B * JLISA7B.sam_tokens * (rank + 4)
    line = (f"[serve-dryrun] boundary payload: uncompressed="
            f"{raw_bytes/1e6:.2f}MB vs bottlenecked={comp_bytes/1e6:.2f}MB "
            f"({raw_bytes/comp_bytes:.1f}x reduction on the pod link)")
    assert line in out.splitlines(), out
    assert r["rank"] == rank == 638
    # the codes (int8) and scales (float32) of one device's 2 images
    local = B // 16
    cp = local * JLISA7B.sam_tokens * rank + local * JLISA7B.sam_tokens * 4
    assert r["collectives"]["collective-permute"] == cp
    assert r["collectives"]["count"] == 2
    assert f"collective-permute bytes (per device): {cp:.3g}" in out
    aparams = jax.eval_shape(
        lambda: jvlm.init_lisa(JLISA7B, jax.random.PRNGKey(0)))
    abn = jax.eval_shape(lambda: jbn.init_bottleneck(
        jax.random.PRNGKey(0), jbn.BottleneckSpec(d, rank, 2)))

    def nbytes(tree):
        return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                   for x in jax.tree.leaves(tree))
    db = r["device_bytes"]
    assert db["params"] == nbytes(aparams)
    assert db["bottleneck"] == nbytes(abn)
    assert db["images"] == local * JLISA7B.image_size ** 2 * 3 * 2
    assert db["query"] == local * 8 * 4
    assert db["total"] == sum(v for k, v in db.items() if k != "total")


# ---- the reckoning ----


def _dense_cfg(**kw):
    return tconfigs.get_reduced("phi4-mini-3.8b").replace(**kw)


def test_counted_flops_of_a_dense_prefill_are_the_ports_products():
    cfg = _dense_cfg(num_layers=2)
    B, S = 2, 16
    shape = tdr.ShapeSpec("p", S, B, "prefill")
    mesh = tmesh.Mesh({"data": 1, "model": 1})
    got = tdr.reckon(cfg, shape, mesh)
    d, H, K, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    ff, V, L = cfg.d_ff, cfg.vocab_size, cfg.num_layers
    T = B * S
    proj = 2 * T * d * (H * hd + 2 * K * hd) + 2 * T * H * hd * d
    attend = 2 * (2 * B * H * S * S * hd)            # scores and P.V
    mlp = 2 * T * d * ff * (3 if cfg.gated_mlp else 2)
    head = 2 * T * d * V                             # every position
    assert got["flops"] == L * (proj + attend + mlp) + head
    assert got["collectives"] == tdr.empty_collectives()
    assert got["attention"] == "whole" and got["shares"] == []


AFFINE = {"dense": "phi4-mini-3.8b", "moe": "granite-moe-3b-a800m",
          "hybrid": "zamba2-7b"}


@pytest.mark.parametrize("kind", sorted(AFFINE))
def test_reckoning_is_exactly_affine_in_depth(kind):
    cfg = tconfigs.get_reduced(AFFINE[kind])
    step = cfg.hybrid.attn_every if cfg.arch_type == "hybrid" else 1
    shape = tdr.ShapeSpec("t", 8, 4, "train")
    mesh = tmesh.Mesh({"data": 2, "model": 2})
    rows = []
    for n in (1, 2, 3):
        r = tdr.reckon(cfg.replace(num_layers=n * step), shape, mesh)
        rows.append((Fraction(r["flops"]), Fraction(r["bytes"]),
                     r["collectives"]))
    for i in (0, 1):
        assert rows[2][i] - rows[1][i] == rows[1][i] - rows[0][i] > 0, i
    for key in rows[0][2]:
        a, b, c = (row[2][key] for row in rows)
        assert c - b == b - a, key
    assert rows[0][2]["all-reduce"] > 0


def test_share_rule_private_autograd_api_is_there():
    """The share rule's backward reads two private autograd calls, all of
    them in ``dryrun._autograd_sequence``: a torch release that changes
    them fails here, by name."""
    from torch.utils._python_dispatch import TorchDispatchMode
    for owner, name in ((torch._C._autograd, "_get_sequence_nr"),
                        (torch._C, "_current_autograd_node")):
        assert hasattr(owner, name), (
            f"torch {torch.__version__} has no {owner.__name__}.{name}, "
            f"which launch/dryrun.py's _autograd_sequence reads")
    x = torch.ones(3, requires_grad=True)
    assert tdr._autograd_sequence(running=True) is None
    lo = tdr._autograd_sequence()
    y = (x * 2).sin().sum()                       # three nodes
    hi = tdr._autograd_sequence()
    assert hi - lo == 3
    seen = []

    class Seen(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(tdr._autograd_sequence(running=True))
            return func(*args, **(kwargs or {}))
    with Seen():
        y.backward()
    assert set(range(lo, hi)) <= set(seen), (lo, hi, seen)


def _block_sum_case(arch):
    """A reduced arch's prefill (B = 2, S = 8) on a (1, 2) mesh, and the
    all-reduce bytes the module docstring's model gives it: each layer's
    sums (float32 partials over B * S rows), the embedding's (B * S, d)
    block and the head's full vocabulary at every position."""
    cfg = tconfigs.get_reduced(arch)
    rows, d, V = 2 * 8, cfg.d_model, cfg.vocab_size
    if cfg.arch_type == "ssm":                    # x_proj and out_proj
        R = -(-d // 16) if not cfg.ssm.dt_rank else cfg.ssm.dt_rank
        layer = [R + 2 * cfg.ssm.state_size, d]
    else:                                         # wo and the routed output
        layer = [d, d]
    want = 4 * rows * (cfg.num_layers * sum(layer) + d + V)
    return cfg, want, cfg.num_layers * len(layer) + 2


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "granite-moe-3b-a800m"])
def test_reckoned_block_sums_of_mixers_and_experts(arch):
    """A Mamba mixer cut on d_inner and a MoE layer whose experts are cut
    sum over the ranks by the reckoning's own charge (``_summed``), not by
    the model code."""
    cfg, want, count = _block_sum_case(arch)
    mesh = tmesh.Mesh({"data": 1, "model": 2})
    aparams = tdr.abstract_params(cfg)
    plan = tdr.cut_plan(cfg, aparams,
                        tsh.param_specs(cfg, aparams, mesh), mesh)
    assert plan.sums == {"mixer" if cfg.arch_type == "ssm" else "experts"}
    assert "embed" in plan.kinds and "head" in plan.kinds
    got = tdr.reckon(cfg, tdr.ShapeSpec("p", 8, 2, "prefill"), mesh)
    coll = got["collectives"]
    assert (coll["all-reduce"], coll["count"]) == (want, count)
    assert coll["total"] == want


# ---- the hints ----


class _Recorder:
    def __init__(self, mesh):
        self.mesh, self.records = mesh, []

    def hint(self, t, spec):
        self.records.append((tuple(t.shape), spec))


def _ref_hints(fn):
    """The reference's ``with_sharding_constraint`` calls of ``fn()``
    under a 1x1 ("data", "model") mesh: [(shape, spec)]."""
    from jax.sharding import Mesh
    rec = []
    real = jax.lax.with_sharding_constraint

    def fake(x, sharding):
        rec.append((tuple(x.shape), sharding.spec))
        return x
    jax.lax.with_sharding_constraint = fake
    try:
        with Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model")):
            fn()
    finally:
        jax.lax.with_sharding_constraint = real
    return rec


def _port_cfg(jcfg):
    from repro_torch import models as tmodels
    sub = {"moe": tmodels.MoEConfig, "mla": tmodels.MLAConfig,
           "ssm": tmodels.SSMConfig, "hybrid": tmodels.HybridConfig}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in sub.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return tmodels.ModelConfig(**kw)


def _hint_case(case):
    """(a function running the reference's step, a function running the
    port's step on its own weights), at one layer: the reference traces
    its layer scan's body once, the port calls each layer's hints."""
    from repro.configs import get_reduced as jreduced
    from repro.models import model as jmodel
    if case == "seq_shard":
        jcfg = jreduced("phi4-mini-3.8b").replace(seq_shard=True)
    elif case == "shard_cache_hd":
        jcfg = jreduced("phi4-mini-3.8b").replace(shard_cache_hd=True)
    else:
        jcfg = jreduced("granite-moe-3b-a800m")
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    dispatch="scatter"))
    jcfg = jcfg.replace(num_layers=1)
    tcfg = _port_cfg(jcfg)
    B, S = 2, 8
    tokens = np.random.RandomState(0).randint(0, jcfg.vocab_size, (B, S))
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    tparams = tmodel.init_params(tcfg, gen, device="cpu")
    if case == "shard_cache_hd":
        def jrun():
            cache = jmodel.init_cache(jcfg, B, S)
            return jmodel.decode_step(jparams, jcfg, cache,
                                      jnp.asarray(tokens[:, :1]), 3)

        def trun():
            cache = tmodel.init_cache(tcfg, B, S, device="cpu")
            return tmodel.decode_step(tparams, tcfg, cache,
                                      torch.as_tensor(tokens[:, :1]), 3)[0]
    else:
        def jrun():
            return jmodel.prefill_step(jparams, jcfg,
                                       {"tokens": jnp.asarray(tokens)})

        def trun():
            return tmodel.prefill_step(tparams, tcfg,
                                       {"tokens": torch.as_tensor(tokens)})[0]
    return jrun, trun


@pytest.mark.parametrize("case", ["seq_shard", "shard_cache_hd", "scatter"])
def test_hints_record_reference_specs_and_change_nothing(case):
    jrun, trun = _hint_case(case)
    want = _ref_hints(jrun)
    assert want, case
    scope = _Recorder(tmesh.Mesh({"data": 1, "model": 1}))
    with torch.no_grad():
        plain = trun()
        with tcommon.reckoning(scope):
            hinted = trun()
    got = scope.records
    assert [s for s, _ in got] == [s for s, _ in want], case
    assert all(P(*g) == w for (_, g), (_, w) in zip(got, want)), (got, want)
    assert torch.equal(plain, hinted)
    # a mesh without "model" records nothing, as the reference's
    none = _Recorder(tmesh.Mesh({"data": 1}))
    with torch.no_grad(), tcommon.reckoning(none):
        trun()
    assert none.records == []


def test_paged_paths_refuse_the_head_dim_sharded_cache():
    from repro_torch.models import attention
    cfg = _dense_cfg(shard_cache_hd=True)
    for fn in (attention.gqa_decode_paged, attention.gqa_verify_paged):
        with pytest.raises(NotImplementedError, match="head_dim-sharded"):
            fn({}, cfg, torch.zeros(1, 1, cfg.d_model), None, {}, None,
               None, None, None, None)


# ---- the split serve step over two ranks ----


def _ref_composition(params, bnp, images, query, zero_codes=False):
    a = jvlm.sam_head(params, JP, images)
    codes, scales = jbn.encode(bnp, a)
    if zero_codes:
        codes, scales = jnp.zeros_like(codes), jnp.zeros_like(scales)
    a_hat = jbn.decode(bnp, codes, scales, out_dtype=JP.sam.adtype)
    feats = jvlm.sam_tail(params, JP, a_hat)
    ctx = jvlm.clip_encode(params, JP, images)
    ans, seg = jvlm.llm_reason(params, JP, ctx, query)
    masks = jvlm.mask_decode(params, JP, feats, seg)
    return np.asarray(masks), np.asarray(ans), codes.nbytes + scales.nbytes


def test_split_serve_two_gloo_ranks_equal_reference_composition(tmp_path):
    from repro.checkpoint.store import save_pytree
    params, _, _ = random_init_system(JP, seed=0)
    d = JP.sam.d_model
    bnp = jbn.init_bottleneck(jax.random.PRNGKey(0), jbn.BottleneckSpec(
        d, jbn.rank_for_ratio(d, 0.25, 2), 2))
    weights = tmp_path / "weights"
    save_pytree(str(weights), {"params": params, "split_bn": bnp})
    out = tmp_path / "out"
    out.mkdir()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve",
         "--split-selftest", "--device", "cpu", "--weights", str(weights),
         "--out", str(out), "--timeout", str(SUBPROCESS_TIMEOUT_S - 20)],
        capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S,
        env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    images, query = tserve.split_inputs(get_lisa_config("lisa-mini"), 2, 0,
                                        "cpu")
    images, query = jnp.asarray(images.numpy()), jnp.asarray(query.numpy())
    masks1, ans, link = _ref_composition(params, bnp, images, query)
    masks0, ans0, _ = _ref_composition(params, bnp, images, query,
                                       zero_codes=True)
    ranks = [np.load(out / f"rank{r}.npz") for r in (0, 1)]
    for r, want in ((0, masks0), (1, masks1)):
        got = ranks[r]
        assert got["masks"].shape == want.shape
        np.testing.assert_allclose(got["masks"], want, atol=ATOL)
        np.testing.assert_allclose(got["answers"], ans, atol=ATOL)
    np.testing.assert_array_equal(ans0, ans)
    assert float(np.abs(masks1 - masks0).max()) > 10 * ATOL
    assert int(ranks[0]["sent"]) == int(ranks[1]["received"]) == link
    assert int(ranks[0]["received"]) == int(ranks[1]["sent"]) == 0


def test_ppermute_semantics_on_one_rank():
    mesh = tmesh.make_named_mesh({"pod": 1})
    t = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(mesh.ppermute(t, "pod", [(0, 0)]), t)
    assert torch.equal(mesh.ppermute(t, "pod", []), torch.zeros_like(t))
    with pytest.raises(ValueError, match="permutation"):
        mesh.ppermute(t, "pod", [(0, 1)])
    with pytest.raises(ValueError, match="holds 2 ranks"):
        tmesh.make_named_mesh({"pod": 2})
