"""The sharded train step (``repro_torch/sharding/training.py``,
``launch/mesh.py``'s collectives) held to the reference's unsharded
``make_train_step``.

The reference's own sharded step only lowers on a (1, 1) mesh
(``tests/test_sharding.py``); GSPMD makes the partitioned step compute the
unsharded step's function over the global batch, so that step is the
oracle here: the reference's ``init_params`` (through the weight bridge),
its ``data/lm.py`` batch of (4, 32) tokens (the VLM's vision embeddings
and M-RoPE positions beside them), AdamW with ``eps = 1e-4`` (as
``test_torch_train_zoo.py``), two steps, on the reduced phi4-mini-3.8b,
granite-moe-3b-a800m, falcon-mamba-7b, zamba2-7b (the reference test's
set) and qwen2-vl-2b. Gloo ranks run them on three meshes, one spawn a
mesh running every config (``python -m repro_torch.sharding.training``,
wrapped to record the MoE pairs' positions): (data 1, model 2), (2, 1)
with FSDP and (2, 2) with FSDP.

Tolerances. Metrics (losses, ``aux_loss``, ``grad_norm``): rtol 1e-5, as
``test_torch_train_zoo.py``. Each reassembled leaf of the parameters and
both moments: within rtol 1e-6 and atol 1e-6 of the leaf's largest
magnitude; a leaf past that must sit within ``REORDER_FACTOR`` (2.5) times
the control's reading of how far a reordered sum alone moves it from the
reference. The control is the port's unsharded step on the whole batch
whose gradient is the sum, in rank order, of the gradients of the data
ranks' halves of the loss (the first half carries the MoE router loss).
The reorder alone takes leaves whose gradients cancel (zero-initialised
biases after two steps, Mamba's conv bias) to 2e-5 of their largest
magnitude; the sharded step reads at most 1.82 times the control.
``REORDER_READINGS`` holds every leaf that needed the control, printed at
the end of the module's run.

Also held: every leaf that two ranks hold the same block of is bit-equal
on them, and the metrics on every rank; each rank's collectives, by label,
kind, count and bytes, equal ``launch.dryrun.reckon``'s charges of the
same step but the named departures (``held_to_reckoning``); a one-rank
mesh is ``make_train_step`` bit for bit with no collective; the FSDP cut
and its reassembly round-trip bit for bit; the mesh's collectives over
each axis of a (2, 2) mesh; granite at data 2 with a capacity that drops
fills and drops exactly the global batch's (token, slot) pairs.
"""
import concurrent.futures
import dataclasses
import math
import os
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro import optim as joptim
from repro.data import lm as jlm
from repro_torch import bridge
from repro_torch import models as tmodels
from repro_torch import optim as toptim
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.stack import tree_map
from repro_torch.sharding import specs as sh
from repro_torch.sharding import training

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, S, STEPS, LR, EPS = 4, 32, 2, 1e-3, 1e-4
# the last: phi4-mini reduced to 3 query heads over 1 kv head of 64, whose
# cut over two ranks splits heads (1.5 a rank), as granite's does at full
# width, so attention runs whole on gathered leaves (the share rule)
SPLIT_HEADS = "phi4-split-heads"
CONFIGS = ("phi4-mini-3.8b", "granite-moe-3b-a800m", "falcon-mamba-7b",
           "zamba2-7b", "qwen2-vl-2b", SPLIT_HEADS)
# (data, model, fsdp)
MESHES = {"1x2": (1, 2, False), "2x1-fsdp": (2, 1, True),
          "2x2-fsdp": (2, 2, True)}
# granite with a capacity that drops (token, slot) pairs, at data 2 only
DROPS = "granite-drops"
METRIC_RTOL = 1e-5
TOL = 1e-6
REORDER_FACTOR = 2.5
XLA_FAST = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
TIMEOUT_S = 300
REORDER_READINGS = []

# the rank program: the module's rank entry, with each case's MoE pair
# positions (``moe._pair_positions``) recorded into its output
RANK_PROGRAM = textwrap.dedent("""
    import sys
    from repro_torch.models import moe
    from repro_torch.sharding import training
    seen, real, run = [], moe._pair_positions, training.run_case
    def positions(sel):
        out = real(sel)
        seen.append(out.detach().clone())
        return out
    def run_case(*args):
        seen.clear()
        out = run(*args)
        out["positions"] = list(seen)
        return out
    moe._pair_positions, training.run_case = positions, run_case
    sys.exit(training.main(sys.argv[1:]))
""")


def _port_cfg(jcfg):
    sub = {"moe": tmodels.MoEConfig, "mla": tmodels.MLAConfig,
           "ssm": tmodels.SSMConfig, "hybrid": tmodels.HybridConfig}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in sub.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return tmodels.ModelConfig(**kw)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=XLA_FAST)


def _jcfg(name):
    if name == SPLIT_HEADS:
        return jconfigs.get_reduced("phi4-mini-3.8b").replace(
            num_heads=3, num_kv_heads=1, head_dim=64)
    if name == DROPS:
        jcfg = jconfigs.get_reduced("granite-moe-3b-a800m")
        return jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    capacity_factor=0.5))
    return jconfigs.get_reduced(name)


def _torch(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def _reference(jcfg, jparams, nb):
    """The reference's unsharded steps: (metrics a step, {params, m, v})."""
    opt = joptim.adamw(LR, eps=EPS)
    state = opt.init(jparams)
    jb = {k: jax.numpy.asarray(v) for k, v in nb.items()}
    fn = _compiled(jmodels.make_train_step(jcfg, opt), jparams, state, jb)
    metrics = []
    for _ in range(STEPS):
        jparams, state, m = fn(jparams, state, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _torch({"params": jparams, "m": state["m"],
                            "v": state["v"]})


def _half_objectives(p, cfg, batch):
    """``loss_fn``'s total on the whole batch as the sum of two objectives,
    one a data rank's half of the rows: its share of the cross-entropy's
    sum over the whole batch's count, and (the first) the router loss."""
    logits, aux, _, _ = tmodel.forward(p, cfg, batch)
    tokens = batch["tokens"]
    lg = logits[:, :-1].float()
    nll = torch.logsumexp(lg, -1) - torch.gather(
        lg, -1, tokens[:, 1:, None].long())[..., 0]
    if cfg.modality == "vlm":
        mask = (torch.arange(tokens.shape[1] - 1)
                >= cfg.num_vision_tokens).expand(nll.shape).float()
        count = torch.sum(mask) + 1e-6
    else:
        mask, count = torch.ones_like(nll), nll.numel()
    h = B // 2
    return [torch.sum(nll[:h] * mask[:h]) / count + aux,
            torch.sum(nll[h:] * mask[h:]) / count]


def _control(cfg, params, batch):
    """The control: the port's unsharded steps whose gradient is the sum,
    in rank order, of the two halves' gradients (``_half_objectives``):
    the same function, the sums over the batch reordered as two data
    ranks reorder them. Returns {params, m, v}."""
    opt = toptim.adamw(LR, eps=EPS)
    state = opt.init(params)
    for _ in range(STEPS):
        live = tree_map(lambda t: t.detach().clone().requires_grad_(),
                        params)
        wrt = [t for t in sh.leaves_with_paths(live)]
        objectives = _half_objectives(live, cfg, batch)
        parts = [torch.autograd.grad(o, [t for _, t in wrt],
                                     retain_graph=True, allow_unused=True)
                 for o in objectives]
        grads = iter([None if a is None else (a if b is None else a + b)
                      for a, b in zip(*parts)])
        grads = tree_map(lambda t: next(grads), live)
        params, state = opt.apply(params, state, grads)
    return {"params": params, "m": state["m"], "v": state["v"]}


def _spawn(cases, tmp, name):
    data, model, fsdp = MESHES.get(name, (2, 1, False))
    out = tmp / name
    out.mkdir()
    argv = [a for c in cases for a in ("--case", str(c))] + [
        "--data", str(data), "--model", str(model), "--out", str(out),
        "--device", "cpu", "--timeout", str(TIMEOUT_S)]
    if fsdp:
        argv.append("--fsdp")
    tmesh.spawn_ranks(["-c", RANK_PROGRAM, *argv], data * model, TIMEOUT_S)
    return {Path(c).stem: training.load_outputs(str(out), str(c),
                                                data * model)
            for c in cases}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's reference, port and control steps, and each mesh's
    ranks' outputs (the spawns run while the reference compiles)."""
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p])
    tmp = tmp_path_factory.mktemp("sharded_train")
    def prepare(name):
        jcfg = _jcfg(name)
        key = jax.random.PRNGKey(0)
        jparams = _compiled(lambda k: jmodels.init_params(jcfg, k), key)(key)
        nb = jlm.lm_batch(np.random.RandomState(0), jcfg, B, S)
        cfg, params = _port_cfg(jcfg), _torch(jparams)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in nb.items()}
        path = tmp / f"{name}.pt"
        training.save_case(str(path), cfg, params, batch, LR, EPS, STEPS,
                           tf32=False)
        return jcfg, jparams, nb, cfg, params, batch, path

    def steps(name):
        jcfg, jparams, nb, cfg, params, batch, _ = prepared[name]
        metrics, ref = _reference(jcfg, jparams, nb)
        return {"cfg": cfg, "params": params, "batch": batch,
                "metrics": metrics, "ref": ref,
                "control": _control(cfg, params, batch)}

    names = CONFIGS + (DROPS,)
    # the reference's compilations run beside each other and the ranks
    with concurrent.futures.ThreadPoolExecutor(len(MESHES) + 3) as pool:
        prepared = dict(zip(names, pool.map(prepare, names)))
        cases = [prepared[n][-1] for n in CONFIGS]
        spawns = {m: pool.submit(_spawn, cases, tmp, m) for m in MESHES}
        spawns["drops"] = pool.submit(_spawn, [prepared[DROPS][-1]], tmp,
                                      "drops")
        out = dict(zip(names, pool.map(steps, names)))
        ranks = {m: f.result() for m, f in spawns.items()}
    return out, ranks


def _distance(want, got):
    """max(|got - want| - 1e-6 |want|) over the leaf, over its largest
    magnitude: the stated tolerance passes at <= TOL."""
    scale = float(want.abs().max())
    return float(((got - want).abs() - TOL * want.abs()).max()) / max(
        scale, 1e-30)


def _assembled(case, outs, mesh):
    data, model, fsdp = MESHES.get(mesh, (2, 1, False))
    shape = {"data": data, "model": model}
    specs = sh.param_specs(case["cfg"], case["params"], tmesh.Mesh(shape),
                           fsdp=fsdp)
    return {k: training.assemble([o[k] for o in outs], specs, shape)
            for k in ("params", "m", "v")}


def _hold_run(name, case, outs, mesh):
    for o in outs:
        assert o["step"] == STEPS
        assert o["metrics"] == outs[0]["metrics"], "ranks' metrics differ"
        for want, got in zip(case["metrics"], o["metrics"]):
            assert sorted(want) == sorted(got)
            for k in want:
                assert math.isclose(got[k], want[k], rel_tol=METRIC_RTOL,
                                    abs_tol=1e-7), (k, got[k], want[k])
    got = _assembled(case, outs, mesh)
    for tree in ("params", "m", "v"):
        for (path, want), (_, mine), (_, ctrl) in zip(
                *(sh.leaves_with_paths(t[tree]) for t in (
                    case["ref"], got, case["control"]))):
            d = _distance(want, mine)
            if d <= TOL:
                continue
            reading = _distance(want, ctrl)
            REORDER_READINGS.append((mesh, name, tree, "/".join(path), d,
                                     reading))
            assert d <= REORDER_FACTOR * reading, (
                f"{mesh} {name} {tree} {'/'.join(path)}: {d:.3g} of its "
                f"largest magnitude, past {TOL} and {REORDER_FACTOR} x the "
                f"control's reading {reading:.3g}")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_sharded_steps_match_reference(runs, mesh, name):
    """Metrics of both steps, the reassembled parameters and moments
    against the reference's unsharded steps."""
    cases, ranks = runs
    _hold_run(name, cases[name], ranks[mesh][name], mesh)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_replicated_blocks_bit_equal_across_ranks(runs, mesh):
    """Every block two ranks hold (a leaf replicated over an axis) is
    bit-equal on them after two steps, for every config
    (``training.assemble`` raises otherwise), and so are the metrics."""
    cases, ranks = runs
    for name in CONFIGS:
        outs = ranks[mesh][name]
        assert all(o["metrics"] == outs[0]["metrics"] for o in outs)
        _assembled(cases[name], outs, mesh)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_collectives_held_to_reckoning(runs, mesh, name):
    """Each rank's collectives of each step, by label and kind, count and
    bytes, against ``dryrun.reckon``'s charges of the same step on the
    same mesh shape; the departures are the named ones."""
    cases, ranks = runs
    data, model, fsdp = MESHES[mesh]
    cfg = cases[name]["cfg"]
    shape = dryrun.ShapeSpec("train", S, B, "train")
    abstract = tmesh.Mesh({"data": data, "model": model})
    reck = dryrun.reckon(cfg, shape, abstract, fsdp=fsdp)["by_label"]
    first = None
    for o in ranks[mesh][name]:
        for seen in o["collectives"]:
            rep = dryrun.held_to_reckoning(reck, seen)
            first = first or rep
    executed = first["departures"]["executed"]
    assert set(executed) == ({"norm"} | ({"stat"} if data > 1 else set())
                             | ({"whole"} if model > 1 and name !=
                                "phi4-mini-3.8b" else set()))
    if fsdp:
        assert "fsdp-gather (before the backward)" in \
            first["departures"]["reckoned"]


@pytest.mark.parametrize("name", CONFIGS)
def test_one_rank_mesh_is_make_train_step_bit_for_bit(runs, name):
    """On this process alone (a 1x1 mesh) the sharded step is
    ``make_train_step``: the same bits, and no collective counted."""
    case = runs[0][name]
    mesh = tmesh.make_local_mesh()
    opt = toptim.adamw(LR, eps=EPS)
    outs = []
    for step in (training.make_sharded_train_step(case["cfg"], opt, mesh),
                 tmodel.make_train_step(case["cfg"], opt)):
        params, state = case["params"], opt.init(case["params"])
        for _ in range(STEPS):
            params, state, metrics = step(params, state, case["batch"])
        outs.append((params, state, metrics))
    (p1, s1, m1), (p2, s2, m2) = outs
    assert mesh.collectives == {}
    assert {k: float(v) for k, v in m1.items()} == \
        {k: float(v) for k, v in m2.items()}
    for a, b in zip(*(sh.leaves_with_paths({"p": p, "m": s["m"],
                                            "v": s["v"]})
                      for p, s in ((p1, s1), (p2, s2)))):
        assert torch.equal(a[1], b[1]), a[0]


@pytest.mark.parametrize("name", CONFIGS)
def test_fsdp_cut_and_reassembly_round_trip(runs, name):
    """Each rank's FSDP blocks (``shard_tree`` over
    ``param_specs(fsdp=True)``) on the (2, 1) and (2, 2) meshes reassemble
    into the whole tree bit for bit, and every FSDP-cut leaf's blocks are
    distinct parts of it."""
    params = runs[0][name]["params"]
    cfg = runs[0][name]["cfg"]
    for data, model in ((2, 1), (2, 2)):
        shape = {"data": data, "model": model}
        specs = sh.param_specs(cfg, params, tmesh.Mesh(shape), fsdp=True)
        assert any("data" in s for _, _, s in sh.spec_pairs(params, specs))
        blocks = [sh.shard_tree(params, specs, m, m.coords) for m in (
            tmesh.Mesh(shape, rank=r) for r in range(data * model))]
        whole = training.assemble(blocks, specs, shape)
        for (path, a), (_, b) in zip(sh.leaves_with_paths(params),
                                     sh.leaves_with_paths(whole)):
            assert torch.equal(a, b), path


def test_granite_at_data_two_drops_the_global_batchs_pairs(runs):
    """granite with capacity factor 0.5 at (data 2, model 1): every MoE
    layer's (token, slot) positions on the two ranks, in rank order, are
    the unsharded port step's on the global batch (held to the reference
    by its loss and ``aux_loss``), so the same pairs fill and drop at the
    global capacity; pairs do drop, and a rank's local capacity and order
    would drop others. Metrics, parameters and moments against the
    reference as the other cases."""
    cases, ranks = runs
    case, outs = cases[DROPS], ranks["drops"][DROPS]
    cfg = case["cfg"]
    real = tmoe._pair_positions

    def recorded(batch):
        seen = []

        def positions(sel):
            out = real(sel)
            seen.append(out.detach().clone())
            return out
        tmoe._pair_positions = positions
        try:
            tmodel.forward(case["params"], cfg, batch)
        finally:
            tmoe._pair_positions = real
        return seen
    whole = recorded(case["batch"])
    # the second data rank's rows alone, at their own capacity (layer 0
    # routes them as the whole batch does: attention stays within a row)
    half = recorded({k: v[B // 2:] for k, v in case["batch"].items()})
    layers = cfg.num_layers
    assert len(whole) == layers and all(
        len(o["positions"]) == STEPS * layers for o in outs)
    C = tmoe.capacity(cfg, B * S)
    for layer in range(layers):
        mine = torch.cat([o["positions"][layer] for o in outs])
        assert torch.equal(mine, whole[layer]), layer
        assert int((mine >= C).sum()) > 0, "the case must drop pairs"
    local = half[0] >= tmoe.capacity(cfg, B * S // 2)
    assert not torch.equal(local, outs[1]["positions"][0] >= C)
    _hold_run(DROPS, case, outs, "drops")


MESH_PROGRAM = textwrap.dedent("""
    import sys
    import torch
    from repro_torch.launch import mesh as mesh_lib
    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    mesh_lib.init_rank(int(args["--rank"]), int(args["--world"]),
                       args["--init"], "cpu")
    mesh = mesh_lib.make_local_mesh(model=2)
    r, d, m = mesh.rank, mesh.coords["data"], mesh.coords["model"]
    t = torch.arange(12.).reshape(3, 4) + 100 * r
    g = mesh.all_gather(t, "data", 1, "x")
    assert torch.equal(g, torch.cat([t - 100 * r + 100 * (2 * i + m)
                                     for i in range(2)], 1)), g
    g = mesh.all_gather(t, "model", 0, "x")
    assert torch.equal(g, torch.cat([t - 100 * r + 100 * (2 * d + i)
                                     for i in range(2)], 0)), g
    s = mesh.reduce_scatter(t, "data", 1, "y")
    whole = sum(t - 100 * r + 100 * (2 * i + m) for i in range(2))
    assert torch.equal(s, whole[:, 2 * d:2 * d + 2]), s
    a = mesh.all_reduce(t, ("model",), "z")
    assert torch.equal(a, sum(t - 100 * r + 100 * (2 * d + i)
                              for i in range(2))), a
    w = mesh.all_reduce(t, ("data", "model"), "z")
    assert torch.equal(w, sum(t - 100 * r + 100 * i for i in range(4)))
    want = {"x": {"all-gather": {"count": 2, "bytes": 2 * 96}},
            "y": {"reduce-scatter": {"count": 1, "bytes": 24}},
            "z": {"all-reduce": {"count": 2, "bytes": 96}}}
    assert mesh.collectives == want, mesh.collectives
    torch.distributed.destroy_process_group()
""")


def test_mesh_collectives_over_each_axis_of_a_two_by_two_mesh():
    """Four gloo ranks at (2, 2): ``all_gather`` and ``reduce_scatter``
    over "data" (ranks [0, 2] and [1, 3]) along a dimension that is not
    the first, ``all_gather`` over "model", ``all_reduce`` over "model"
    and over the world, each with the right values and counted by label,
    kind, count and result bytes."""
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p])
    tmesh.spawn_ranks(["-c", MESH_PROGRAM], 4, TIMEOUT_S)


def teardown_module(module):
    if REORDER_READINGS:
        print("reorder readings: {} leaves past {}, the largest ratio to "
              "the readings {:.3g}".format(
                  len(REORDER_READINGS), TOL,
                  max(r[4] / max(r[5], 1e-30) for r in REORDER_READINGS)))
    for row in sorted(REORDER_READINGS, key=lambda r: -r[4] / max(r[5], 1e-30))[:12]:
        print("reorder reading: {} {} {} {}: {:.3g} (control {:.3g})"
              .format(*row))
