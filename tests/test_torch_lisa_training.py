"""The LISA system's offline phase in the port held against the reference:
``core/training.py`` (``train_lisa``, ``finetune_lisa``,
``train_bottleneck``, ``evaluate_insight``, ``evaluate_context``),
``core/profile.py`` (``build_lut``, ``train_full_system``),
``launch/train.py --lisa`` and ``launch/serve.py`` without ``--smoke``.

The reference's runs start from its own ``init_lisa`` and
``init_bottleneck`` draws, bridged into the port (the port's
``init_bottleneck`` is replaced by the reference's draw inside the test).
Its jitted functions are compiled at a low XLA optimisation level and
record what they take and return (``_RecordingJax``, standing in for the
``jax`` module in ``repro.core.training`` during a run), so each step's
batches, loss and metrics are read without changing the reference.

Three steps of each trainer at B = 4, AdamW's eps = 1e-4 in both packages
(each package's ``optim`` replaced, inside the test, by one whose
``adamw`` takes that eps; see ``test_torch_train_zoo.EPS`` for why the
default 1e-8 amplifies float32 rounding): each step's batches bit for bit,
loss and metrics within rtol 1e-5, every parameter leaf norm-wise within
1e-5 (the worst reads 2.1e-6). At the default eps the losses alone,
within rtol 1e-5 (a parameter leaf reads 1.6e-4 apart there).
Evaluation: Average IoU within 1e-3, the Context accuracy equal up to
the argmaxes whose two leading logits are within 1e-4 of each other.
"""
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.checkpoint import load_pytree as jload, save_pytree as jsave
from repro.configs.lisa_mini import CONFIG as JP
from repro.core import bottleneck as jbn
from repro.core import profile as jprof
from repro.core import training as jtraining
from repro.core import vlm as jvlm
from repro.core.lut import SystemLUT as JLUT
from repro_torch import bridge
from repro_torch import optim as toptim
from repro_torch.configs import get_lisa_config
from repro_torch.core import bottleneck as tbn
from repro_torch.core import profile as tprof
from repro_torch.core import streams as tstreams
from repro_torch.core import training as ttraining
from repro_torch.core import vlm as tvlm
from repro_torch.data import floodseg as tflood
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models.stack import leaves

from test_torch_train_zoo import XLA_FAST, _compiled, norm_err, pairs

torch.set_num_threads(1)

TP = get_lisa_config("lisa-mini")
B, STEPS, EPS = 4, 3, 1e-4
RTOL, NORM_TOL, IOU_TOL, TIE = 1e-5, 1e-5, 1e-3, 1e-4
RATIO = 0.25


class _RecordingJax:
    """``jax`` for ``repro.core.training``: ``jit`` compiles at XLA_FAST
    and records each call's (args, outputs); everything else is jax's."""

    def __init__(self, record):
        self.record = record

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        compiled = []

        def call(*args):
            if not compiled:
                compiled.append(jax.jit(fn, **kw).lower(*args).compile(
                    compiler_options=XLA_FAST))
            out = compiled[0](*args)
            self.record.append((args, out))
            return out
        return call


def _eps_optim(optim, eps):
    return types.SimpleNamespace(
        adamw=functools.partial(optim.adamw, eps=eps),
        cosine_with_warmup=optim.cosine_with_warmup)


def _ref_run(fn, eps=EPS, **kw):
    """(result, the reference's recorded jit calls)."""
    record = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtraining, "jax", _RecordingJax(record))
        mp.setattr(jtraining, "optim", _eps_optim(joptim, eps))
        out = fn(**kw)
    return out, record


def _port_run(fn, step_name, eps=EPS, pair=None, **kw):
    """(result, each step's (args, outputs)) of a port trainer; ``pair``
    stands in for the port's ``init_bottleneck`` draw."""
    record = []
    step = getattr(ttraining, step_name)

    def recording(*args):
        out = step(*args)
        record.append((args, out))
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttraining, step_name, recording)
        mp.setattr(ttraining, "optim", _eps_optim(toptim, eps))
        if pair is not None:
            mp.setattr(tbn, "init_bottleneck",
                       lambda gen, spec, dtype=None, device=None:
                       _t(pair, device))
        out = fn(device="cpu", **kw)
    return out, record


def _t(tree, device="cpu"):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), device)


def _pair_spec(pcfg=JP):
    d = pcfg.sam.d_model
    return jbn.BottleneckSpec(d, jbn.rank_for_ratio(d, RATIO, 4), 4)


@pytest.fixture(scope="module")
def init():
    key = jax.random.PRNGKey(0)
    return _compiled(lambda k: jvlm.init_lisa(JP, k), key)(key)


@pytest.fixture(scope="module")
def ref_lisa(init):
    return _ref_run(jtraining.train_lisa, pcfg=JP, steps=STEPS,
                    batch_size=B, params=init, log_every=0)


@pytest.fixture(scope="module")
def ref_finetune(ref_lisa):
    return _ref_run(jtraining.finetune_lisa, pcfg=JP, params=ref_lisa[0],
                    steps=STEPS, batch_size=B, log=lambda s: None)


@pytest.fixture(scope="module")
def ref_pair():
    return jbn.init_bottleneck(jax.random.PRNGKey(int(RATIO * 1000)),
                               _pair_spec())


@pytest.fixture(scope="module")
def ref_bottleneck(ref_lisa, ref_pair):
    return _ref_run(jtraining.train_bottleneck, pcfg=JP, params=ref_lisa[0],
                    ratio=RATIO, steps=STEPS, batch_size=B, log_every=0)


def _assert_batches_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes(), k


def _assert_step_metrics(want, got):
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)


def _assert_params_close(want, got):
    worst = max((norm_err(w, g), p) for p, w, g in pairs(want, got))
    assert worst[0] <= NORM_TOL, worst
    assert not any(t.requires_grad for t in leaves(got))


def _assert_lisa_steps(record, port_record, kinds):
    """The reference's jitted step (p, s, ins, ctx) -> (p, s, loss,
    metrics) against the port's ``lisa_step``."""
    assert len(record) == len(port_record) == STEPS
    for i, ((jargs, jout), (targs, tout)) in enumerate(zip(record,
                                                           port_record)):
        _assert_batches_equal(jargs[2], targs[4])
        _assert_batches_equal(jargs[3], targs[5])
        assert int(targs[5]["query"][0, 1]) == kinds[i]
        np.testing.assert_allclose(float(tout[2]), float(jout[2]), rtol=RTOL)
        assert sorted(tout[3]) == sorted(jout[3])
        _assert_step_metrics(jout[3], tout[3])


def test_train_lisa_matches_reference(init, ref_lisa):
    """The Insight batch, then a Context batch of kind "any" on even steps
    and "count" on odd ones, each step from RandomState(seed)."""
    out, port_record = _port_run(ttraining.train_lisa, "lisa_step", pcfg=TP,
                                 steps=STEPS, batch_size=B,
                                 params=_t(init), log_every=0)
    kinds = [tflood.TOK_ANY, tflood.TOK_COUNT, tflood.TOK_ANY]
    _assert_lisa_steps(ref_lisa[1], port_record, kinds)
    _assert_params_close(ref_lisa[0], out)


def test_finetune_lisa_matches_reference(ref_lisa, ref_finetune):
    """Insight-only: every Context batch is of kind "any"; seed 1."""
    out, port_record = _port_run(ttraining.finetune_lisa, "lisa_step",
                                 pcfg=TP, params=_t(ref_lisa[0]),
                                 steps=STEPS, batch_size=B,
                                 log=lambda s: None)
    _assert_lisa_steps(ref_finetune[1], port_record, [tflood.TOK_ANY] * 3)
    _assert_params_close(ref_finetune[0], out)


def test_train_bottleneck_matches_reference(ref_lisa, ref_pair,
                                            ref_bottleneck):
    """Only the pair learns: the frozen LISA weights come through the run
    unchanged and never require grad; the batches come from
    RandomState(seed + int(ratio * 1000))."""
    frozen = _t(ref_lisa[0])
    before = [t.clone() for t in leaves(frozen)]
    out, port_record = _port_run(ttraining.train_bottleneck,
                                 "bottleneck_step", pair=ref_pair, pcfg=TP,
                                 params=frozen, ratio=RATIO, steps=STEPS,
                                 batch_size=B, log_every=0)
    record = ref_bottleneck[1]
    assert len(record) == len(port_record) == STEPS
    for (jargs, jout), (targs, tout) in zip(record, port_record):
        _assert_batches_equal(jargs[2], targs[5])
        np.testing.assert_allclose(float(tout[2]), float(jout[2]),
                                   rtol=RTOL)
        assert not any(t.requires_grad for t in leaves(targs[2]))
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(frozen)))
    assert sorted(out) == ["dec", "enc"]
    assert out["enc"].shape == (TP.sam.d_model, _pair_spec().rank)
    _assert_params_close(ref_bottleneck[0], out)


def test_train_lisa_default_eps_losses_match_reference(init):
    _, record = _ref_run(jtraining.train_lisa, eps=1e-8, pcfg=JP,
                         steps=STEPS, batch_size=B, params=init,
                         log_every=0)
    _, port_record = _port_run(ttraining.train_lisa, "lisa_step", eps=1e-8,
                               pcfg=TP, steps=STEPS, batch_size=B,
                               params=_t(init), log_every=0)
    for (_, jout), (_, tout) in zip(record, port_record):
        np.testing.assert_allclose(float(tout[2]), float(jout[2]), rtol=RTOL)


def test_initial_draws_are_seeded_as_the_reference_keys_them():
    """``train_lisa(params=None)`` starts from ``init_lisa`` drawn from a
    generator seeded with ``seed``; ``train_bottleneck`` from a pair drawn
    from one seeded with ``seed + int(ratio * 1000)``."""
    p = ttraining.train_lisa(TP, steps=0, seed=3, device="cpu")
    want = tvlm.init_lisa(TP, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(p), leaves(want)))
    bp = ttraining.train_bottleneck(TP, p, 0.1, steps=0, seed=3,
                                    device="cpu")
    spec = tbn.BottleneckSpec(TP.sam.d_model,
                              tbn.rank_for_ratio(TP.sam.d_model, 0.1, 4), 4)
    want = tbn.init_bottleneck(torch.Generator().manual_seed(103), spec)
    assert all(torch.equal(bp[k], want[k]) for k in ("enc", "dec"))


# ---------------------------------------------------------------------------
# evaluation and the LUT
# ---------------------------------------------------------------------------


def _near_ties(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
    return int(np.sum(top2[:, 1] - top2[:, 0] < TIE))


@pytest.mark.parametrize("with_pair", [False, True])
def test_evaluate_insight_matches_reference(ref_lisa, ref_pair, with_pair):
    jpair = ref_pair if with_pair else None
    want, _ = _ref_run(jtraining.evaluate_insight, pcfg=JP,
                       params=ref_lisa[0], bn_params=jpair, batches=2,
                       batch_size=8)
    got = ttraining.evaluate_insight(
        TP, _t(ref_lisa[0]), bn_params=_t(jpair) if with_pair else None,
        batches=2, batch_size=8, device="cpu")
    assert sorted(got) == ["avg_iou", "ciou", "giou"]
    for k in want:
        assert abs(got[k] - want[k]) <= IOU_TOL, (k, got[k], want[k])


def test_evaluate_context_matches_reference(ref_lisa):
    want, record = _ref_run(jtraining.evaluate_context, pcfg=JP,
                            params=ref_lisa[0], batches=2, batch_size=8)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        forward = tvlm.context_forward
        mp.setattr(tvlm, "context_forward",
                   lambda *a: seen.append(forward(*a)) or seen[-1])
        got = ttraining.evaluate_context(TP, _t(ref_lisa[0]), batches=2,
                                         batch_size=8, device="cpu")
    ties = sum(_near_ties(out) for _, out in record)
    assert abs(got - want) * 16 <= ties, (got, want, ties)
    for (_, jl), tl in zip(record, seen):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-5)


def test_build_lut_one_tier_matches_reference(ref_lisa, ref_finetune,
                                              ref_pair):
    want, _ = _ref_run(jprof.build_lut, pcfg=JP,
                       params_original=ref_lisa[0],
                       params_finetuned=ref_finetune[0],
                       bottlenecks={RATIO: ref_pair}, eval_batches=1)
    got = tprof.build_lut(TP, _t(ref_lisa[0]), _t(ref_finetune[0]),
                          {RATIO: _t(ref_pair)}, eval_batches=1,
                          device="cpu")
    assert [t.name for t in got.tiers] == ["High Accuracy"]
    (w,), (g,) = want.tiers, got.tiers
    assert (g.name, g.ratio, g.payload_mb) == (w.name, w.ratio, w.payload_mb)
    assert abs(g.acc_base - w.acc_base) <= IOU_TOL
    assert abs(g.acc_finetuned - w.acc_finetuned) <= IOU_TOL
    assert g.acc_base != g.acc_finetuned
    assert got.context.payload_mb == want.context.payload_mb


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def _text(path, name):
    with open(os.path.join(path, name)) as f:
        return f.read()


def test_train_launcher_lisa_writes_reference_checkpoints(tmp_path, capsys):
    """``--lisa --device cpu`` with tiny budgets: each directory's manifest
    and structure text is what the reference's ``save_pytree`` writes for
    its own ``init_lisa`` / ``init_bottleneck`` tree of that kind; each
    package reads the other's directories, and the reference reads the
    port's ``lut.json``."""
    out = tmp_path / "port"
    ttrain.main(["--lisa", "--steps", "2", "--ft-steps", "1", "--bn-steps",
                 "1", "--device", "cpu", "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-5] == "[train] LUT:" and lines[-1].startswith(
        "[train] artifacts saved under")
    assert [ln.split()[0] for ln in lines[-4:-1]] == ["High", "Balanced",
                                                      "High"]
    key = jax.random.PRNGKey(0)
    kinds = {"lisa_mini_original": None, "lisa_mini_finetuned": None,
             **{f"bottleneck_r{r}": r for r in (0.25, 0.1, 0.05)}}
    assert sorted(os.listdir(out)) == sorted([*kinds, "lut.json"])
    for name, ratio in kinds.items():
        if ratio is None:
            tree = jax.eval_shape(lambda k: jvlm.init_lisa(JP, k), key)
        else:
            d = JP.sam.d_model
            tree = jbn.init_bottleneck(key, jbn.BottleneckSpec(
                d, jbn.rank_for_ratio(d, ratio, 4), 4))
        tree = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), tree)
        jsave(str(tmp_path / "ref" / name), tree)
        for f in ("manifest.json", "structure.json"):
            assert _text(out / name, f) == _text(tmp_path / "ref" / name, f)
        port = bridge.load_checkpoint(str(out / name), "cpu")
        assert not any(t.requires_grad for t in leaves(port))
        for p, w, g in pairs(jload(str(out / name)), port):
            assert np.asarray(w).tobytes() == g.numpy().tobytes(), p
        jsave(str(tmp_path / "back" / name), jax.tree.map(
            lambda t: jnp.asarray(t.numpy()), port))
        for p, w, g in pairs(port, bridge.load_checkpoint(
                str(tmp_path / "back" / name), "cpu")):
            assert torch.equal(w, g), p
    lut = JLUT.load(str(out / "lut.json"))
    assert [t.ratio for t in lut.tiers] == [0.25, 0.1, 0.05]
    assert json.loads(_text(out, "lut.json"))["tiers"][0]["name"] == \
        "High Accuracy"


def test_serve_local_trains_and_serves_a_system(monkeypatch, capsys):
    """Without ``smoke`` the launcher runs the offline phase at the
    reference's budget (here cut to tiny steps), profiles the LUT at 2
    eval batches, maps the pairs to tier names by ratio, largest first,
    and serves the trained weights: the kernel wrappers on its path raise
    for inputs that require grad, so this also shows they come back
    detached."""
    calls, executors = {}, []
    full, lut_fn = tprof.train_full_system, tprof.build_lut

    def train_full_system(pcfg, **kw):
        calls["train"] = dict(kw)
        kw.update(steps=2, bn_steps=1, ft_steps=1, batch_size=2)
        calls["system"] = full(pcfg, **kw)
        return calls["system"]

    def build_lut(*args, **kw):
        calls["lut"] = dict(kw)
        return lut_fn(*args, **kw)

    class Executor(tstreams.DualStreamExecutor):
        def __post_init__(self):
            super().__post_init__()
            executors.append(self)

    monkeypatch.setattr(tprof, "train_full_system", train_full_system)
    monkeypatch.setattr(tprof, "build_lut", build_lut)
    monkeypatch.setattr(tstreams, "DualStreamExecutor", Executor)
    tserve.serve_local(8.0, 0, 4, smoke=False, batching="inflight",
                       device="cpu")
    out = capsys.readouterr().out
    assert calls["train"]["steps"] == 120 and calls["train"]["bn_steps"] \
        == 80 and calls["train"]["ft_steps"] == 60
    assert calls["train"]["device"] == calls["lut"]["device"] == "cpu"
    assert calls["lut"]["eval_batches"] == 2
    params, _, bns = calls["system"]
    (ex,) = executors
    assert all(torch.equal(a, b)
               for a, b in zip(leaves(ex.params), leaves(params)))
    names = [t.name for t in ex.lut.tiers]
    assert names == ["High Accuracy", "Balanced", "High Throughput"]
    for name, r in zip(names, (0.25, 0.1, 0.05)):
        assert torch.equal(ex.bottlenecks[name]["enc"], bns[r]["enc"])
    assert "[serve] training lisa-mini system" in out
    assert " in-flight decode steps" in out and "insight Average IoU" in out
