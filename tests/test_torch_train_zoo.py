"""The generic training path of the port (``models/model.py``'s ``_xent``,
``loss_fn`` and ``make_train_step``, ``optim/adamw.py``'s AdamW with the
cosine schedule) held against the reference on each of the ten reduced
zoo configs, from the reference's own ``init_params`` through the weight
bridge, on the reference's own ``data/lm.py`` batch.

The reference's functions are compiled at a low XLA optimisation level
(``_compiled``), which halves its compile time and changes no result
beyond float32 summation order. Its gradients are read through the
optimizer: a recording optimizer hands them out beside its state, so one
compiled ``make_train_step`` gives the first step's gradients and the
three steps.

Tolerances: the loss and every metric within rtol 1e-5; every gradient
leaf, parameter leaf and moment norm-wise (||port - ref|| / ||ref||)
within 1e-4; ``grad_norm`` within rtol 1e-5. A gradient the port's
autograd leaves as ``None`` counts as zeros (JAX returns zeros there).
"""
import dataclasses

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

torch.set_num_threads(1)

B, S, STEPS, LR = 2, 16, 3, 1e-3
# AdamW's eps in the parity steps (the default is 1e-8). An element whose
# gradient cancels to near eps, as some of a key bias's do in RoPE's
# slowest pairs, gets an update lr * g / (|g| + eps) that turns the
# float32 rounding of g into a visible change of the parameter. The
# reference disagrees with itself there: after three steps its two
# compilations (XLA's default optimisation and XLA_FAST) are, on `bk`,
# qwen2-vl-2b / qwen1.5-32b, 3.96e-3 / 2.04e-3 apart norm-wise at
# eps = 1e-8, 1.38e-4 / 6.0e-5 at 1e-6, 2.0e-5 / 1.0e-5 at 1e-5 and
# 3.9e-6 / 2.1e-6 at 1e-4; the port reads the same spread against either
# (3.39e-3 / 1.95e-3, 1.35e-4 / 5.8e-5, 2.2e-5 / 9.0e-6, 4.4e-6 / 3.1e-6).
# 1e-4 is far below a reduced model's typical gradient (~1e-2 an
# element), and chip_smoke.py's phase 15a takes the same value: the card
# against the CPU read up to 8.5e-5 at 1e-5.
EPS = 1e-4
RTOL, NORM_TOL = 1e-5, 1e-4
XLA_FAST = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def _port_cfg(jcfg):
    """The port's ModelConfig with the reference config's fields."""
    sub = {"moe": tmodels.MoEConfig, "mla": tmodels.MLAConfig,
           "ssm": tmodels.SSMConfig, "hybrid": tmodels.HybridConfig}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in sub.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return tmodels.ModelConfig(**kw)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=XLA_FAST)


def _np(t):
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t, np.float32) if t.dtype == jax.numpy.bfloat16 \
        else np.asarray(t)


def pairs(want, got, path=""):
    """(path, reference leaf, port leaf) over two trees of one structure,
    dicts matched by key."""
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in sorted(want):
            yield from pairs(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            yield from pairs(w, g, f"{path}/{i}")
    else:
        yield path, want, got


def norm_err(want, got) -> float:
    """||got - want|| / ||want|| in float64; ``got=None`` is zeros; 0 when
    both are zero."""
    w = np.asarray(_np(want), np.float64)
    g = np.zeros_like(w) if got is None else np.asarray(_np(got),
                                                        np.float64)
    assert w.shape == g.shape
    d, n = np.linalg.norm(g - w), np.linalg.norm(w)
    return float(d / n) if n > 0 else float(d)


WORST = {}


def assert_trees_close(want, got, what, tol=NORM_TOL):
    worst = max(((norm_err(w, g), p) for p, w, g in pairs(want, got)),
                default=(0.0, ""))
    WORST[what] = max(WORST.get(what, (0.0, "")), worst)
    assert worst[0] <= tol, f"{what}: {worst[1]} off by {worst[0]:.3g}"


def assert_metrics_close(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=1e-7, err_msg=k)


def ref_init(jcfg):
    key = jax.random.PRNGKey(0)
    return _compiled(lambda k: jmodels.init_params(jcfg, k), key)(key)


def _recording(opt, optim):
    """``opt`` whose ``apply`` also hands out the gradients it was given:
    the reference's in its returned state (a jitted step cannot leak them
    otherwise), the port's in a list."""
    if optim is joptim:
        return joptim.Optimizer(
            init=opt.init, apply=lambda p, s, g: (
                lambda r: (r[0], (r[1], g)))(opt.apply(p, s[0], g)))
    seen = []

    def apply(p, s, g):
        seen.append(g)
        return opt.apply(p, s, g)
    return toptim.Optimizer(init=opt.init, apply=apply), seen


def ref_steps(jcfg, params, batch, steps=STEPS, state=None):
    """The reference's ``make_train_step`` ``steps`` times: (params,
    state, [(metrics, grads) a step])."""
    opt = joptim.adamw(joptim.cosine_with_warmup(LR, 1, STEPS), eps=EPS)
    rec = _recording(opt, joptim)
    state = opt.init(params) if state is None else state
    fn = _compiled(jmodels.make_train_step(jcfg, rec), params,
                   (state, None), batch)
    out = []
    for _ in range(steps):
        params, (state, grads), metrics = fn(params, (state, None), batch)
        out.append((metrics, grads))
    return params, state, out


def port_steps(cfg, params, batch, steps=STEPS, state=None):
    opt = toptim.adamw(toptim.cosine_with_warmup(LR, 1, STEPS), eps=EPS)
    rec, seen = _recording(opt, toptim)
    state = opt.init(params) if state is None else state
    fn = tmodels.make_train_step(cfg, rec)
    out = []
    for _ in range(steps):
        params, state, metrics = fn(params, state, batch)
        out.append((metrics, seen[-1]))
    return params, state, out


def run_pair(jcfg, seed=0, steps=STEPS):
    """Reference and port from the same weights and batch: the loss and
    metrics of every step, the first step's gradients, and the parameters
    and moments after ``steps`` steps; returns both runs."""
    cfg = _port_cfg(jcfg)
    jparams = ref_init(jcfg)
    nb = jlm.lm_batch(np.random.RandomState(seed), jcfg, B, S)
    want = ref_steps(jcfg, jparams,
                     {k: jax.numpy.asarray(v) for k, v in nb.items()},
                     steps)
    got = port_steps(cfg, bridge.to_torch(jax.tree.map(np.asarray, jparams),
                                          "cpu"),
                     {k: torch.from_numpy(v) for k, v in nb.items()}, steps)
    check_pair(want, got)
    return want, got


def check_pair(want, got):
    (wp, ws, wsteps), (gp, gs, gsteps) = want, got
    assert_trees_close(wsteps[0][1], gsteps[0][1], "step 0 gradients")
    for i, ((wm, _), (gm, _)) in enumerate(zip(wsteps, gsteps)):
        assert_metrics_close(wm, gm)
    assert int(gs["step"]) == int(ws["step"])
    assert_trees_close(wp, gp, "parameters")
    assert_trees_close(ws["m"], gs["m"], "first moments")
    assert_trees_close(ws["v"], gs["v"], "second moments")


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_loss_grads_and_three_adamw_steps_match_reference(arch):
    """Per reduced config: ``loss_fn``'s loss and metrics, every gradient
    leaf, and three ``make_train_step`` steps (parameters, moments,
    ``grad_norm``) against the reference. falcon-mamba-7b and zamba2-7b
    differentiate through ``models/ssm.py:_selective_scan``."""
    (_, _, wsteps), (_, _, gsteps) = run_pair(jconfigs.get_reduced(arch))
    assert all(np.isfinite(float(m["total_loss"])) for m, _ in gsteps)
    assert set(gsteps[0][0]) == {"loss", "aux_loss", "total_loss",
                                 "grad_norm"}


def test_mtp_loss_matches_reference():
    """deepseek-v3-671b reduced with ``mtp=True``: the MTP block (norm of
    the final hidden state beside the next token's embedding, ``proj``, a
    causal dense block, the head) and its weighted loss, its gradients
    and three steps."""
    (_, _, wsteps), (_, _, gsteps) = run_pair(
        jconfigs.get_reduced("deepseek-v3-671b").replace(mtp=True))
    for (wm, _), (gm, _) in zip(wsteps, gsteps):
        assert float(gm["mtp_loss"]) > 0
        np.testing.assert_allclose(
            float(gm["total_loss"]),
            float(gm["loss"]) + float(gm["aux_loss"])
            + 0.3 * float(gm["mtp_loss"]), rtol=1e-6)


@pytest.mark.parametrize("dispatch", ["scatter", "grouped"])
def test_moe_dispatch_with_drops_trains_like_reference(dispatch):
    """granite reduced in the scatter and grouped dispatch modes, with a
    capacity that drops (token, slot) pairs in the first step."""
    from unittest import mock

    from repro_torch.models import moe as tmoe
    jcfg = jconfigs.get_reduced("granite-moe-3b-a800m")
    jcfg = jcfg.replace(moe=dataclasses.replace(
        jcfg.moe, dispatch=dispatch, capacity_factor=0.5))
    routes, router = [], tmoe._router

    def recording(*args):
        out = router(*args)
        routes.append(out[1])
        return out
    with mock.patch.object(tmoe, "_router", recording):
        run_pair(jcfg)
    cfg = _port_cfg(jcfg)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    rows = routes[0].reshape(B, S * k) if dispatch == "grouped" else \
        routes[0].reshape(1, B * S * k)
    C = tmoe.capacity(cfg, S if dispatch == "grouped" else B * S)
    counts = torch.stack([torch.bincount(r, minlength=E) for r in rows])
    assert int(counts.max()) > C, "the case must drop some (token, slot)"


def test_resume_from_reference_optimizer_state():
    """Two reference steps, then its parameters and optimizer state
    (``step``, ``m``, ``v``) bridged as they are: one more step on each
    side agrees."""
    jcfg = jconfigs.get_reduced("phi4-mini-3.8b")
    nb = jlm.lm_batch(np.random.RandomState(3), jcfg, B, S)
    jb = {k: jax.numpy.asarray(v) for k, v in nb.items()}
    jparams, jstate, _ = ref_steps(jcfg, ref_init(jcfg), jb, steps=2)
    want = ref_steps(jcfg, jparams, jb, steps=1, state=jstate)

    def bridged(tree):
        return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")
    state = bridged(jstate)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 2
    got = port_steps(_port_cfg(jcfg), bridged(jparams),
                     {k: torch.from_numpy(v) for k, v in nb.items()},
                     steps=1, state=state)
    check_pair(want, got)
    assert int(got[1]["step"]) == 3
