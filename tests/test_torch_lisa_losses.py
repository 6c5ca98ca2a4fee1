"""The LISA system's losses in the port held against the reference:
``core/bottleneck.py``'s straight-through round trip (``roundtrip_st``,
``recon_loss``) and its gradients, ``core/vlm.py``'s ``insight_forward``
(with and without a bottleneck pair), ``context_forward``,
``insight_loss`` with its metrics, ``context_loss``, and the gradient of
``core/training.py:mixed_loss`` on every leaf of ``init_lisa``.

Weights are the reference's own draws (``init_lisa``, ``init_bottleneck``)
through the bridge; inputs come from numpy with a seed (floodseg scenes
for the pipeline). The reference's functions are compiled at a low XLA
optimisation level (``test_torch_train_zoo._compiled``).

Tolerances: losses, metrics and the round trip's values and gradients
within rtol 1e-5 (a bf16 round trip's output within one bf16 step); the
pipeline's logits within rtol 1e-4, atol 1e-5 (their float32 sums run in
another order: a mask logit of 1.8 reads 2.6e-6 apart); every gradient
leaf of ``mixed_loss`` norm-wise (||port - ref|| / ||ref||) within 1e-5
(the worst reads 8.1e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lisa_mini import CONFIG as JP
from repro.core import bottleneck as jbn
from repro.core import training as jtraining
from repro.core import vlm as jvlm
from repro.data import floodseg as jflood
from repro_torch import bridge
from repro_torch.configs import get_lisa_config
from repro_torch.core import bottleneck as tbn
from repro_torch.core import training as ttraining
from repro_torch.core import vlm as tvlm
from repro_torch.models.model import value_and_grad

from test_torch_train_zoo import _compiled, norm_err, pairs

torch.set_num_threads(1)

TP = get_lisa_config("lisa-mini")
RTOL = 1e-5
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
NORM_TOL = 1e-5
B = 4


def _t(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.fixture(scope="module")
def ref():
    """The reference's lisa-mini weights and r = 0.25 pair, bridged, and
    a seeded Insight and Context batch."""
    key = jax.random.PRNGKey(0)
    params = _compiled(lambda k: jvlm.init_lisa(JP, k), key)(key)
    d = JP.sam.d_model
    spec = jbn.BottleneckSpec(d, jbn.rank_for_ratio(d, 0.25, 4), 4)
    pair = jbn.init_bottleneck(jax.random.PRNGKey(250), spec)
    rng = np.random.RandomState(3)
    ins = jflood.make_batch(rng, B, "segment")
    ctx = jflood.make_batch(rng, B, "count")
    return {"params": params, "tparams": _t(params), "pair": pair,
            "tpair": _t(pair), "ins": ins, "ctx": ctx,
            "tins": {k: torch.from_numpy(v) for k, v in ins.items()},
            "tctx": {k: torch.from_numpy(v) for k, v in ctx.items()}}


# ---------------------------------------------------------------------------
# the straight-through bottleneck
# ---------------------------------------------------------------------------


def _pair(rng, d=96, rank=40):
    return {"enc": (rng.randn(d, rank) / np.sqrt(d)).astype(np.float32),
            "dec": (rng.randn(rank, d) / np.sqrt(rank)).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roundtrip_st_and_recon_loss_match_reference(dtype):
    """Values and the gradients to ``enc`` and ``dec`` (of the round trip
    under a seeded cotangent, and of ``recon_loss``) equal the reference's
    within RTOL; the gradients are the straight-through ones: the rounding
    and the scale pass no gradient."""
    rng = np.random.RandomState(5)
    pair = _pair(rng)
    x = rng.randn(2, 24, 96).astype(np.float32)
    cot = rng.randn(2, 24, 96).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tcot = torch.from_numpy(cot).to(tx.dtype)

    out, vjp = jax.vjp(lambda p: jbn.roundtrip_st(p, jx), pair)
    (jg,) = vjp(jnp.asarray(cot).astype(dtype))
    jl, jlg = jax.value_and_grad(lambda p: jbn.recon_loss(p, jx))(pair)

    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in pair.items()}
    tout = tbn.roundtrip_st(tp, tx)
    assert tout.dtype == tx.dtype
    tg = torch.autograd.grad(tout, [tp["enc"], tp["dec"]], tcot)
    tl = tbn.recon_loss(tp, tx)
    tlg = torch.autograd.grad(tl, [tp["enc"], tp["dec"]])

    want = np.asarray(out, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(_np(tout), want, rtol=RTOL, atol=1e-6)
    else:       # one bf16 step of the float32 result, at most
        np.testing.assert_allclose(_np(tout), want, rtol=2.0 ** -8, atol=0)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    for name, a, b in (("enc", tg[0], jg["enc"]), ("dec", tg[1], jg["dec"]),
                       ("recon enc", tlg[0], jlg["enc"]),
                       ("recon dec", tlg[1], jlg["dec"])):
        assert norm_err(b, a) <= RTOL, name

    # the straight-through gradients in closed form: out = (z + c s) dec
    # with c s constant, so d/d enc = x^T (g dec^T), d/d dec = (zq s)^T g
    xf, gf = tx.double().reshape(-1, 96), tcot.double().reshape(-1, 96)
    enc, dec = (tp[k].detach().double() for k in ("enc", "dec"))
    z = xf @ enc
    s = z.abs().amax(-1, keepdim=True) / 127.0 + 1e-8
    zq = torch.clamp(torch.round(z / s), -127, 127) * s
    assert norm_err(_np(xf.T @ (gf @ dec.T)), tg[0]) <= RTOL
    assert norm_err(_np(zq.T @ gf), tg[1]) <= RTOL


def test_roundtrip_st_forward_is_the_plain_round_trip():
    """On float32 x the forward equals ``decode(*encode(x))`` but for
    tokens with a code at a .5 tie (``z / s + (round - z / s)`` may round
    otherwise than ``round``)."""
    rng = np.random.RandomState(6)
    pair = {k: torch.from_numpy(v) for k, v in _pair(rng).items()}
    x = torch.from_numpy(rng.randn(3, 40, 96).astype(np.float32))
    got = tbn.roundtrip_st(pair, x)
    want = tbn.decode(pair, *tbn.encode(pair, x))
    z = x @ pair["enc"]
    frac = (z / tbn._absmax_scale(z)).abs() % 1.0
    tie = ((frac - 0.5).abs() < 1e-4).any(-1)
    assert tie.float().mean() < 0.05
    np.testing.assert_allclose(got[~tie].numpy(), want[~tie].numpy(),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the pipeline's forwards and losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_pair", [False, True])
def test_insight_forward_matches_reference(ref, with_pair):
    jpair = ref["pair"] if with_pair else None
    tpair = ref["tpair"] if with_pair else None
    ins = ref["ins"]
    args = (ref["params"], jpair, ins["images"], ins["query"])
    ml, al = _compiled(lambda p, bp, i, q: jvlm.insight_forward(
        p, JP, i, q, bn_params=bp), *args)(*args)
    with torch.inference_mode():
        tml, tal = tvlm.insight_forward(ref["tparams"], TP,
                                        ref["tins"]["images"],
                                        ref["tins"]["query"],
                                        bn_params=tpair)
    assert tml.shape == (B, 32, 32) and tal.shape == (B, TP.llm.vocab_size)
    np.testing.assert_allclose(tml.numpy(), np.asarray(ml), **LOGIT_TOL)
    np.testing.assert_allclose(tal.numpy(), np.asarray(al), **LOGIT_TOL)


def test_context_forward_matches_reference(ref):
    ctx = ref["ctx"]
    args = (ref["params"], ctx["images"], ctx["query"])
    cl = _compiled(lambda p, i, q: jvlm.context_forward(p, JP, i, q),
                   *args)(*args)
    with torch.inference_mode():
        tcl = tvlm.context_forward(ref["tparams"], TP, ref["tctx"]["images"],
                                   ref["tctx"]["query"])
    assert tcl.shape == (B, TP.llm.vocab_size)
    np.testing.assert_allclose(tcl.numpy(), np.asarray(cl), **LOGIT_TOL)


@pytest.mark.parametrize("with_pair", [False, True])
def test_insight_and_context_losses_match_reference(ref, with_pair):
    """``insight_loss`` (the BCE weighting the whole per-pixel term, dice
    with +1 smoothing, half the answer CE) with its metrics, and
    ``context_loss``, within RTOL."""
    jpair = ref["pair"] if with_pair else None
    tpair = ref["tpair"] if with_pair else None
    jl, jm = _compiled(lambda p, bp, b: jvlm.insight_loss(
        p, JP, b, bn_params=bp), ref["params"], jpair, ref["ins"])(
        ref["params"], jpair, ref["ins"])
    with torch.inference_mode():
        tl, tm = tvlm.insight_loss(ref["tparams"], TP, ref["tins"],
                                   bn_params=tpair)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    assert sorted(tm) == sorted(jm) == ["answer_ce", "bce", "dice"]
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   err_msg=k)
    jc, jcm = _compiled(lambda p, b: jvlm.context_loss(p, JP, b),
                        ref["params"], ref["ctx"])(ref["params"], ref["ctx"])
    with torch.inference_mode():
        tc, tcm = tvlm.context_loss(ref["tparams"], TP, ref["tctx"])
    np.testing.assert_allclose(float(tc), float(jc), rtol=RTOL)
    np.testing.assert_allclose(float(tcm["answer_ce"]),
                               float(jcm["answer_ce"]), rtol=RTOL)


def test_mixed_loss_gradients_match_reference_on_every_leaf(ref):
    """``jax.value_and_grad(mixed_loss)``: the loss and its metrics within
    RTOL, the gradient of every leaf of ``init_lisa`` norm-wise within
    NORM_TOL (a leaf autograd leaves ``None`` counts as zeros)."""
    def ref_fn(p, ins, ctx):
        return jax.value_and_grad(lambda q: jtraining.mixed_loss(
            q, JP, ins, ctx), has_aux=True)(p)
    args = (ref["params"], ref["ins"], ref["ctx"])
    (jl, jm), jg = _compiled(ref_fn, *args)(*args)
    tl, tm, tg = value_and_grad(lambda q: ttraining.mixed_loss(
        q, TP, ref["tins"], ref["tctx"]), ref["tparams"])
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    assert sorted(tm) == sorted(jm) == ["answer_ce", "bce", "ctx_ce", "dice"]
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   err_msg=k)
    errs = [(norm_err(w, g), p) for p, w, g in pairs(jg, tg)]
    assert len(errs) == len(jax.tree.leaves(ref["params"]))
    worst = max(errs)
    assert worst[0] <= NORM_TOL, worst
    assert all(np.any(np.asarray(w)) for _, w, _ in pairs(jg, tg))
