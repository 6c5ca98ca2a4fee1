"""The zoo's Mamba path in the port (``models/ssm.py``, the mamba1 /
mamba2 / hybrid groups of ``models/stack.py``, ``models/model.py``,
``core/split.py`` and the two SSM zoo configs), held against the
reference on bridged weights of the reference's own ``init_params``.

The port runs on ``device="cpu"``, where ``use_ssm_kernel=True`` takes
the scan kernel's plain version (``scan_ref``); the reference runs its
Pallas scan in interpret mode. Inputs come from numpy with a seed.

Tolerances: module outputs and decode states rtol 1e-4, atol 1e-5, and
model logits rtol/atol 1e-4 (float32 summation order through the
layers); greedy tokens exactly equal; decode against forward within
2e-3 of the logits' scale, the reference's own bound
(tests/test_decode_consistency.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.core.split import SplitPlan as JSplitPlan
from repro.models import common as jc
from repro.models import ssm as jssm
from repro.models import stack as jstack
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.core import SplitPlan
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.models import ssm as tssm
from repro_torch.models import stack as tstack
from repro_torch.models.common import causal_mask

torch.set_num_threads(1)

MOD = dict(rtol=1e-4, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
B = 2
NEW = 4                                     # greedy tokens after the prompt

# the SSM cases of tests/test_decode_consistency.py
J = jmodels
SSM_CASES = [
    J.ModelConfig(name="mamba1", arch_type="ssm", num_layers=2, d_model=64,
                  num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=97,
                  attn_type="none", rope_style="none",
                  ssm=J.SSMConfig(version=1, state_size=4)),
    J.ModelConfig(name="mamba2", arch_type="ssm", num_layers=2, d_model=64,
                  num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=97,
                  attn_type="none", rope_style="none",
                  ssm=J.SSMConfig(version=2, state_size=8, head_dim=16)),
    J.ModelConfig(name="hybrid", arch_type="hybrid", num_layers=4,
                  d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
                  vocab_size=97,
                  ssm=J.SSMConfig(version=2, state_size=8, head_dim=16),
                  hybrid=J.HybridConfig(attn_every=2)),
]
MODEL_CASES = SSM_CASES + [jconfigs.get_reduced("falcon-mamba-7b"),
                           jconfigs.get_reduced("zamba2-7b")]
ZOO = ("falcon-mamba-7b", "zamba2-7b")


def _port_cfg(jcfg):
    """The port's ModelConfig with the reference config's fields."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(jcfg)}
    if jcfg.ssm is not None:
        kw["ssm"] = tmodels.SSMConfig(**dataclasses.asdict(jcfg.ssm))
    if jcfg.hybrid is not None:
        kw["hybrid"] = tmodels.HybridConfig(
            **dataclasses.asdict(jcfg.hybrid))
    return tmodels.ModelConfig(**kw)


def _bridge(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), device="cpu")


def _jinit(jcfg):
    return jax.jit(lambda k: jmodels.init_params(jcfg, k))(
        jax.random.PRNGKey(0))


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# models/ssm.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("name", ZOO)
def test_mamba_full_matches_reference(name, kernel):
    """``mamba1_full`` (falcon-mamba) / ``mamba2_full`` (zamba2) at the
    reduced widths, with and without ``use_ssm_kernel``."""
    jcfg = jconfigs.get_reduced(name).replace(use_ssm_kernel=kernel)
    tcfg = _port_cfg(jcfg)
    v1 = jcfg.ssm.version == 1
    jp = (jssm.init_mamba1 if v1 else jssm.init_mamba2)(
        jax.random.PRNGKey(3), jcfg)
    x = np.random.RandomState(4).randn(B, 21, jcfg.d_model).astype(
        np.float32)
    full = jssm.mamba1_full if v1 else jssm.mamba2_full
    want = jax.jit(lambda p, x: full(p, jcfg, x))(jp, x)
    before = sops.scan_launches
    got = (tssm.mamba1_full if v1 else tssm.mamba2_full)(
        _bridge(jp), tcfg, torch.from_numpy(x))
    assert sops.scan_launches == before           # CPU: the plain version
    np.testing.assert_allclose(_np(got), np.asarray(want), **MOD)


@pytest.mark.parametrize("name", ZOO)
def test_mamba_step_matches_reference_and_updates_in_place(name):
    jcfg = jconfigs.get_reduced(name)
    tcfg = _port_cfg(jcfg)
    v1 = jcfg.ssm.version == 1
    jp = (jssm.init_mamba1 if v1 else jssm.init_mamba2)(
        jax.random.PRNGKey(5), jcfg)
    rng = np.random.RandomState(6)
    empty = (jssm.mamba1_empty_state if v1 else jssm.mamba2_empty_state)(
        jcfg, B)
    state = {k: (rng.randn(*v.shape) * 0.5).astype(np.float32)
             for k, v in empty.items()}
    x = rng.randn(B, 1, jcfg.d_model).astype(np.float32)
    step = jssm.mamba1_step if v1 else jssm.mamba2_step
    want, want_state = jax.jit(lambda p, x, s: step(p, jcfg, x, s))(
        jp, x, state)
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    leaves = dict(tstate)
    got, got_state = (tssm.mamba1_step if v1 else tssm.mamba2_step)(
        _bridge(jp), tcfg, torch.from_numpy(x), tstate)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MOD)
    for k in ("conv", "h"):
        assert got_state[k] is leaves[k]          # updated in place
        np.testing.assert_allclose(_np(got_state[k]),
                                   np.asarray(want_state[k]), **MOD)


def test_selective_scan_broadcast_decay_equals_full_decay():
    """The plain scan combines Mamba-2's per-head decay at its own size;
    that gives the values of the reference's materialised broadcast."""
    rng = np.random.RandomState(7)
    decay = torch.from_numpy(rng.uniform(0.5, 1, (2, 19, 3, 1, 1)).astype(
        np.float32))
    drive = torch.from_numpy(rng.randn(2, 19, 3, 4, 5).astype(np.float32))
    full = tssm._selective_scan(decay.expand(drive.shape).contiguous(),
                                drive)
    assert torch.equal(tssm._selective_scan(decay, drive), full)
    np.testing.assert_allclose(
        _np(full), np.asarray(jax.jit(jssm._selective_scan)(
            jnp.broadcast_to(decay.numpy(), drive.shape), drive.numpy())),
        rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# models/model.py: forward, prefill_step, decode_step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=MODEL_CASES, ids=lambda c: c.name)
def model(request):
    """(reference cfg, port cfg, reference params, bridged params,
    tokens (B, S))."""
    jcfg = request.param
    jp = _jinit(jcfg)
    tokens = np.random.RandomState(1).randint(
        0, jcfg.vocab_size, (B, 12)).astype(np.int32)
    return jcfg, _port_cfg(jcfg), jp, _bridge(jp), tokens


def test_forward_and_prefill_match_reference(model):
    jcfg, tcfg, jp, tp, tokens = model
    jlogits, _, _, jhidden = jax.jit(
        lambda p, t: jmodels.forward(p, jcfg, {"tokens": t}))(jp, tokens)
    for kernel in (False, True):
        cfg = tcfg.replace(use_ssm_kernel=kernel)
        logits, aux, _, hidden = tmodels.forward(
            tp, cfg, {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits),
                                   **LOGITS)
        np.testing.assert_allclose(_np(hidden), np.asarray(jhidden),
                                   **LOGITS)
        assert float(aux) == 0.0
        last, cache = tmodels.prefill_step(
            tp, cfg, {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(_np(last), np.asarray(jlogits[:, -1:]),
                                   **LOGITS)
        jlast, jcache = jax.jit(lambda p, t: jmodels.prefill_step(
            p, jcfg, {"tokens": t}))(jp, tokens)
        assert np.array_equal(_np(cache["positions"]),
                              np.asarray(jcache["positions"]))
        for g, jg in zip(cache["groups"], jcache["groups"]):
            # SSM groups hand no state to decode; hybrid groups their k/v
            assert (g is None) == (jg is None)
            if g is not None:
                for k in ("k", "v"):
                    np.testing.assert_allclose(_np(g[k]), np.asarray(jg[k]),
                                               **LOGITS)


def _port_greedy(tp, tcfg, tokens):
    S = tokens.shape[1]
    cache = tmodels.init_cache(tcfg, B, S + NEW, device="cpu")
    logits, toks = [], []
    for t in range(S + NEW):
        tk = (torch.from_numpy(tokens[:, t:t + 1]) if t < S
              else toks[-1])
        lg, cache2 = tmodels.decode_step(tp, tcfg, cache, tk, t)
        assert cache2 is cache                        # updated in place
        logits.append(_np(lg[:, 0]))
        if t >= S - 1:
            toks.append(torch.argmax(lg[:, -1], dim=-1)[:, None].int())
    return np.stack(logits, 1), np.concatenate([_np(t) for t in toks], 1)


def _ref_greedy(jp, jcfg, tokens):
    S = tokens.shape[1]
    cache = jmodels.init_cache(jcfg, B, S + NEW)
    dec = jax.jit(lambda p, c, t, pos: jmodels.decode_step(p, jcfg, c, t,
                                                           pos))
    logits, toks = [], []
    for t in range(S + NEW):
        tk = tokens[:, t:t + 1] if t < S else toks[-1]
        lg, cache = dec(jp, cache, jnp.asarray(tk), jnp.int32(t))
        logits.append(np.asarray(lg[:, 0]))
        if t >= S - 1:
            toks.append(np.asarray(jnp.argmax(lg[:, -1], -1))[:, None])
    return np.stack(logits, 1), np.concatenate(toks, 1)


def test_greedy_decode_matches_reference_and_forward(model):
    """The prompt fed through ``decode_step`` from ``init_cache`` (the
    reference's prefill hands SSM groups no state), then NEW greedy
    tokens: tokens exactly equal to the reference's, logits within 1e-4;
    and the prompt's decode logits against the port's own forward within
    2e-3 of their scale."""
    jcfg, tcfg, jp, tp, tokens = model
    got_logits, got_toks = _port_greedy(tp, tcfg, tokens)
    want_logits, want_toks = _ref_greedy(jp, jcfg, tokens)
    assert np.array_equal(got_toks, want_toks)
    np.testing.assert_allclose(got_logits, want_logits, **LOGITS)
    full, *_ = tmodels.forward(tp, tcfg, {"tokens": torch.from_numpy(
        tokens)})
    S = tokens.shape[1]
    err = float(np.max(np.abs(got_logits[:, :S] - _np(full))))
    scale = float(np.max(np.abs(_np(full)))) + 1.0
    assert err < 2e-3 * scale, f"{tcfg.name}: decode mismatch {err}"


# ---------------------------------------------------------------------------
# core/split.py
# ---------------------------------------------------------------------------


def test_split_head_tail_equals_forward_and_reference():
    """SplitPlan at k=2 on the SSM config of tests/test_bottleneck_split.py:
    head + tail over the embedded prompt gives forward's hidden state, and
    the reference SplitPlan's; each side's layers are views of the full
    model's weights."""
    jcfg = J.ModelConfig(name="s", arch_type="ssm", num_layers=4, d_model=64,
                         num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=97,
                         attn_type="none", rope_style="none",
                         ssm=J.SSMConfig(version=1, state_size=4))
    tcfg = _port_cfg(jcfg)
    jp = _jinit(jcfg)
    tp = _bridge(jp)
    tokens = np.random.RandomState(2).randint(0, 97, (B, 16)).astype(
        np.int32)
    S = tokens.shape[1]
    positions = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    jmask = jc.causal_mask(S)[None]
    jplan = JSplitPlan(jcfg, 2)
    je, jcl = jplan.split_params(jp)
    want = jax.jit(lambda e, c, x: jplan.tail_apply(
        c, jplan.head_apply(e, x, positions, jmask), positions, jmask))(
        je, jcl, jnp.take(jp["embed"], tokens, axis=0))

    plan = SplitPlan(tcfg, 2)
    edge, cloud = plan.split_params(tp)
    w = tp["groups"][0]["mixer"]["in_proj"]
    assert edge["groups"][0]["mixer"]["in_proj"].data_ptr() == w.data_ptr()
    assert cloud["groups"][0]["mixer"]["in_proj"].data_ptr() \
        == w[2].data_ptr()
    x = tp["embed"][torch.from_numpy(tokens).long()]
    tpos = torch.from_numpy(positions.copy())
    mask = causal_mask(S)[None]
    mid = plan.head_apply(edge, x, tpos, mask)
    h = plan.tail_apply(cloud, mid, tpos, mask)
    *_, hidden = tmodels.forward(tp, tcfg, {"tokens": torch.from_numpy(
        tokens)})
    assert torch.equal(h, hidden)
    np.testing.assert_allclose(_np(h), np.asarray(want), **MOD)
    with pytest.raises(ValueError):
        SplitPlan(tcfg, 4)


# ---------------------------------------------------------------------------
# configs, parameter counts, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,count", [("falcon-mamba-7b", 7_272_665_088),
                                        ("zamba2-7b", 6_751_130_832)])
def test_count_params_equals_reference(name, count):
    cfg = tconfigs.get_config(name)
    assert tstack.count_params(cfg) == count
    assert jstack.count_params(jconfigs.get_config(name)) == count


@pytest.mark.parametrize("name", ZOO)
def test_configs_equal_reference(name):
    for get in ("get_config", "get_reduced"):
        got = getattr(tconfigs, get)(name)
        want = getattr(jconfigs, get)(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(KeyError):
        tconfigs.get_config("granite-moe-3b")


def test_unported_paths_raise():
    """SSM state has no sequence axis to page, and an encoder-only model
    has no decode step (both as in the reference); the MoE group, the
    other modalities and MTP are ported (tests/test_torch_zoo.py)."""
    cfg = tconfigs.get_reduced("falcon-mamba-7b")
    spec = tstack.layer_groups(cfg)[0]
    with pytest.raises(NotImplementedError, match="attention stacks"):
        tstack.group_decode_paged(None, cfg, spec, None, None, None, None,
                                  None, None, None)
    with pytest.raises(NotImplementedError, match="attention stacks"):
        tstack.group_verify_paged(None, cfg, spec, None, None, None, None,
                                  None, None, None)
    moe = tconfigs.get_reduced("granite-moe-3b-a800m")
    p = tstack.init_group(torch.Generator(), moe, tstack.GroupSpec("moe", 1))
    assert p["moe"]["router"].dtype == torch.float32
    with pytest.raises(ValueError, match="encoder-only"):
        tmodels.decode_step(None, tconfigs.get_reduced("hubert-xlarge"),
                            None, None, 0)
