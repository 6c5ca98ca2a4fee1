"""The attention kernels' head sizes: every entry of ``HEAD_DIMS`` (32, 64,
80, 112, 128, 192) in both attention ``ops.py`` modules, held against the
reference.

The wrappers' validators (``_check``, ``_check_paged``) accept every entry
on CPU tensors and refuse the others before a launch; every causal GQA
config of the repo (and the full-size encoders) resolves to an entry; at
hd 80, 112 and 192 the port's plain versions of the four kernels (the CPU
path of the wrappers) agree with the reference's Pallas kernels in
interpret mode at the reference's fp32 kernel-test tolerance; and reduced
zamba2-7b and nemotron-4-340b at hd 112 and 192 with ``use_flash`` and
``use_flash_decode`` give the reference's prefill, hidden states and
greedy tokens on bridged weights. The CUDA kernels at these sizes are
held against their plain versions on the card by ``chip_smoke.py``
(phase 3's ``head_dim_cases`` and phase 20); its new code is rehearsed
here on the CPU (the cases' shapes, phase 20 at reduced widths with
counting wrappers, the control-scaled limits of ``replay_within`` and
``decode_ties(control=)``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.kernels.decode_attention import ops as jops
from repro.kernels.flash_attention import ops as jfops
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.kernels.decode_attention import ops, ref
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref

torch.set_num_threads(1)

HEAD_DIMS = (32, 64, 80, 112, 128, 192)
NEW_DIMS = (80, 112, 192)
NEG_INF = -1e30
FP32 = dict(rtol=1e-4, atol=2e-5)       # the reference's fp32 kernel tests


def _flash_args(hd, S=16, H=4, K=2):
    q = torch.zeros(1, S, H, hd)
    return q, torch.zeros(1, S, K, hd), torch.zeros(1, S, K, hd)


def _decode_args(hd, B=2, H=4, K=2, W=8):
    return (torch.zeros(B, H, hd), torch.zeros(B, W, K, hd),
            torch.zeros(B, W, K, hd), torch.zeros(B, W))


def _paged_args(hd, C=None, B=2, H=4, K=2, P=3, page=4, n=2):
    q = torch.zeros((B, H, hd) if C is None else (B, C, H, hd))
    bias = torch.zeros((B, n * page) if C is None else (B, C, n * page))
    return (q, torch.zeros(P, page, K, hd), torch.zeros(P, page, K, hd),
            torch.zeros(B, n, dtype=torch.int32), bias)


def _validators(hd):
    return [lambda: fops._check(*_flash_args(hd)),
            lambda: ops._check(*_decode_args(hd)),
            lambda: ops._check_paged(*_paged_args(hd)),
            lambda: ops._check_paged(*_paged_args(hd, C=3))]


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_validators_accept_every_head_size(hd):
    """What the CUDA path checks before it launches, on CPU tensors: every
    entry of HEAD_DIMS passes the flash, decode, paged and verify checks."""
    for check in _validators(hd):
        check()


@pytest.mark.parametrize("hd", [48, 96])
def test_validators_refuse_other_head_sizes(hd):
    for check in _validators(hd):
        with pytest.raises(ValueError, match=f"head_dim {hd} not in"):
            check()


def _gqa_decoders():
    return [n for n in tconfigs.REGISTRY
            if tconfigs.get_config(n).attn_type == "gqa"
            and tconfigs.get_config(n).causal]


@pytest.mark.parametrize("name", _gqa_decoders()
                         + ["lisa-7b", "lisa-mini", "lisa-nano"])
def test_every_causal_gqa_config_takes_a_kernel_head_size(name):
    """The zoo's GQA decoders and the LISA LLMs, which ``gqa_full`` and
    ``gqa_decode`` send to the kernels: a guard for future configs."""
    cfg = (tconfigs.get_lisa_config(name).llm if name.startswith("lisa")
           else tconfigs.get_config(name))
    assert cfg.causal and cfg.attn_type == "gqa"
    assert cfg.resolved_head_dim in HEAD_DIMS
    assert cfg.resolved_head_dim == (
        jconfigs.get_lisa_config(name).llm if name.startswith("lisa")
        else jconfigs.get_config(name)).resolved_head_dim


def test_full_size_encoders_take_a_kernel_head_size():
    """LISA-7B's SAM (80) and CLIP (64) and hubert-xlarge (80)."""
    lisa = tconfigs.get_lisa_config("lisa-7b")
    hubert = tconfigs.get_config("hubert-xlarge")
    got = [c.resolved_head_dim for c in (lisa.sam, lisa.clip, hubert)]
    assert got == [80, 64, 80]
    assert set(got) <= set(HEAD_DIMS)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _t(*arrs):
    return tuple(torch.from_numpy(a) for a in arrs)


def _j(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", NEW_DIMS)
def test_flash_plain_matches_pallas(hd, causal):
    """G = 2, an S that is no multiple of the blocks."""
    rng = np.random.RandomState(hd)
    B, S, H, K = 2, 100, 4, 2
    q = rng.randn(B, S, H, hd).astype(np.float32)
    k = rng.randn(B, S, K, hd).astype(np.float32)
    v = rng.randn(B, S, K, hd).astype(np.float32)
    out = fops.flash_attention(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(
        out, fref.attention_ref(*_t(q, k, v), causal=causal).numpy(), **FP32)
    pallas = jfops.flash_attention(*_j(q, k, v), causal=causal, block_q=64,
                                   block_k=64)
    np.testing.assert_allclose(out, np.asarray(pallas), **FP32)


@pytest.mark.parametrize("hd", NEW_DIMS)
def test_decode_plain_matches_pallas(hd):
    """G = 2, lengths spread over the rows, one row idle."""
    rng = np.random.RandomState(hd)
    B, H, K, W = 3, 4, 2, 128
    q = rng.randn(B, H, hd).astype(np.float32)
    k = rng.randn(B, W, K, hd).astype(np.float32)
    v = rng.randn(B, W, K, hd).astype(np.float32)
    bias = np.where(np.arange(W)[None] < np.array([0, 40, W])[:, None], 0.0,
                    NEG_INF).astype(np.float32)
    out = ops.decode_attention(*_t(q, k, v, bias)).numpy()
    assert np.isfinite(out).all()
    pallas = jops.decode_attention(*_j(q, k, v, bias), block_k=64)
    np.testing.assert_allclose(out, np.asarray(pallas), **FP32)


def _pool(rng, B, H, K, hd, P, page, n, C=None):
    q = rng.randn(*((B, H, hd) if C is None else (B, C, H, hd))).astype(
        np.float32)
    kp = rng.randn(P, page, K, hd).astype(np.float32)
    vp = rng.randn(P, page, K, hd).astype(np.float32)
    pt = rng.randint(0, P, (B, n)).astype(np.int32)
    return q, kp, vp, pt


@pytest.mark.parametrize("hd", NEW_DIMS)
def test_paged_decode_plain_matches_pallas(hd):
    rng = np.random.RandomState(hd)
    B, H, K, P, page, n = 3, 4, 2, 9, 16, 3
    q, kp, vp, pt = _pool(rng, B, H, K, hd, P, page, n)
    lens = np.linspace(1, n * page, B).astype(int)
    bias = np.where(np.arange(n * page)[None] < lens[:, None], 0.0,
                    NEG_INF).astype(np.float32)
    out = ops.paged_decode_attention(*_t(q, kp, vp, pt, bias)).numpy()
    pallas = jops.paged_decode_attention(*_j(q, kp, vp, pt, bias))
    np.testing.assert_allclose(out, np.asarray(pallas), **FP32)


@pytest.mark.parametrize("hd", NEW_DIMS)
def test_verify_plain_matches_pallas(hd):
    """C = 4 queries a row, each with its own ragged length; G = 2."""
    rng = np.random.RandomState(hd)
    B, C, H, K, P, page, n = 2, 4, 4, 2, 12, 4, 6
    q, kp, vp, pt = _pool(rng, B, H, K, hd, P, page, n, C=C)
    lens = rng.randint(1, n * page + 1, (B, C))
    bias = np.where(np.arange(n * page)[None, None] < lens[..., None], 0.0,
                    NEG_INF).astype(np.float32)
    out = ops.paged_verify_attention(*_t(q, kp, vp, pt, bias)).numpy()
    assert out.shape == (B, C, H, hd)
    pallas = jops.paged_verify_attention(*_j(q, kp, vp, pt, bias))
    np.testing.assert_allclose(out, np.asarray(pallas), **FP32)


# ---------------------------------------------------------------------------
# reduced zamba2-7b and nemotron-4-340b at their head sizes, through both
# kernel switches
# ---------------------------------------------------------------------------

B, S, NEW = 2, 12, 4
# head_dim as the full configs resolve it; nemotron keeps GQA (G = 2)
MODELS = {"zamba2-7b": dict(head_dim=112),
          "nemotron-4-340b": dict(head_dim=192, num_kv_heads=2)}


def _port_cfg(jcfg):
    sub = {"moe": tmodels.MoEConfig, "mla": tmodels.MLAConfig,
           "ssm": tmodels.SSMConfig, "hybrid": tmodels.HybridConfig}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in sub.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return tmodels.ModelConfig(**kw)


def _greedy(step, init, tokens):
    """The prompt through ``step`` from ``init()``, then NEW greedy tokens;
    (logits (B, S+NEW, V), tokens (B, NEW)) as numpy."""
    cache = init()
    logits, toks = [], []
    for t in range(S + NEW):
        tk = tokens[:, t:t + 1] if t < S else toks[-1]
        lg, cache = step(cache, tk, t)
        lg = np.asarray(lg.numpy() if isinstance(lg, torch.Tensor) else lg)
        logits.append(lg[:, 0])
        if t >= S - 1:
            toks.append(np.argmax(lg[:, -1], -1)[:, None].astype(np.int32))
    return np.stack(logits, 1), np.concatenate(toks[:NEW], 1)


@pytest.mark.parametrize("name", list(MODELS))
def test_reduced_models_at_their_head_sizes_match_reference(name):
    """Prefill logits, forward's logits and hidden states within the zoo
    tests' tolerance (rtol 1e-4, atol 2e-5), greedy tokens exactly equal
    and decode logits within 1e-4, with ``use_flash`` and
    ``use_flash_decode`` on: the port's plain versions against the
    reference's Pallas kernels in interpret mode."""
    jcfg = jconfigs.get_reduced(name).replace(
        use_flash=True, use_flash_decode=True, **MODELS[name])
    tcfg = _port_cfg(jcfg)
    assert tcfg.resolved_head_dim == MODELS[name]["head_dim"]
    jp = jax.jit(lambda key: jmodels.init_params(jcfg, key))(
        jax.random.PRNGKey(0))
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens}
    tbatch = {"tokens": torch.from_numpy(tokens)}
    jlogits, _, _, jhidden = jmodels.forward(jp, jcfg, batch)
    logits, _, _, hidden = tmodels.forward(tp, tcfg, tbatch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **FP32)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), **FP32)
    jlast, _ = jmodels.prefill_step(jp, jcfg, batch)
    last, _ = tmodels.prefill_step(tp, tcfg, tbatch)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **FP32)
    dec = jax.jit(lambda p, c, t, pos: jmodels.decode_step(p, jcfg, c, t,
                                                           pos))
    want_l, want_t = _greedy(
        lambda c, t, pos: dec(jp, c, jnp.asarray(t), jnp.int32(pos)),
        lambda: jmodels.init_cache(jcfg, B, S + NEW), tokens)
    got_l, got_t = _greedy(
        lambda c, t, pos: tmodels.decode_step(
            tp, tcfg, c, torch.from_numpy(np.asarray(t)), pos),
        lambda: tmodels.init_cache(tcfg, B, S + NEW, "cpu"), tokens)
    assert np.array_equal(got_t, want_t)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase-3 cases and phase 20, rehearsed on the CPU
# ---------------------------------------------------------------------------


def _load_chip_smoke():
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def cs(monkeypatch):
    """``chip_smoke`` with the card's calls stubbed for CPU tensors."""
    mod = _load_chip_smoke()
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(mod, "card_line", lambda: "cpu")
    return mod


def test_head_dim_cases_hold_on_the_cpu(cs):
    """Every phase-3 case at the new head sizes, untimed, at a cut S for
    the three long prefills: on CPU tensors each wrapper is its plain
    version, so each reads 0 and the shapes and inputs are exercised."""
    checks = {"flash_attention": cs.check_flash_attention,
              "decode_attention": cs.check_decode_attention,
              "paged_decode_attention": cs.check_paged_decode_attention,
              "paged_verify_attention": cs.check_paged_verify_attention}
    cases = cs.head_dim_cases()
    assert {c["hd"] for cl in cases.values() for c in cl} == set(NEW_DIMS)
    for name, cl in cases.items():
        assert sum(c.get("timed", False) for c in cl) == 3, name
        for c in cl:
            if c.get("S", 0) >= 1024:
                c = dict(c, S=96)
            r = checks[name](cs.case_rng(0, c["name"]), c,
                             torch.device("cpu"), timed=False)
            assert r["max_abs_err"] == 0.0 and r["hd"] == c["hd"]


def _tie(kernel, plain, C=None, R=None):
    """Row 0 differs at its second token: the kernel run picks 2, the
    other 5; logits near 5, where a bf16 step is 1/32."""
    def step(vals):
        out = [torch.zeros(1, 8), torch.zeros(1, 8)]
        out[1][0, 2], out[1][0, 5] = vals
        return out
    control = None if C is None else (step(C), step(R))
    return (torch.tensor([[1, 2]]), step(kernel), torch.tensor([[1, 5]]),
            step(plain), control)


def test_decode_ties_scale_with_the_control(cs):
    """A near tie's scales are TIE_ULPS bf16 steps a logit and twice that
    for the margin, or ZOO20_CONTROL_RATIO times the largest move of the
    same logit or margin between the runs with no kernel (the control's
    and the other run) where that is larger."""
    # the other token's logit 6 steps apart, the margin 7
    tokens, A, other, P, control = _tie((5.0, 4.8125), (4.96875, 5.0),
                                        C=(5.0, 4.78125), R=(5.0, 4.9375))
    ties = cs.decode_ties("t", tokens, A, other, P, 1.0, control=control)
    assert len(ties) == 1 and ties[0]["token"] == 1
    assert (ties[0]["ulps_other_token"], ties[0]["ulps_margin"]) == (6, 7)
    # 1.5 x the 7 steps from P (5.0) to C (4.78125); margins 1, 8 steps
    assert ties[0]["scale_ulps"] == {"kernel_token": 4, "other_token": 10.5,
                                     "margin": 12}
    assert ties[0]["no_kernel_margins"] == [-0.03125, 0.21875, 0.0625]
    with pytest.raises(AssertionError, match="beyond a near tie"):
        cs.decode_ties("t", tokens, A, other, P, 1.0)        # 6 > TIE_ULPS
    _, _, _, _, small = _tie((5.0, 4.8125), (4.96875, 5.0),
                             C=(5.0, 4.96875), R=(5.0, 5.0))
    with pytest.raises(AssertionError, match="beyond a near tie"):
        cs.decode_ties("t", tokens, A, other, P, 1.0, control=small)


def test_decode_ties_hold_the_margin_to_the_controls(cs):
    """Runs with no kernel that move both logits alike widen each logit's
    scale but not the margin's: a margin moved 12 steps is past 2 x
    TIE_ULPS."""
    tokens, A, other, P, control = _tie((5.125, 4.75), (5.0, 5.0),
                                        C=(5.25, 5.25), R=(5.0, 5.0))
    with pytest.raises(AssertionError, match="beyond a near tie") as e:
        cs.decode_ties("t", tokens, A, other, P, 1.0, control=control)
    assert "'ulps_margin': 12.0" in str(e.value)
    assert "'other_token': 12.0" in str(e.value)


def test_replay_limit_follows_the_control(cs):
    assert cs.replay_within("x", 0.0, cs.PATH_RTOL) == (0.0, cs.PATH_RTOL)
    assert cs.replay_within("x", 0.076, 0.0829)[1] == 0.0829
    with pytest.raises(AssertionError, match="beyond"):
        cs.replay_within("x", 0.01, 0.04)
    with pytest.raises(AssertionError, match="beyond"):
        cs.replay_within("x", 0.076, 0.12)


def test_phase20_rehearsed_at_reduced_size(cs, monkeypatch):
    """``zoo20_phase`` on reduced bf16 zamba2-7b (4 layers, a shared block
    every 2) and nemotron-4-340b at hd 112 and 192, with the wrappers
    counting CPU calls: one flash launch an attention invocation and one
    scan launch a Mamba layer a prefill, decode launches steps x
    invocations, every replay and layer reading 0 (the plain versions are
    the path), tokens against ``use_flash_decode=False`` up to near
    ties."""
    from repro_torch.kernels.ssm_scan import ops as sops

    def counting(mod, name, counter):
        fn = getattr(mod, name)

        def counted(*a, **k):
            setattr(mod, counter, getattr(mod, counter) + 1)
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    counting(fops, "flash_attention", "flash_launches")
    counting(ops, "decode_attention", "launches")
    counting(sops, "chunked_scan", "scan_launches")
    red = {}
    for name, hd in (("zamba2-7b", 112), ("nemotron-4-340b", 192)):
        cfg = tconfigs.get_reduced(name).replace(
            param_dtype="bfloat16", act_dtype="bfloat16", head_dim=hd,
            use_flash=True, use_flash_decode=True, use_ssm_kernel=True)
        if cfg.hybrid is not None:
            cfg = cfg.replace(num_layers=4, hybrid=dataclasses.replace(
                cfg.hybrid, attn_every=2))
        red[name] = cfg
    monkeypatch.setattr(cs, "zoo20_config", red.__getitem__)
    monkeypatch.setattr(cs, "ZOO20", {n: tmodels.stack.count_params(c)
                                      for n, c in red.items()})
    monkeypatch.setattr(cs, "ZOO_PROMPT", 32)
    monkeypatch.setattr(cs, "ZOO_DECODE_PROMPT", 8)
    report = cs.zoo20_phase(0, torch.device("cpu"))
    steps = 8 + cs.ZOO14_NEW_TOKENS
    for name, (n_attn, n_mamba) in (("zamba2-7b", (2, 4)),
                                    ("nemotron-4-340b", (2, 0))):
        r = report[name]
        assert (r["attention_invocations"], r["mamba_layers"]) == \
            (n_attn, n_mamba)
        assert r["launches"] == cs._only(flash_attention=n_attn,
                                         ssm_scan=n_mamba)
        assert r["decode"]["launches"] == cs._only(
            decode_attention=steps * n_attn)
        assert r["plain_replay_rel"] == r["decode"]["plain_replay_rel"] == 0
        assert r["layers"]["worst"]["out"] == 0
        assert r["decode"]["layers"]["layers"] == steps * n_attn
        # use_flash_decode=False rounds P to bf16: a row may differ, at a
        # near tie within the control's noise (decode_ties checked it)
        assert len(r["decode"]["ties"]) <= cs.MAX_TIES
