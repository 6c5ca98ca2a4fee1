"""The attention and MoE zoo in the port (``models/{moe,attention,stack,
model,common}.py``, the eight configs beside the two SSM ones), held
against the reference on bridged weights of the reference's own
``init_params`` at the reduced sizes of ``get_reduced``.

The port runs on ``device="cpu"``, where ``use_flash`` /
``use_flash_decode`` take the kernels' plain versions; the reference runs
its Pallas kernels in interpret mode. Inputs come from numpy with a seed.

Tolerances: float32 outputs rtol 1e-4, atol 2e-5 (the reference's
kernel-test tolerance). An MoE layer's output, and with it the residual
stream of the MoE configs (``hidden``), grows to ~1e3 under the
reference's expert init (fan-in over the expert axis), where float32
summation order alone moves elements by ~1e-3: these are held with atol
2e-5 of their largest magnitude. Greedy tokens, routing
(``gate_idx``) and the kept (token, slot) set are exactly equal.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import attention as jattn
from repro.models import common as jc
from repro.models import moe as jmoe
from repro.models import stack as jstack
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.models import attention as tattn
from repro_torch.models import common as tc
from repro_torch.models import moe as tmoe
from repro_torch.models import stack as tstack

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)
B, S, NEW = 2, 12, 4
NEW_IDS = ("nemotron-4-340b", "qwen1.5-32b", "phi4-mini-3.8b",
           "hubert-xlarge", "granite-moe-3b-a800m", "deepseek-v3-671b",
           "minicpm3-4b", "qwen2-vl-2b")
GRANITE = "granite-moe-3b-a800m"


def _port_cfg(jcfg):
    """The port's ModelConfig with the reference config's fields."""
    sub = {"moe": tmodels.MoEConfig, "mla": tmodels.MLAConfig,
           "ssm": tmodels.SSMConfig, "hybrid": tmodels.HybridConfig}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in sub.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return tmodels.ModelConfig(**kw)


def _pair(name, moe=None, **kw):
    """(reference cfg, port cfg) of a reduced config with ``kw`` (and, for
    ``moe``, fields of its MoEConfig) replaced."""
    jcfg = jconfigs.get_reduced(name)
    if moe:
        kw["moe"] = dataclasses.replace(jcfg.moe, **moe)
    jcfg = jcfg.replace(**kw)
    return jcfg, _port_cfg(jcfg)


def _bridge(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), device="cpu")


def _jinit(jcfg):
    return jax.jit(lambda k: jmodels.init_params(jcfg, k))(
        jax.random.PRNGKey(0))


def _np(t):
    return t.detach().numpy()


def _close(want, got, **tol):
    np.testing.assert_allclose(_np(got) if isinstance(got, torch.Tensor)
                               else got, np.asarray(want), **(tol or TOL))


def _close_scaled(want, got):
    """atol 2e-5 of the largest magnitude (see the module docstring)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=2e-5 * scale)


def _batch(cfg, seed=1, batch=B, seq=S):
    """numpy inputs in the model's batch format. The VLM's vision tokens
    sit on a (t=0, h, w) grid and its text tokens after it, so the three
    M-RoPE streams differ."""
    rng = np.random.RandomState(seed)
    if cfg.modality == "audio":
        return {"frames": rng.randn(batch, seq, cfg.frontend_dim).astype(
            np.float32)}
    out = {"tokens": rng.randint(0, cfg.vocab_size, (batch, seq)).astype(
        np.int32)}
    if cfg.modality == "vlm":
        nv = cfg.num_vision_tokens
        side = int(round(nv ** 0.5))
        out["vision_embeds"] = rng.randn(batch, nv, cfg.frontend_dim).astype(
            np.float32)
        pos = np.zeros((3, batch, seq), np.int32)
        i = np.arange(nv)
        pos[1, :, :nv], pos[2, :, :nv] = i // side, i % side
        pos[:, :, nv:] = side + np.arange(seq - nv)
        out["positions"] = pos
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs, parameter counts, the weight bridge
# ---------------------------------------------------------------------------


def test_registry_equals_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for name in jconfigs.ARCH_IDS:
        for get in ("get_config", "get_reduced"):
            got = getattr(tconfigs, get)(name)
            want = getattr(jconfigs, get)(name)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), name


@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_count_params_full_size_equals_reference(name):
    """Total and active parameters at full size: the port's ``init_params``
    on the meta device against the reference's ``jax.eval_shape``."""
    cfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
    for active in (False, True):
        assert tstack.count_params(cfg, active_only=active) \
            == jstack.count_params(jcfg, active_only=active)


@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_bridge_keys_shapes_dtypes_equal_port_init(name):
    """The bridged reference tree (router float32, stacked experts
    (L, E, d, f), MLA's norms, mtp / feat_proj / vision_proj) has the
    keys, shapes and dtypes of the port's own ``init_params``."""
    jcfg = jconfigs.get_reduced(name).replace(mtp=True)
    cfg = _port_cfg(jcfg)
    shapes = jax.eval_shape(lambda: jmodels.init_params(
        jcfg, jax.random.PRNGKey(0)))
    got = bridge.to_torch(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), device="meta")
    want = tmodels.init_params(cfg, torch.Generator(), device="meta")

    def flat(tree, pre=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{pre}/{k}").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in flat(v, f"{pre}/{i}").items()}
        return {pre: (tuple(tree.shape), tree.dtype)}

    assert flat(got) == flat(want)
    if jcfg.moe is not None:
        assert flat(want)["/groups/%d/moe/router" % (
            len(want["groups"]) - 1)][1] == torch.float32


# ---------------------------------------------------------------------------
# models/common.py
# ---------------------------------------------------------------------------


def test_apply_mrope_and_sinusoid_positions():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 7, 3, 64).astype(np.float32)
    pos = rng.randint(0, 300, (3, 2, 7)).astype(np.int32)
    for sections in ((16, 8, 8), (8, 12, 12)):
        _close(jc.apply_mrope(x, pos, sections, 1e6),
               tc.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                              sections, 1e6))
    # one stream for all three: M-RoPE is plain RoPE
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    _close(tc.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e6),
           tc.apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                          (16, 8, 8), 1e6))
    with pytest.raises(ValueError, match="sections"):
        tc.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (8, 8, 8))
    for seq, dim in ((37, 80), (8, 1280)):
        _close(jc.sinusoid_positions(seq, dim),
               tc.sinusoid_positions(seq, dim), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------


def _moe_case(seed, dispatch, batch, cf=0.5):
    """A reduced granite MoE layer with ``capacity_factor`` cf (drops) and
    inputs on which routing concentrates: a shared component plus noise."""
    jcfg, tcfg = _pair(GRANITE, moe=dict(dispatch=dispatch,
                                         capacity_factor=cf))
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)
    x = (rng.randn(batch, 16, jcfg.d_model)
         + 2.0 * rng.randn(1, 1, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, _bridge(jp), x


def _kept(gate_idx, E, C, groups):
    """The reference's kept (token, slot) set: rank within (group,
    expert) below C, from its own ``_positions_in_expert``."""
    flat = np.asarray(gate_idx).reshape(groups, -1)
    return np.stack([np.asarray(jmoe._positions_in_expert(
        jnp.asarray(f))) < C for f in flat])


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter", "grouped"])
def test_moe_mlp_dispatch_with_drops_matches_reference(dispatch, batch):
    """Routing (gate_idx, gate values, aux), the kept set and the output
    in each dispatch mode, with capacity drops forced; grouped with B == 1
    takes the scatter path, as the reference's."""
    jcfg, tcfg, jp, tp, x = _moe_case(11, dispatch, batch)
    m = jcfg.moe
    xt = x.reshape(-1, jcfg.d_model)
    jg, ji, _, jaux = jmoe._router(jp, jcfg, xt)
    tg, ti, _, taux = tmoe._router(tp, tcfg, torch.from_numpy(xt))
    assert np.array_equal(_np(ti), np.asarray(ji))
    _close(jg, tg)
    _close(jaux, taux)
    grouped = dispatch == "grouped" and batch > 1
    groups = batch if grouped else 1
    C = tmoe.capacity(tcfg, 16 if grouped else 16 * batch)
    assert C == jmoe.capacity(jcfg, 16 if grouped else 16 * batch)
    want_keep = _kept(ji, m.num_experts, C, groups)
    _, keep = tmoe._scatter_plan(ti.reshape(groups, -1), m.num_experts, C)
    assert np.array_equal(_np(keep), want_keep)
    assert not want_keep.all(), "the case must drop some (token, slot)"
    want, want_aux = jmoe.moe_mlp(jp, jcfg, x)
    got, got_aux = tmoe.moe_mlp(tp, tcfg, torch.from_numpy(x))
    _close_scaled(want, got)
    _close(want_aux, got_aux)


def test_moe_dispatch_modes_agree_and_shared_experts():
    """einsum and scatter drop the same set and give the same output; the
    shared experts (deepseek) add one dense FFN of every token."""
    outs = [tmoe.moe_mlp(tp, tcfg, torch.from_numpy(x))[0]
            for _, tcfg, _, tp, x in (_moe_case(12, d, 2) for d in
                                      ("einsum", "scatter"))]
    _close_scaled(_np(outs[0]), outs[1])
    jcfg, tcfg = _pair("deepseek-v3-671b", moe=dict(capacity_factor=0.5))
    assert jcfg.moe.num_shared_experts
    jp = jmoe.init_moe(jax.random.PRNGKey(13), jcfg)
    x = np.random.RandomState(13).randn(2, 5, jcfg.d_model).astype(
        np.float32)
    want, _ = jmoe.moe_mlp(jp, jcfg, x)
    got, _ = tmoe.moe_mlp(_bridge(jp), tcfg, torch.from_numpy(x))
    _close_scaled(want, got)


def test_router_ties_go_to_the_lower_expert_and_decode_capacity():
    """Equal probabilities (a zero router): top-k takes the lowest expert
    indices, as ``jax.lax.top_k``; at decode (T = B) capacity is 4."""
    jcfg, tcfg, jp, tp, x = _moe_case(14, "scatter", 2)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    xt = x.reshape(-1, jcfg.d_model)
    _, ji, _, _ = jmoe._router(jp, jcfg, xt)
    _, ti, _, _ = tmoe._router(tp, tcfg, torch.from_numpy(xt))
    assert np.array_equal(_np(ti), np.asarray(ji))
    assert (_np(ti) == np.arange(jcfg.moe.top_k)).all()
    _close_scaled(jmoe.moe_mlp(jp, jcfg, x)[0],
                  tmoe.moe_mlp(tp, tcfg, torch.from_numpy(x))[0])
    assert tmoe.capacity(tcfg, 2) == jmoe.capacity(jcfg, 2) == 4


# ---------------------------------------------------------------------------
# models/attention.py: MLA, query chunking, the scores stub, shard_cache_hd
# ---------------------------------------------------------------------------


def _mla_layer(name="minicpm3-4b", **kw):
    jcfg, tcfg = _pair(name, **kw)
    jp = jattn.init_mla(jax.random.PRNGKey(21), jcfg)
    return jcfg, tcfg, jp, _bridge(jp)


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("name", ["minicpm3-4b", "deepseek-v3-671b"])
def test_mla_full_matches_reference(name, chunk):
    jcfg, tcfg, jp, tp = _mla_layer(name, attn_chunk=chunk)
    x = np.random.RandomState(22).randn(B, S, jcfg.d_model).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    mask = np.array(jc.causal_mask(S))[None]
    jo, jkv = jattn.mla_full(jp, jcfg, x, pos, mask)
    to, tkv = tattn.mla_full(tp, tcfg, torch.from_numpy(x),
                             torch.from_numpy(pos), torch.from_numpy(mask))
    _close(jo, to)
    for k in ("ckv", "krope"):
        _close(jkv[k], tkv[k])
    if chunk:
        plain, _ = tattn.mla_full(tp, tcfg.replace(attn_chunk=0),
                                  torch.from_numpy(x), torch.from_numpy(pos),
                                  torch.from_numpy(mask))
        _close(_np(plain), to)


def test_mla_decode_matches_reference_and_mla_full():
    """The absorbed decode against the reference's on a random latent cache,
    updated in place; and fed a prompt token by token, row t of its output
    against ``mla_full``'s row t."""
    jcfg, tcfg, jp, tp = _mla_layer()
    rng = np.random.RandomState(23)
    W = 9
    cache = {"ckv": rng.randn(B, W, jcfg.mla.kv_lora_rank),
             "krope": rng.randn(B, W, jcfg.mla.qk_rope_head_dim)}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    x = rng.randn(B, 1, jcfg.d_model).astype(np.float32)
    pos_arr = np.full((B, W), -1, np.int32)
    pos_arr[:, :6] = np.arange(6)
    mask = np.array(jc.cache_mask(pos_arr, 5))
    positions = np.full((B, 1), 5, np.int32)
    jo, jcache = jattn.mla_decode(jp, jcfg, x, positions, cache, 5, mask)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ckv = tcache["ckv"]
    to, tcache2 = tattn.attn_decode(tp, tcfg, torch.from_numpy(x),
                                    torch.from_numpy(positions), tcache, 5,
                                    torch.from_numpy(mask))
    assert tcache2["ckv"] is ckv
    _close(jo, to)
    for k in ("ckv", "krope"):
        _close(jcache[k], tcache2[k])
    with pytest.raises(NotImplementedError, match="per-row"):
        tattn.attn_decode(tp, tcfg, torch.from_numpy(x),
                          torch.from_numpy(positions), tcache,
                          torch.zeros(B, dtype=torch.long),
                          torch.from_numpy(mask))
    with pytest.raises(NotImplementedError, match="GQA cache layout"):
        tattn.attn_decode_paged(tp, tcfg, *[None] * 8)

    xs = rng.randn(B, S, jcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    full, _ = tattn.mla_full(tp, tcfg, torch.from_numpy(xs),
                             torch.from_numpy(pos),
                             tc.causal_mask(S)[None])
    cache = tattn.mla_empty_cache(tcfg, B, S, "cpu")
    for t in range(S):
        cpos = torch.full((B, S), -1, dtype=torch.int32)
        cpos[:, :t + 1] = torch.arange(t + 1)
        out, _ = tattn.mla_decode(
            tp, tcfg, torch.from_numpy(xs[:, t:t + 1]),
            torch.full((B, 1), t, dtype=torch.int32), cache, t,
            tc.cache_mask(cpos, t))
        _close(_np(full[:, t]), out[:, 0], rtol=1e-4, atol=1e-4)


def _gqa_layer(name, **kw):
    jcfg, tcfg = _pair(name, **kw)
    jp = jattn.init_gqa(jax.random.PRNGKey(31), jcfg)
    return jcfg, tcfg, jp, _bridge(jp)


@pytest.mark.parametrize("kw", [dict(attn_chunk=4), dict(attn_chunk=5),
                                dict(attn_scores_stub=True),
                                dict(attn_scores_stub=True, use_flash=True),
                                dict(attn_chunk=4, use_flash=True)],
                         ids=["chunk4", "chunk5_unsplit", "stub",
                              "stub_before_flash", "flash_before_chunk"])
def test_gqa_full_switches_match_reference(kw):
    """``attn_chunk`` (only where S splits into chunks), the scores stub
    and the reference's order of branches (stub, flash, chunk, SDPA)."""
    jcfg, tcfg, jp, tp = _gqa_layer("qwen1.5-32b", **kw)
    x = np.random.RandomState(32).randn(B, S, jcfg.d_model).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    mask = np.array(jc.causal_mask(S))[None]
    jo, _ = jattn.gqa_full(jp, jcfg, x, pos, mask)
    to, _ = tattn.gqa_full(tp, tcfg, torch.from_numpy(x),
                           torch.from_numpy(pos), torch.from_numpy(mask))
    _close(jo, to)


def test_shard_cache_hd_without_a_mesh():
    """On one device ``shard_cache_hd`` changes no value and keeps
    contiguous decode off the kernel; the paged paths refuse it, as the
    reference's do."""
    jcfg, tcfg = _pair("phi4-mini-3.8b", use_flash_decode=True,
                       shard_cache_hd=True)
    jp = _jinit(jcfg)
    tp = _bridge(jp)
    tok = np.random.RandomState(33).randint(0, jcfg.vocab_size, (B, 1))
    tok = tok.astype(np.int32)
    jl, _ = jmodels.decode_step(jp, jcfg, jmodels.init_cache(jcfg, B, 8),
                                jnp.asarray(tok), jnp.int32(0))
    calls = []
    with mock.patch.object(dops, "decode_attention",
                           lambda *a: calls.append(1)):
        tl, _ = tmodels.decode_step(tp, tcfg, tmodels.init_cache(
            tcfg, B, 8, "cpu"), torch.from_numpy(tok), 0)
    assert not calls
    _close(jl, tl)
    plain, _ = tmodels.decode_step(tp, tcfg.replace(shard_cache_hd=False),
                                   tmodels.init_cache(tcfg, B, 8, "cpu"),
                                   torch.from_numpy(tok), 0)
    assert torch.equal(plain, tl)
    for fn, what in ((tattn.gqa_decode_paged, "paged decode"),
                     (tattn.gqa_verify_paged, "paged verify")):
        with pytest.raises(NotImplementedError, match=what):
            fn(None, tcfg, *[None] * 8)


# ---------------------------------------------------------------------------
# models/model.py: forward, prefill_step, decode_step for each new config
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=NEW_IDS)
def model(request):
    """(reference cfg, port cfg, reference params, bridged params)."""
    jcfg, tcfg = _pair(request.param)
    jp = _jinit(jcfg)
    return jcfg, tcfg, jp, _bridge(jp)


def test_forward_and_prefill_match_reference(model):
    jcfg, tcfg, jp, tp = model
    batch = _batch(jcfg)
    jlogits, jaux, _, jhidden = jax.jit(
        lambda p, b: jmodels.forward(p, jcfg, b))(jp, batch)
    logits, aux, _, hidden = tmodels.forward(tp, tcfg, _t(batch))
    _close(jlogits, logits)
    _close(jaux, torch.as_tensor(aux))
    _close_scaled(jhidden, hidden)
    assert (float(aux) > 0) == (jcfg.moe is not None)
    jlast, jcache = jax.jit(lambda p, b: jmodels.prefill_step(
        p, jcfg, b))(jp, batch)
    last, cache = tmodels.prefill_step(tp, tcfg, _t(batch))
    _close(jlast, last)
    if jcfg.modality == "audio":        # every position, no cache
        assert jcache is None and cache is None
        assert tuple(last.shape) == (B, S, jcfg.vocab_size)
        with pytest.raises(ValueError, match="encoder-only"):
            tmodels.decode_step(tp, tcfg, None, None, 0)
        return
    assert np.array_equal(_np(cache["positions"]),
                          np.asarray(jcache["positions"]))
    for g, jg in zip(cache["groups"], jcache["groups"]):
        assert sorted(g) == sorted(jg)
        for k in g:
            _close(jg[k], g[k], rtol=1e-4, atol=1e-4)


def _greedy(step, init, tokens):
    """The prompt through ``step`` from ``init()``, then NEW greedy tokens;
    returns (logits (B, S+NEW, V), tokens (B, NEW)) as numpy."""
    cache = init()
    logits, toks = [], []
    for t in range(S + NEW):
        tk = tokens[:, t:t + 1] if t < S else toks[-1]
        lg, cache = step(cache, tk, t)
        lg = np.asarray(lg if not isinstance(lg, torch.Tensor) else _np(lg))
        logits.append(lg[:, 0])
        if t >= S - 1:
            toks.append(np.argmax(lg[:, -1], -1)[:, None].astype(np.int32))
    return np.stack(logits, 1), np.concatenate(toks[:NEW], 1)


def test_greedy_decode_matches_reference(model):
    """Tokens exactly equal, decode logits within 1e-4 (MLA's absorbed
    decode, M-RoPE's broadcast position, the MoE group at T = B)."""
    jcfg, tcfg, jp, tp = model
    if not jcfg.supports_decode:        # encoder-only: both refuse
        with pytest.raises(AssertionError, match="encoder-only"):
            jmodels.decode_step(jp, jcfg, None, None, 0)
        with pytest.raises(ValueError, match="encoder-only"):
            tmodels.decode_step(tp, tcfg, None, None, 0)
        return
    tokens = _batch(jcfg, seed=3)["tokens"]
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


@pytest.mark.parametrize("name", ["nemotron-4-340b", "qwen1.5-32b"])
def test_sliding_window_variant(name):
    """The sliding-window variant: forward, and ring-buffer decode at
    position 1000 with a cache of the window's 8 slots."""
    jcfg, tcfg = _pair(name, sliding_window=8)
    jp = _jinit(jcfg)
    tp = _bridge(jp)
    batch = _batch(jcfg, seq=16)
    jl, *_ = jmodels.forward(jp, jcfg, batch)
    tl, *_ = tmodels.forward(tp, tcfg, _t(batch))
    _close(jl, tl)
    tok = np.zeros((B, 1), np.int32)
    jl, _ = jmodels.decode_step(jp, jcfg, jmodels.init_cache(jcfg, B, 8),
                                jnp.asarray(tok), jnp.int32(1000))
    tl, _ = tmodels.decode_step(tp, tcfg, tmodels.init_cache(tcfg, B, 8,
                                                             "cpu"),
                                torch.from_numpy(tok), 1000)
    _close(jl, tl)
    assert np.isfinite(_np(tl)).all()


@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa2"])
def test_granite_kernel_switches_match_reference_kernels(kv):
    """``use_flash`` and ``use_flash_decode`` on a reduced granite (and with
    2 kv heads, G = 2): the port's plain versions (the CPU path of the
    kernel wrappers) against the reference's Pallas kernels in interpret
    mode; prefill logits and greedy tokens."""
    jcfg, tcfg = _pair(GRANITE, num_kv_heads=kv, use_flash=True,
                       use_flash_decode=True)
    jp = _jinit(jcfg)
    tp = _bridge(jp)
    batch = _batch(jcfg, seed=4)
    jlast, _ = jmodels.prefill_step(jp, jcfg, batch)
    last, _ = tmodels.prefill_step(tp, tcfg, _t(batch))
    _close(jlast, last)
    tokens = batch["tokens"]
    dec = jax.jit(lambda p, c, t, pos: jmodels.decode_step(p, jcfg, c, t,
                                                           pos))
    _, want = _greedy(
        lambda c, t, pos: dec(jp, c, jnp.asarray(t), jnp.int32(pos)),
        lambda: jmodels.init_cache(jcfg, B, S + NEW), tokens)
    _, got = _greedy(
        lambda c, t, pos: tmodels.decode_step(
            tp, tcfg, c, torch.from_numpy(np.asarray(t)), pos),
        lambda: tmodels.init_cache(tcfg, B, S + NEW, "cpu"), tokens)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# models/stack.py: the MoE group against the page pool
# ---------------------------------------------------------------------------

PAGE, N_PAGES, POOL_PAGES, C_VERIFY = 4, 5, 9, 3


def _pool_case(jcfg, seed):
    """A shared pool (L, P, page, K, hd) and page tables: rows 0 and 1
    share their first page, row 2 idle on the trash page 0; each row's
    verify chunk of C_VERIFY entries (row 1 one real and two pad entries,
    which target the trash page)."""
    rng = np.random.RandomState(seed)
    L = jcfg.num_layers
    shape = (L, POOL_PAGES, PAGE, jcfg.num_kv_heads, jcfg.resolved_head_dim)
    pool = {k: rng.randn(*shape).astype(np.float32) for k in ("k", "v")}
    table = np.array([[1, 2, 3, 4, 0], [1, 5, 6, 0, 0], [0] * 5], np.int32)
    cpos = np.full((3, N_PAGES * PAGE), -1, np.int32)
    cpos[0, :9], cpos[1, :6] = np.arange(9), np.arange(6)
    pos = np.array([9, 6, 0], np.int32)
    chunk = np.array([C_VERIFY, 1, 1])
    offs = np.arange(C_VERIFY)[None]
    valid = offs < chunk[:, None]
    pos_c = (pos[:, None] + offs).astype(np.int32)
    ws = np.where(valid, pos[:, None] + offs, 0)
    pos_arr = cpos.copy()
    for b, c in zip(*np.nonzero(valid)):
        pos_arr[b, ws[b, c]] = pos_c[b, c]
    pos_arr[2] = -1
    mask = np.array(jc.cache_mask(pos_arr[:, None, :], pos_c[:, :, None]))
    rows = np.arange(3)[:, None]
    write_page = np.where(valid, table[rows, ws // PAGE], 0).astype(np.int32)
    write_off = np.where(valid, ws % PAGE, 0).astype(np.int32)
    x = rng.randn(3, C_VERIFY, jcfg.d_model).astype(np.float32)
    return pool, table, pos_c, mask, write_page, write_off, x, chunk


@pytest.mark.parametrize("verify", [False, True], ids=["decode", "verify"])
def test_moe_group_paged_matches_reference(verify):
    """The MoE group (granite, both layers) through ``group_decode_paged``
    (the first entry of each row) and ``group_verify_paged`` (the chunk),
    with the decode kernel's plain version; live rows and every pool page
    but the trash page."""
    jcfg, tcfg = _pair(GRANITE, use_flash_decode=True)
    jp = _jinit(jcfg)
    tp = _bridge(jp)
    pool, table, pos_c, mask, wp, wo, x, chunk = _pool_case(jcfg, 41)
    spec_j, spec_t = jstack.layer_groups(jcfg)[0], tstack.layer_groups(
        tcfg)[0]
    assert spec_t.kind == "moe"
    if verify:
        fns = jstack.group_verify_paged, tstack.group_verify_paged
        args = (x, pos_c, table, wp, wo, mask)
    else:
        fns = jstack.group_decode_paged, tstack.group_decode_paged
        args = (x[:, :1], pos_c[:, :1], table, wp[:, 0], wo[:, 0],
                mask[:, 0])
    xx, positions, table, wp, wo, mask = args
    jx, jpool = fns[0](jp["groups"][0], jcfg, spec_j, xx, positions,
                       {k: jnp.asarray(v) for k, v in pool.items()},
                       table, wp, wo, mask)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    tx, tpool2 = fns[1](tp["groups"][0], tcfg, spec_t, torch.from_numpy(xx),
                        torch.from_numpy(positions), tpool,
                        torch.from_numpy(table), torch.from_numpy(wp).long(),
                        torch.from_numpy(wo).long(), torch.from_numpy(mask))
    assert tpool2["k"] is tpool["k"]
    for r in (0, 1):
        n = chunk[r] if verify else 1
        _close_scaled(np.asarray(jx)[r, :n], tx[r, :n])
    for k in ("k", "v"):
        _close(np.asarray(jpool[k])[:, 1:], tpool2[k][:, 1:])
