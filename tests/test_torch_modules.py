"""Module parity: each ported module against its reference counterpart on
bridged weights (lisa_mini, ``random_init_system`` seed 0), with the same
numpy inputs handed to both packages.

Tolerance: fp32 rtol 1e-4, atol 1e-4 — the only difference is summation
order, which compounds through the layers. Bottleneck codes may differ by
+-1 on fewer than 1e-3 of entries, where a sum lands on .5 and round()
flips with accumulation order (as tests/test_kernels.py allows).
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lisa7b import CONFIG as J7B
from repro.configs.lisa_mini import CONFIG as JP
from repro.configs.lisa_nano import CONFIG as JNANO
from repro.core import bottleneck as jbn
from repro.core import intent as jintent
from repro.core import lut as jlut
from repro.core import packets as jpk
from repro.core import vlm as jv
from repro.core.profile import random_init_system
from repro.models import attention as jattn
from repro.models import common as jc
from repro.models import stack as jstack
from repro_torch import bridge
from repro_torch.configs import get_lisa_config
from repro_torch.core import bottleneck as tbn
from repro_torch.core import intent as tintent
from repro_torch.core import lut as tlut
from repro_torch.core import packets as tpk
from repro_torch.core import vlm as tv
from repro_torch.models import attention as tattn
from repro_torch.models import common as tc
from repro_torch.models import stack as tstack

torch.set_num_threads(1)

TP = get_lisa_config("lisa-mini")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def system():
    params, bns, _ = random_init_system(JP, seed=0)
    np_params = jax.tree.map(np.asarray, params)
    np_bns = jax.tree.map(np.asarray, bns)
    return (params, bridge.to_torch(np_params, "cpu"), bns,
            bridge.to_torch(np_bns, "cpu"))


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy()
                               if isinstance(b, torch.Tensor) else b,
                               **(tol or TOL))


def _rng(seed=0):
    return np.random.RandomState(seed)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _tlayer(tree, i):
    return tstack.layer_slice(tree, i)


# ---------------------------------------------------------------------------
# configs and host copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["lisa-7b", "lisa-mini", "lisa-nano"])
def test_configs_match_field_for_field(name):
    ref = {"lisa-7b": J7B, "lisa-mini": JP, "lisa-nano": JNANO}[name]
    port = get_lisa_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.sam_tokens, port.clip_tokens) == (ref.sam_tokens,
                                                    ref.clip_tokens)
    for sub in ("sam", "clip", "llm"):
        pc, rc = getattr(port, sub), getattr(ref, sub)
        assert pc.resolved_head_dim == rc.resolved_head_dim
        assert str(pc.pdtype).replace("torch.", "") == str(rc.pdtype)
        assert str(pc.adtype).replace("torch.", "") == str(rc.adtype)


def test_host_copies_match():
    assert dataclasses.asdict(tlut.paper_lut()) == \
        dataclasses.asdict(jlut.paper_lut())
    for prompt in ("Highlight the stranded person", "Is there any car?",
                   "how many boats", "status", "outline the roof"):
        assert tintent.classify_intent(prompt).value == \
            jintent.classify_intent(prompt).value
    assert tpk.insight_payload_bytes(4096, 638, 196, 768) == \
        jpk.insight_payload_bytes(4096, 638, 196, 768)
    assert tpk.context_payload_bytes(196, 4096) == \
        jpk.context_payload_bytes(196, 4096)
    for ratio in (0.25, 0.10, 0.05):
        for nbytes in (2, 4):
            assert tbn.rank_for_ratio(1280, ratio, nbytes) == \
                jbn.rank_for_ratio(1280, ratio, nbytes)
    spec_t, spec_j = tbn.BottleneckSpec(128, 62, 4), jbn.BottleneckSpec(
        128, 62, 4)
    assert spec_t.ratio == spec_j.ratio
    assert tbn.payload_bytes(spec_t, 64) == jbn.payload_bytes(spec_j, 64)


# ---------------------------------------------------------------------------
# bridge and init
# ---------------------------------------------------------------------------


def test_bridge_round_trip_keeps_structure_shape_dtype(system):
    params, tparams, _, _ = system
    jl, jdef = jax.tree.flatten(params)
    tl = jax.tree.leaves(tparams)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, tparams)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, params)) == jdef
    for a, t in zip(jl, tl):
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).replace("torch.", "") == str(a.dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_bridge_reads_checkpoint_directory(tmp_path):
    from repro.checkpoint.store import save_pytree
    tree = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
            "b": [jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16),
                  jnp.asarray([[1, -2]], jnp.int8)],
            "c": {"d": jnp.asarray([7], jnp.int32)}}
    save_pytree(str(tmp_path), tree)
    got = bridge.load_checkpoint(str(tmp_path), "cpu")
    assert got["b"][0].dtype == torch.bfloat16
    assert got["b"][1].dtype == torch.int8
    for a, t in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      t.float().numpy())


def test_init_lisa_mirrors_reference_layout():
    gen = torch.Generator().manual_seed(0)
    tparams = tv.init_lisa(TP, gen, "cpu")
    jparams = jax.eval_shape(lambda: jv.init_lisa(JP, jax.random.PRNGKey(0)))
    jl, jdef = jax.tree.flatten(jparams)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, tparams)) == jdef
    for a, t in zip(jl, jax.tree.leaves(tparams)):
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).replace("torch.", "") == str(a.dtype)
    # fan-in scaled normal weights, zero biases, unit norms
    w = tparams["llm"]["groups"][0]["attn"]["wq"]
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.05
    assert float(tparams["sam"]["patch_b"].abs().max()) == 0.0
    assert float(tparams["llm"]["norm"]["w"].min()) == 1.0


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["rms_norm", "layer_norm", "gelu", "rope",
                                "causal_mask", "cache_mask"])
def test_common(fn):
    rng = _rng(1)
    x = rng.randn(2, 5, 4, 32).astype(np.float32) * 3
    w = rng.randn(32).astype(np.float32)
    b = rng.randn(32).astype(np.float32)
    tx = torch.from_numpy(x)
    if fn == "rms_norm":
        _close(jc.rms_norm(x, w), tc.rms_norm(tx, torch.from_numpy(w)))
    elif fn == "layer_norm":
        _close(jc.layer_norm(x, w, b),
               tc.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b)))
    elif fn == "gelu":
        _close(jc.gelu(x), tc.gelu(tx))
    elif fn == "rope":
        pos = rng.randint(0, 300, (2, 5)).astype(np.int32)
        _close(jc.apply_rope(x, pos), tc.apply_rope(tx, torch.from_numpy(pos)))
    elif fn == "causal_mask":
        np.testing.assert_array_equal(np.asarray(jc.causal_mask(7)),
                                      tc.causal_mask(7).numpy())
        np.testing.assert_array_equal(np.asarray(jc.causal_mask(7, 3)),
                                      tc.causal_mask(7, 3).numpy())
    else:
        cp = np.array([[0, 1, 2, -1, -1], [3, 4, 0, 1, 2]], np.int32)
        tcp = torch.from_numpy(cp)
        np.testing.assert_array_equal(np.asarray(jc.cache_mask(cp, 2)),
                                      tc.cache_mask(tcp, 2).numpy())
        per_row = np.array([[1], [3]], np.int32)
        np.testing.assert_array_equal(
            np.asarray(jc.cache_mask(cp, per_row, 2)),
            tc.cache_mask(tcp, torch.from_numpy(per_row), 2).numpy())


# ---------------------------------------------------------------------------
# attention and stack
# ---------------------------------------------------------------------------


def _llm_x(seed, S):
    return _rng(seed).randn(2, S, TP.llm.d_model).astype(np.float32)


def test_gqa_full(system):
    params, tparams, _, _ = system
    jp = _layer(params["llm"]["groups"][0]["attn"], 0)
    tp = _tlayer(tparams["llm"]["groups"][0]["attn"], 0)
    S = 9
    x = _llm_x(2, S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    jo, jkv = jattn.gqa_full(jp, JP.llm, x, pos, jc.causal_mask(S)[None])
    to, tkv = tattn.gqa_full(tp, TP.llm, torch.from_numpy(x),
                             torch.from_numpy(pos), tc.causal_mask(S)[None])
    _close(jo, to)
    _close(jkv["k"], tkv["k"])
    _close(jkv["v"], tkv["v"])


def test_gqa_full_use_flash_ignores_mask(system):
    """use_flash routes the causal pass through the flash kernel (its plain
    version on CPU tensors), which builds the causal mask itself: a mask
    that is not causal, passed in, is ignored by both packages alike."""
    params, tparams, _, _ = system
    jp = _layer(params["llm"]["groups"][0]["attn"], 1)
    tp = _tlayer(tparams["llm"]["groups"][0]["attn"], 1)
    S = 11
    x = _llm_x(40, S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    mask = np.zeros((1, S, S), np.float32)
    jcfg, tcfg = JP.llm.replace(use_flash=True), TP.llm.replace(use_flash=True)
    jo, jkv = jattn.gqa_full(jp, jcfg, x, pos, jnp.asarray(mask))
    to, tkv = tattn.gqa_full(tp, tcfg, torch.from_numpy(x),
                             torch.from_numpy(pos), torch.from_numpy(mask))
    _close(jo, to)
    _close(jkv["k"], tkv["k"])
    causal, _ = tattn.gqa_full(tp, TP.llm, torch.from_numpy(x),
                               torch.from_numpy(pos), tc.causal_mask(S)[None])
    _close(causal, to)


def test_gqa_full_unported_switches_raise_where_reached(system):
    """The reference's order of branches: the scores stub, then flash, then
    query chunking (only where S splits into chunks), then SDPA."""
    _, tparams, _, _ = system
    tp = _tlayer(tparams["llm"]["groups"][0]["attn"], 0)
    S = 8
    x = torch.from_numpy(_llm_x(41, S))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(2, S)
    mask = tc.causal_mask(S)[None]
    plain, _ = tattn.gqa_full(tp, TP.llm, x, pos, mask)
    with pytest.raises(NotImplementedError, match="attn_scores_stub"):
        tattn.gqa_full(tp, TP.llm.replace(attn_scores_stub=True,
                                          use_flash=True), x, pos, mask)
    with pytest.raises(NotImplementedError, match="attn_chunk"):
        tattn.gqa_full(tp, TP.llm.replace(attn_chunk=4), x, pos, mask)
    flash, _ = tattn.gqa_full(tp, TP.llm.replace(attn_chunk=4,
                                                 use_flash=True),
                              x, pos, mask)
    _close(plain.numpy(), flash)
    unchunked, _ = tattn.gqa_full(tp, TP.llm.replace(attn_chunk=3), x, pos,
                                  mask)
    assert torch.equal(unchunked, plain)


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("per_row", [False, True])
def test_gqa_decode(system, flash, per_row):
    params, tparams, _, _ = system
    jp = _layer(params["llm"]["groups"][0]["attn"], 0)
    tp = _tlayer(tparams["llm"]["groups"][0]["attn"], 0)
    rng = _rng(3)
    B, W, K, hd = 2, 12, TP.llm.num_kv_heads, TP.llm.resolved_head_dim
    k = rng.randn(B, W, K, hd).astype(np.float32)
    v = rng.randn(B, W, K, hd).astype(np.float32)
    x = _llm_x(4, 1)
    if per_row:
        pos = np.array([7, 10], np.int32)
        slot_j, slot_t = pos % W, torch.from_numpy(pos % W)
        cp = np.where(np.arange(W)[None] <= pos[:, None], np.arange(W)[None],
                      -1).astype(np.int32)
        mask = np.array(jc.cache_mask(cp, pos[:, None]))
        positions = pos[:, None]
    else:
        pos = 8
        slot_j, slot_t = pos, pos
        cp = np.where(np.arange(W) <= pos, np.arange(W), -1).astype(np.int32)
        cp = np.broadcast_to(cp, (B, W)).copy()
        mask = np.array(jc.cache_mask(cp, pos))
        positions = np.full((B, 1), pos, np.int32)
    jcfg = JP.llm.replace(use_flash_decode=flash)
    tcfg = TP.llm.replace(use_flash_decode=flash)
    jo, jcache = jattn.gqa_decode(jp, jcfg, x, positions,
                                  {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                  jnp.asarray(slot_j), jnp.asarray(mask))
    tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    to, tcache2 = tattn.gqa_decode(tp, tcfg, torch.from_numpy(x),
                                   torch.from_numpy(positions), tcache, slot_t,
                                   torch.from_numpy(mask))
    _close(jo, to)
    _close(jcache["k"], tcache2["k"])
    _close(jcache["v"], tcache2["v"])


def test_group_forward_dense_with_cache(system):
    params, tparams, _, _ = system
    S = 10
    x = _llm_x(5, S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    spec_j, spec_t = jstack.layer_groups(JP.llm)[0], tstack.layer_groups(
        TP.llm)[0]
    jx, _, jkv = jstack.group_forward(params["llm"]["groups"][0], JP.llm,
                                      spec_j, x, pos, jc.causal_mask(S)[None],
                                      want_cache=True)
    tx, _, tkv = tstack.group_forward(tparams["llm"]["groups"][0], TP.llm,
                                      spec_t, torch.from_numpy(x),
                                      torch.from_numpy(pos),
                                      tc.causal_mask(S)[None],
                                      want_cache=True)
    _close(jx, tx)
    _close(jkv["k"], tkv["k"])
    _close(jkv["v"], tkv["v"])


def test_group_decode_dense(system):
    params, tparams, _, _ = system
    L, B, W = TP.llm.num_layers, 2, 12
    K, hd = TP.llm.num_kv_heads, TP.llm.resolved_head_dim
    rng = _rng(6)
    k = rng.randn(L, B, W, K, hd).astype(np.float32)
    v = rng.randn(L, B, W, K, hd).astype(np.float32)
    pos = 9
    cp = np.broadcast_to(np.where(np.arange(W) <= pos, np.arange(W), -1),
                         (B, W)).astype(np.int32)
    mask = np.array(jc.cache_mask(cp, pos))
    x = _llm_x(7, 1)
    positions = np.full((B, 1), pos, np.int32)
    spec_j, spec_t = jstack.layer_groups(JP.llm)[0], tstack.layer_groups(
        TP.llm)[0]
    jx, jcache = jstack.group_decode(params["llm"]["groups"][0], JP.llm,
                                     spec_j, x, positions,
                                     {"k": jnp.asarray(k),
                                      "v": jnp.asarray(v)},
                                     jnp.int32(pos), jnp.asarray(mask))
    tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    tx, tcache = tstack.group_decode(tparams["llm"]["groups"][0], TP.llm,
                                     spec_t, torch.from_numpy(x),
                                     torch.from_numpy(positions), tcache,
                                     pos, torch.from_numpy(mask))
    _close(jx, tx)
    _close(jcache["k"], tcache["k"])
    _close(jcache["v"], tcache["v"])


# ---------------------------------------------------------------------------
# vlm
# ---------------------------------------------------------------------------


def _ctx_query(seed, B=2, qlen=6):
    rng = _rng(seed)
    ctx = rng.randn(B, JP.clip_tokens, JP.llm.d_model).astype(np.float32)
    query = rng.randint(0, JP.llm.vocab_size, (B, qlen)).astype(np.int32)
    return ctx, query


def test_llm_prefill(system):
    params, tparams, _, _ = system
    ctx, query = _ctx_query(8)
    W = ctx.shape[1] + query.shape[1] + 3
    jl, js, jcache = jv.llm_prefill(params, JP, ctx, query, width=W)
    tl, ts, tcache = tv.llm_prefill(tparams, TP, torch.from_numpy(ctx),
                                    torch.from_numpy(query), width=W)
    _close(jl, tl)
    _close(js, ts)
    _close(jcache["groups"][0]["k"], tcache["groups"][0]["k"])
    _close(jcache["groups"][0]["v"], tcache["groups"][0]["v"])
    np.testing.assert_array_equal(np.asarray(jcache["positions"]),
                                  tcache["positions"].numpy())


@pytest.mark.parametrize("per_row", [False, True])
def test_llm_decode_step(system, per_row):
    params, tparams, _, _ = system
    ctx, query = _ctx_query(9)
    S = ctx.shape[1] + query.shape[1]
    W = S + 4
    jcfg = dataclasses.replace(JP, llm=JP.llm.replace(use_flash_decode=True))
    tcfg = dataclasses.replace(TP, llm=TP.llm.replace(use_flash_decode=True))
    _, _, jcache = jv.llm_prefill(params, jcfg, ctx, query, width=W)
    _, _, tcache = tv.llm_prefill(tparams, tcfg, torch.from_numpy(ctx),
                                  torch.from_numpy(query), width=W)
    tok = np.array([[3], [17]], np.int32)
    if per_row:
        pos_j = np.array([S, S + 2], np.int32)
        pos_t = torch.from_numpy(pos_j)
    else:
        pos_j, pos_t = jnp.int32(S), S
    jl, js, jc2 = jv.llm_decode_step(params, jcfg, jcache, tok, pos_j)
    tl, ts, tc2 = tv.llm_decode_step(tparams, tcfg, tcache,
                                     torch.from_numpy(tok), pos_t)
    _close(jl, tl)
    _close(js, ts)
    _close(jc2["groups"][0]["k"], tc2["groups"][0]["k"])
    np.testing.assert_array_equal(np.asarray(jc2["positions"]),
                                  tc2["positions"].numpy())


def test_mask_decode(system):
    params, tparams, _, _ = system
    rng = _rng(10)
    feats = rng.randn(2, JP.sam_tokens, JP.sam.d_model).astype(np.float32)
    seg = rng.randn(2, JP.sam.d_model).astype(np.float32)
    _close(jv.mask_decode(params, JP, feats, seg),
           tv.mask_decode(tparams, TP, torch.from_numpy(feats),
                          torch.from_numpy(seg)))


@pytest.mark.parametrize("stage", ["sam_head", "sam_tail", "clip_encode_32",
                                   "clip_encode_64"])
def test_encoders(system, stage):
    """clip_encode fed 64x64 images runs the antialiased downsizing resize
    (lisa_mini's context size is 32)."""
    params, tparams, _, _ = system
    rng = _rng(11)
    if stage == "sam_tail":
        x = rng.randn(2, JP.sam_tokens, JP.sam.d_model).astype(np.float32)
        _close(jv.sam_tail(params, JP, x),
               tv.sam_tail(tparams, TP, torch.from_numpy(x)))
        return
    size = 64 if stage == "clip_encode_64" else 32
    img = rng.rand(2, size, size, 3).astype(np.float32)
    fn_j, fn_t = ((jv.sam_head, tv.sam_head) if stage == "sam_head"
                  else (jv.clip_encode, tv.clip_encode))
    _close(fn_j(params, JP, img), fn_t(tparams, TP, torch.from_numpy(img)))


# ---------------------------------------------------------------------------
# the paged in-flight path: one bridged page pool for both packages
# ---------------------------------------------------------------------------

PAGE, N_PAGES, POOL_PAGES = 4, 6, 11


def _paged_case(seed, B=3):
    """A shared pool (L, P, page, K, hd), per-row page tables over it (rows
    0 and 1 share their first two pages; the last row is idle, parked on
    the trash page 0), slot positions with a padded prefix tail, and the
    step's tokens, positions and write slots."""
    llm = TP.llm
    rng = _rng(seed)
    shape = (llm.num_layers, POOL_PAGES, PAGE, llm.num_kv_heads,
             llm.resolved_head_dim)
    pool_k = rng.randn(*shape).astype(np.float32)
    pool_v = rng.randn(*shape).astype(np.float32)
    table = np.zeros((B, N_PAGES), np.int32)
    table[0] = [1, 2, 3, 4, 0, 0]
    table[1] = [1, 2, 5, 6, 7, 0]
    positions = np.full((B, N_PAGES * PAGE), -1, np.int32)
    positions[0, :10] = np.arange(10)       # prefix 10 in 3 pages
    positions[0, 12:14] = [10, 11]          # two decoded tokens
    positions[1, :9] = np.arange(9)
    positions[1, 16:19] = [9, 10, 11]
    pos = np.array([12, 12, 0], np.int32)
    write_slot = np.array([14, 19, 0], np.int32)
    tokens = rng.randint(0, llm.vocab_size, (B, 1)).astype(np.int32)
    return pool_k, pool_v, table, positions, tokens, pos, write_slot


def _paged_layer_inputs(case):
    """gqa/group inputs the way ``llm_decode_step_paged`` derives them."""
    pool_k, pool_v, table, positions, _, pos, write_slot = case
    rows = np.arange(len(pos))
    pos_arr = positions.copy()
    pos_arr[rows, write_slot] = pos
    mask = np.array(jc.cache_mask(pos_arr, pos[:, None]))
    write_page = table[rows, write_slot // PAGE]
    write_off = write_slot % PAGE
    return mask, write_page, write_off


def _last_writes(write_page, write_off, pool):
    """``attention.last_writes`` for a write into one layer of ``pool``
    (L, P, page, K, hd)."""
    return tattn.last_writes(torch.from_numpy(write_page),
                             torch.from_numpy(write_off), pool.shape[2],
                             pool.shape[1])


@pytest.mark.parametrize("flash", [True, False])
def test_gqa_decode_paged(system, flash):
    params, tparams, _, _ = system
    case = _paged_case(20)
    pool_k, pool_v, table, _, _, pos, _ = case
    mask, write_page, write_off = _paged_layer_inputs(case)
    jp = _layer(params["llm"]["groups"][0]["attn"], 0)
    tp = _tlayer(tparams["llm"]["groups"][0]["attn"], 0)
    x = _rng(21).randn(3, 1, TP.llm.d_model).astype(np.float32)
    positions = pos[:, None]
    jcfg = JP.llm.replace(use_flash_decode=flash)
    tcfg = TP.llm.replace(use_flash_decode=flash)
    jo, jpool = jattn.gqa_decode_paged(
        jp, jcfg, x, positions, {"k": jnp.asarray(pool_k[0]),
                                 "v": jnp.asarray(pool_v[0])},
        jnp.asarray(table), jnp.asarray(write_page), jnp.asarray(write_off),
        jnp.asarray(mask))
    tpool = {"k": torch.from_numpy(pool_k[0].copy()),
             "v": torch.from_numpy(pool_v[0].copy())}
    to, tpool2 = tattn.gqa_decode_paged(
        tp, tcfg, torch.from_numpy(x), torch.from_numpy(positions), tpool,
        torch.from_numpy(table), torch.from_numpy(write_page).long(),
        torch.from_numpy(write_off).long(), torch.from_numpy(mask),
        _last_writes(write_page, write_off, pool_k))
    assert tpool2["k"] is tpool["k"]            # updated in place
    _close(jo, to)
    _close(jpool["k"], tpool2["k"])
    _close(jpool["v"], tpool2["v"])


@pytest.mark.parametrize("shape", [(5,), (3, 4)], ids=["decode", "verify"])
def test_pool_write_keeps_the_last_entry_for_each_slot(shape):
    """A paged write whose entries share slots (pad entries and idle rows
    on the trash page) leaves what a sequential write in row-major order
    leaves, and the write it hands on gives every slot one value: entries
    that share a slot carry the same row, so the order in which the card
    resolves duplicate indices cannot matter."""
    rng = np.random.RandomState(3)
    P, page, K, hd = 3, 2, 2, 3
    # four slots (pages 0 and 1) for 5 or 12 entries: some slots shared
    write_page = torch.from_numpy(rng.randint(0, 2, shape).astype(np.int32))
    write_off = torch.from_numpy(rng.randint(0, page, shape).astype(np.int32))
    k = torch.from_numpy(rng.randn(*shape, K, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(*shape, K, hd).astype(np.float32))
    pool = {"k": torch.zeros(P, page, K, hd), "v": torch.zeros(P, page, K, hd)}
    want = {n: t.clone() for n, t in pool.items()}
    for i, (pg, off) in enumerate(zip(write_page.reshape(-1).tolist(),
                                      write_off.reshape(-1).tolist())):
        want["k"][pg, off] = k.reshape(-1, K, hd)[i]
        want["v"][pg, off] = v.reshape(-1, K, hd)[i]
    slots = (write_page.long() * page + write_off.long()).reshape(-1)
    assert len(set(slots.tolist())) < slots.numel()
    handed = []
    put = tattn._put

    def recorded(pool_t, pg, off, rows):
        handed.append(((pg.long() * page + off.long()).tolist(), rows))
        put(pool_t, pg, off, rows)

    with mock.patch.object(tattn, "_put", recorded):
        tattn.write_pool(pool, write_page, write_off, k, v,
                         tattn.last_writes(write_page, write_off, page, P))
    assert torch.equal(pool["k"], want["k"])
    assert torch.equal(pool["v"], want["v"])
    assert len(handed) == 2
    for written, rows in handed:
        value = {}
        for slot, row in zip(written, rows):
            assert torch.equal(value.setdefault(slot, row), row)


def test_group_decode_paged(system):
    params, tparams, _, _ = system
    case = _paged_case(23)
    pool_k, pool_v, table, _, _, pos, _ = case
    mask, write_page, write_off = _paged_layer_inputs(case)
    x = _rng(24).randn(3, 1, TP.llm.d_model).astype(np.float32)
    positions = pos[:, None]
    spec_j, spec_t = jstack.layer_groups(JP.llm)[0], tstack.layer_groups(
        TP.llm)[0]
    jcfg = JP.llm.replace(use_flash_decode=True)
    tcfg = TP.llm.replace(use_flash_decode=True)
    jx, jpool = jstack.group_decode_paged(
        params["llm"]["groups"][0], jcfg, spec_j, x, positions,
        {"k": jnp.asarray(pool_k), "v": jnp.asarray(pool_v)},
        jnp.asarray(table), jnp.asarray(write_page), jnp.asarray(write_off),
        jnp.asarray(mask))
    tpool = {"k": torch.from_numpy(pool_k.copy()),
             "v": torch.from_numpy(pool_v.copy())}
    tx, tpool = tstack.group_decode_paged(
        tparams["llm"]["groups"][0], tcfg, spec_t, torch.from_numpy(x),
        torch.from_numpy(positions), tpool, torch.from_numpy(table),
        torch.from_numpy(write_page).long(),
        torch.from_numpy(write_off).long(), torch.from_numpy(mask))
    _close(jx, tx)
    _close(jpool["k"], tpool["k"])
    _close(jpool["v"], tpool["v"])
    with pytest.raises(NotImplementedError):
        tstack.group_decode_paged({}, tcfg, tstack.GroupSpec("moe", 1), tx,
                                  None, tpool, None, None, None, None)


def test_llm_prefill_paged(system):
    params, tparams, _, _ = system
    ctx, query = _ctx_query(25, B=1)
    jl, js, jpaged = jv.llm_prefill_paged(params, JP, ctx, query, PAGE)
    tl, ts, tpaged = tv.llm_prefill_paged(tparams, TP, torch.from_numpy(ctx),
                                          torch.from_numpy(query), PAGE)
    _close(jl, tl)
    _close(js, ts)
    for name in ("k", "v"):
        j, t = jpaged["groups"][0][name], tpaged["groups"][0][name]
        assert tuple(t.shape) == j.shape
        _close(j, t)


@pytest.mark.parametrize("flash", [True, False])
def test_llm_decode_step_paged(system, flash):
    params, tparams, _, _ = system
    pool_k, pool_v, table, positions, tokens, pos, write_slot = \
        _paged_case(26)
    jcfg = dataclasses.replace(JP, llm=JP.llm.replace(use_flash_decode=flash))
    tcfg = dataclasses.replace(TP, llm=TP.llm.replace(use_flash_decode=flash))
    jl, js, jpool = jv.llm_decode_step_paged(
        params, jcfg, {"groups": [{"k": jnp.asarray(pool_k),
                                   "v": jnp.asarray(pool_v)}]},
        table, positions, tokens, pos, write_slot)
    tpool = {"groups": [{"k": torch.from_numpy(pool_k.copy()),
                         "v": torch.from_numpy(pool_v.copy())}]}
    tl, ts, tpool = tv.llm_decode_step_paged(
        tparams, tcfg, tpool, *(torch.from_numpy(a) for a in (
            table, positions, tokens, pos, write_slot)))
    _close(jl, tl)
    _close(js, ts)
    for name in ("k", "v"):
        _close(jpool["groups"][0][name], tpool["groups"][0][name])


C_VERIFY = 3


def _verify_case(seed):
    """The paged case as a verify step: row 0 a full chunk of C_VERIFY
    tokens (its page table grown to cover the overhang), row 1 one real
    entry and two pad entries, row 2 idle on the trash page."""
    pool_k, pool_v, table, positions, _, pos, write_slot = _paged_case(seed)
    table[0, 4] = 8
    tokens = _rng(seed + 1).randint(0, TP.llm.vocab_size,
                                    (3, C_VERIFY)).astype(np.int32)
    chunk_len = np.array([C_VERIFY, 1, 1], np.int32)
    return pool_k, pool_v, table, positions, tokens, pos, write_slot, \
        chunk_len


def _verify_layer_inputs(case):
    """gqa/group inputs the way ``llm_verify_step_paged`` derives them."""
    _, _, table, positions, _, pos, write_slot, chunk_len = case
    B, W = positions.shape
    offs = np.arange(C_VERIFY)[None]
    valid = offs < chunk_len[:, None]
    pos_c = (pos[:, None] + offs).astype(np.int32)
    ws = write_slot[:, None] + offs
    pos_arr = positions.copy()
    for b, c in zip(*np.nonzero(valid)):
        pos_arr[b, ws[b, c]] = pos_c[b, c]
    mask = np.array(jc.cache_mask(pos_arr[:, None, :], pos_c[:, :, None]))
    ws_in = np.minimum(ws, W - 1)
    rows = np.arange(B)[:, None]
    write_page = np.where(valid, table[rows, ws_in // PAGE], 0)
    return pos_c, mask, write_page, ws_in % PAGE


def _close_live(a, b, chunk_len, rows=(0, 1)):
    """Valid chunk entries of the live rows only (pad and idle entries are
    garbage the caller drops)."""
    for r in rows:
        _close(np.asarray(a)[r, :chunk_len[r]],
               b[r, :chunk_len[r]].detach().numpy())


def _close_pool(j, t):
    """Every page but the trash page 0, where duplicate pad writes land in
    an order neither framework fixes."""
    _close(np.asarray(j)[:, 1:] if np.ndim(j) == 5 else np.asarray(j)[1:],
           (t[:, 1:] if t.dim() == 5 else t[1:]).detach().numpy())


@pytest.mark.parametrize("flash", [True, False])
def test_gqa_verify_paged(system, flash):
    params, tparams, _, _ = system
    case = _verify_case(30)
    pool_k, pool_v, table, *_, chunk_len = case
    pos_c, mask, write_page, write_off = _verify_layer_inputs(case)
    jp = _layer(params["llm"]["groups"][0]["attn"], 1)
    tp = _tlayer(tparams["llm"]["groups"][0]["attn"], 1)
    x = _rng(31).randn(3, C_VERIFY, TP.llm.d_model).astype(np.float32)
    jcfg = JP.llm.replace(use_flash_decode=flash)
    tcfg = TP.llm.replace(use_flash_decode=flash)
    jo, jpool = jattn.gqa_verify_paged(
        jp, jcfg, x, pos_c, {"k": jnp.asarray(pool_k[0]),
                             "v": jnp.asarray(pool_v[0])},
        jnp.asarray(table), jnp.asarray(write_page), jnp.asarray(write_off),
        jnp.asarray(mask))
    tpool = {"k": torch.from_numpy(pool_k[0].copy()),
             "v": torch.from_numpy(pool_v[0].copy())}
    to, tpool2 = tattn.gqa_verify_paged(
        tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos_c), tpool,
        torch.from_numpy(table), torch.from_numpy(write_page).long(),
        torch.from_numpy(write_off).long(), torch.from_numpy(mask),
        _last_writes(write_page, write_off, pool_k))
    assert tpool2["k"] is tpool["k"]            # updated in place
    _close_live(jo, to, chunk_len)
    _close_pool(jpool["k"], tpool2["k"])
    _close_pool(jpool["v"], tpool2["v"])


def test_group_verify_paged(system):
    params, tparams, _, _ = system
    case = _verify_case(32)
    pool_k, pool_v, table, *_, chunk_len = case
    pos_c, mask, write_page, write_off = _verify_layer_inputs(case)
    x = _rng(33).randn(3, C_VERIFY, TP.llm.d_model).astype(np.float32)
    spec_j, spec_t = jstack.layer_groups(JP.llm)[0], tstack.layer_groups(
        TP.llm)[0]
    jcfg = JP.llm.replace(use_flash_decode=True)
    tcfg = TP.llm.replace(use_flash_decode=True)
    jx, jpool = jstack.group_verify_paged(
        params["llm"]["groups"][0], jcfg, spec_j, x, pos_c,
        {"k": jnp.asarray(pool_k), "v": jnp.asarray(pool_v)},
        jnp.asarray(table), jnp.asarray(write_page), jnp.asarray(write_off),
        jnp.asarray(mask))
    tpool = {"k": torch.from_numpy(pool_k.copy()),
             "v": torch.from_numpy(pool_v.copy())}
    tx, tpool = tstack.group_verify_paged(
        tparams["llm"]["groups"][0], tcfg, spec_t, torch.from_numpy(x),
        torch.from_numpy(pos_c), tpool, torch.from_numpy(table),
        torch.from_numpy(write_page).long(),
        torch.from_numpy(write_off).long(), torch.from_numpy(mask))
    _close_live(jx, tx, chunk_len)
    _close_pool(jpool["k"], tpool["k"])
    _close_pool(jpool["v"], tpool["v"])
    with pytest.raises(NotImplementedError):
        tstack.group_verify_paged({}, tcfg, tstack.GroupSpec("moe", 1), tx,
                                  None, tpool, None, None, None, None)


@pytest.mark.parametrize("flash", [True, False])
def test_llm_verify_step_paged(system, flash):
    """One full row, one padded row and an idle row on the same pool,
    tables and positions as the reference: valid logits and seg within
    fp32 tolerance, the written pages equal, and the caller's positions
    array untouched (on CPU a tensor made from numpy shares its memory)."""
    params, tparams, _, _ = system
    case = _verify_case(34)
    pool_k, pool_v, table, positions, tokens, pos, write_slot, chunk_len = \
        case
    jcfg = dataclasses.replace(JP, llm=JP.llm.replace(use_flash_decode=flash))
    tcfg = dataclasses.replace(TP, llm=TP.llm.replace(use_flash_decode=flash))
    jl, js, jpool = jv.llm_verify_step_paged(
        params, jcfg, {"groups": [{"k": jnp.asarray(pool_k),
                                   "v": jnp.asarray(pool_v)}]},
        table, positions, tokens, pos, write_slot, chunk_len)
    host = positions.copy()
    tpool = {"groups": [{"k": torch.from_numpy(pool_k.copy()),
                         "v": torch.from_numpy(pool_v.copy())}]}
    tl, ts, tpool = tv.llm_verify_step_paged(
        tparams, tcfg, tpool, *(torch.from_numpy(a) for a in (
            table, positions, tokens, pos, write_slot, chunk_len)))
    np.testing.assert_array_equal(positions, host)
    assert tuple(tl.shape) == (3, C_VERIFY, TP.llm.vocab_size)
    assert tuple(ts.shape) == (3, C_VERIFY, TP.sam.d_model)
    _close_live(jl, tl, chunk_len)
    _close_live(js, ts, chunk_len)
    for name in ("k", "v"):
        _close_pool(jpool["groups"][0][name], tpool["groups"][0][name])


@pytest.mark.parametrize("step", ["decode", "decode_paged", "verify_paged"])
def test_use_flash_runs_the_decode_paths_as_the_reference(system, step):
    """The reference reads use_flash only in the full-sequence pass; its
    decode, paged-decode and verify steps ignore it. With use_flash (and
    the decode kernels) on, each step agrees with the reference's, where
    the port used to raise."""
    params, tparams, _, _ = system

    def cfg(pc):
        return dataclasses.replace(pc, llm=pc.llm.replace(
            use_flash=True, use_flash_decode=True))

    jcfg, tcfg = cfg(JP), cfg(TP)
    if step == "decode":
        ctx, query = _ctx_query(42)
        S = ctx.shape[1] + query.shape[1]
        _, _, jcache = jv.llm_prefill(params, jcfg, ctx, query, width=S + 2)
        _, _, tcache = tv.llm_prefill(tparams, tcfg, torch.from_numpy(ctx),
                                      torch.from_numpy(query), width=S + 2)
        _close(jcache["groups"][0]["k"], tcache["groups"][0]["k"])
        tok = np.array([[3], [17]], np.int32)
        jl, js, _ = jv.llm_decode_step(params, jcfg, jcache, tok,
                                       jnp.int32(S))
        tl, ts, _ = tv.llm_decode_step(tparams, tcfg, tcache,
                                       torch.from_numpy(tok), S)
        _close(jl, tl)
        _close(js, ts)
        return
    if step == "decode_paged":
        case = _paged_case(43)
        pool_k, pool_v, table, positions, tokens, pos, write_slot = case
        args = (table, positions, tokens, pos, write_slot)
        jfn, tfn, live = jv.llm_decode_step_paged, tv.llm_decode_step_paged, \
            None
    else:
        case = _verify_case(44)
        pool_k, pool_v, *rest = case
        args = tuple(rest)
        jfn, tfn, live = jv.llm_verify_step_paged, \
            tv.llm_verify_step_paged, case[-1]
    jl, js, jpool = jfn(params, jcfg, {"groups": [{
        "k": jnp.asarray(pool_k), "v": jnp.asarray(pool_v)}]}, *args)
    tpool = {"groups": [{"k": torch.from_numpy(pool_k.copy()),
                         "v": torch.from_numpy(pool_v.copy())}]}
    tl, ts, tpool = tfn(tparams, tcfg, tpool,
                        *(torch.from_numpy(a) for a in args))
    if live is None:
        _close(jl, tl)
        _close(js, ts)
    else:
        _close_live(jl, tl, live)
        _close_live(js, ts, live)
    for name in ("k", "v"):
        _close_pool(jpool["groups"][0][name], tpool["groups"][0][name])


# ---------------------------------------------------------------------------
# bottleneck
# ---------------------------------------------------------------------------


def _codes_close(jcodes, tcodes):
    diff = np.abs(np.asarray(jcodes, np.int32) - tcodes.numpy().astype(
        np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("tier", ["High Accuracy", "Balanced",
                                  "High Throughput"])
def test_bottleneck_encode(system, tier):
    _, _, bns, tbns = system
    x = _rng(12).randn(2, JP.sam_tokens, JP.sam.d_model).astype(np.float32)
    jcodes, jscales = jbn.encode(bns[tier], x)
    tcodes, tscales = tbn.encode(tbns[tier], torch.from_numpy(x))
    assert tcodes.dtype == torch.int8
    np.testing.assert_allclose(np.asarray(jscales), tscales.numpy(),
                               rtol=1e-5, atol=1e-7)
    _codes_close(jcodes, tcodes)


def test_bottleneck_decode(system):
    _, _, bns, tbns = system
    tier = "Balanced"
    rank = bns[tier]["enc"].shape[1]
    rng = _rng(13)
    codes = rng.randint(-127, 128, (2, JP.sam_tokens, rank)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, (2, JP.sam_tokens, 1)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jbn.decode(bns[tier], codes, scales)),
        tbn.decode(tbns[tier], torch.from_numpy(codes),
                   torch.from_numpy(scales)).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tier", ["High Accuracy", "Balanced",
                                  "High Throughput"])
def test_bottleneck_use_kernel(system, tier):
    """encode/decode(use_kernel=True) against the reference's (its Pallas
    kernels in interpret mode): the port's kernel wrappers take their
    plain versions on CPU tensors; the SAM boundary (1, T, d) in, codes,
    scales and the decoded activation out in the reference's shapes."""
    _, _, bns, tbns = system
    x = _rng(15).randn(1, JP.sam_tokens, JP.sam.d_model).astype(np.float32)
    jcodes, jscales = jbn.encode(bns[tier], x, use_kernel=True)
    tcodes, tscales = tbn.encode(tbns[tier], torch.from_numpy(x),
                                 use_kernel=True)
    assert tuple(tcodes.shape) == jcodes.shape
    assert tuple(tscales.shape) == jscales.shape
    np.testing.assert_allclose(np.asarray(jscales), tscales.numpy(),
                               rtol=1e-5, atol=1e-7)
    _codes_close(jcodes, tcodes)
    codes, scales = np.array(jcodes), np.array(jscales)
    jy = jbn.decode(bns[tier], codes, scales, out_dtype=jnp.float32,
                    use_kernel=True)
    ty = tbn.decode(tbns[tier], torch.from_numpy(codes),
                    torch.from_numpy(scales), out_dtype=torch.float32,
                    use_kernel=True)
    assert tuple(ty.shape) == jy.shape
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=1e-5,
                               atol=1e-5)
    plain = tbn.decode(tbns[tier], torch.from_numpy(codes),
                       torch.from_numpy(scales))
    np.testing.assert_allclose(plain.numpy(), ty.numpy(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# bf16: the working dtype of LISA-7B on the card
# ---------------------------------------------------------------------------


def _bf16(pcfg):
    def cast(m):
        return m.replace(param_dtype="bfloat16", act_dtype="bfloat16")
    return dataclasses.replace(pcfg, sam=cast(pcfg.sam), clip=cast(pcfg.clip),
                               llm=cast(pcfg.llm))


def test_bf16_pipeline_matches_reference(system):
    """lisa_mini in bf16 (the fixture's weights cast to bf16, bridged bit
    for bit): the casts of the port (norms and softmax in f32,
    probabilities cast to v's dtype, bf16 activations) follow the
    reference's. Tolerance rtol/atol 5e-2: a few bf16 roundings placed
    differently by the two frameworks' CPU kernels. Greedy tokens are not
    compared in bf16: where two logits sit within a rounding of each other
    the argmax may differ, so the decode step is fed the same token."""
    jb, tb = _bf16(JP), _bf16(TP)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), system[0])
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params), "cpu")
    assert tparams["llm"]["embed"].dtype == torch.bfloat16
    bf = dict(rtol=5e-2, atol=5e-2)
    rng = _rng(14)
    img = rng.rand(2, 64, 64, 3).astype(np.float32)
    jctx = jv.clip_encode(params, jb, img)
    tctx = tv.clip_encode(tparams, tb, torch.from_numpy(img))
    _close(np.asarray(jctx, np.float32), tctx.float(), **bf)
    ctx = np.asarray(jctx, np.float32)
    query = rng.randint(0, JP.llm.vocab_size, (2, 8)).astype(np.int32)
    S = ctx.shape[1] + query.shape[1]
    jl, js, jcache = jv.llm_prefill(params, jb, jnp.asarray(ctx, jnp.bfloat16),
                                    query, width=S + 1)
    tl, ts, tcache = tv.llm_prefill(tparams, tb,
                                    torch.from_numpy(ctx).to(torch.bfloat16),
                                    torch.from_numpy(query), width=S + 1)
    _close(np.asarray(jl, np.float32), tl.float(), **bf)
    _close(np.asarray(js, np.float32), ts.float(), **bf)
    tok = np.array([[5], [40]], np.int32)
    jl, js, _ = jv.llm_decode_step(params, jb, jcache, tok, jnp.int32(S))
    tl, ts, _ = tv.llm_decode_step(tparams, tb, tcache,
                                   torch.from_numpy(tok), S)
    _close(np.asarray(jl, np.float32), tl.float(), **bf)
    _close(np.asarray(js, np.float32), ts.float(), **bf)
    small = img[:, :32, :32].copy()
    _close(np.asarray(jv.sam_tail(params, jb, jv.sam_head(params, jb, small)),
                      np.float32),
           tv.sam_tail(tparams, tb,
                       tv.sam_head(tparams, tb, torch.from_numpy(small))
                       ).float(), **bf)
