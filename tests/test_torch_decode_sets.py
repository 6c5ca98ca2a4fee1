"""The bf16 decode kernels on grouped query heads: the launcher's choice of
kernel, the plain versions at the query-set edges, and the sources.

``ops.decode_plan`` (the rule both decode wrappers take) gives every head
shape of the repo's configs a plan the library holds, the split-K kernel
(SPLIT) to every G = 1 shape (LISA-7B's whole serving path) and the
float32 kernel to float32. The port's plain ``decode_attention_ref`` and
``paged_decode_attention_ref`` (the wrappers' CPU path, and the oracles the
CUDA kernels are held against on the card) agree with the reference's
Pallas kernels in interpret mode at the edges of the SETS kernel's query
sets of 16 rows (G = 2, 3, 12, 16 and 24), with a fully masked row.
``chip_smoke.py`` phase 3's grouped-query cases run on the CPU, where each
wrapper is its plain version. Each decode launcher asserts at compile time
that the SETS kernel's shared memory fits the card, and SPLIT keeps its
one instantiation list.
"""
import importlib.util
import itertools
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jops
from repro_torch import configs as tconfigs
from repro_torch.kernels.decode_attention import ops, ref

torch.set_num_threads(1)

FP32 = dict(rtol=1e-4, atol=2e-5)       # the reference's fp32 kernel tests
BF16 = dict(rtol=5e-2, atol=5e-2)       # its bf16 tests: one rounding each
NEG_INF = -1e30
CSRC = Path(ops.__file__).parent / "csrc"
SET_G = (2, 3, 12, 16, 24)
SET_HD = (64, 192)
SET_W = (1, 17, 72)
# each (G, hd) once, W taking its three values in turn
SET_CASES = [(G, hd, SET_W[i % len(SET_W)])
             for i, (G, hd) in enumerate(itertools.product(SET_G, SET_HD))]


def _decoder_heads():
    """(H, K, hd) of every config whose decode reaches the kernels: the
    zoo's causal GQA decoders and the LISA LLMs."""
    cfgs = [tconfigs.get_config(n) for n in tconfigs.REGISTRY]
    cfgs = [c for c in cfgs if c.attn_type == "gqa" and c.causal]
    cfgs += [tconfigs.get_lisa_config(n).llm
             for n in ("lisa-7b", "lisa-mini", "lisa-nano")]
    return sorted({(c.num_heads, c.num_kv_heads, c.resolved_head_dim)
                   for c in cfgs})


@pytest.mark.parametrize("H,K,hd", _decoder_heads())
def test_every_config_gets_a_built_plan(H, K, hd):
    G = H // K
    for B, W in itertools.product((1, 2, 4, 8), (1, 72, 208, 4096)):
        bf = ops.decode_plan(B, H, K, hd, W, torch.bfloat16)
        assert bf in ops.plans(torch.bfloat16, G)
        assert bf == (ops.DecodePlan.SPLIT if G == 1
                      else ops.DecodePlan.SETS)
        f32 = ops.decode_plan(B, H, K, hd, W, torch.float32)
        assert f32 == ops.DecodePlan.FLASH_DECODE
        assert f32 in ops.plans(torch.float32, G)


def test_g1_keeps_split_at_every_shape():
    """LISA-7B (H = K = 32, hd 128) in all three batching modes and on a
    tensor-parallel rank (K = 16), and G = 1 at any B and W."""
    llm = tconfigs.get_lisa_config("lisa-7b").llm
    H, K, hd = llm.num_heads, llm.num_kv_heads, llm.resolved_head_dim
    assert H == K
    for B, W in itertools.product((1, 2, 3, 4, 8, 64), (1, 16, 208, 224,
                                                        4096)):
        for heads in (H, H // 2):
            assert ops.decode_plan(B, heads, heads, hd, W,
                                   torch.bfloat16) == ops.DecodePlan.SPLIT
    assert ops.plans(torch.bfloat16, 1) == (ops.DecodePlan.SPLIT,)
    assert ops.plans(torch.bfloat16, 12) == (ops.DecodePlan.SPLIT,
                                             ops.DecodePlan.SETS)
    assert ops.plans(torch.float16, 2) == ()


def test_sets_split_and_forced_plans():
    """The SETS split cap: one CTA per SETS_MIN_SLOTS slots, 1 to
    MAX_SPLIT; a forced plan must be one the library holds at that dtype
    and G, and only SETS takes a split."""
    caps = [ops.sets_split(W) for W in range(1, 5000, 7)]
    assert min(caps) == 1 and max(caps) == ops.MAX_SPLIT
    assert caps == sorted(caps)
    assert ops.sets_split(ops.SETS_MIN_SLOTS - 1) == 1
    assert ops.sets_split(2 * ops.SETS_MIN_SLOTS) == 2
    lp = ops._launch_plan
    bf, f32 = torch.bfloat16, torch.float32
    assert lp(None, None, bf, 12, 2, 96, 8, 192, 4096) == (
        ops.DecodePlan.SETS, ops.sets_split(4096))
    assert lp(ops.DecodePlan.SETS, 1, bf, 3, 2, 24, 8, 64, 72) == (
        ops.DecodePlan.SETS, 1)
    assert lp(ops.DecodePlan.SPLIT, None, bf, 3, 2, 24, 8, 64, 72) == (
        ops.DecodePlan.SPLIT, 0)
    assert lp(None, None, f32, 3, 2, 24, 8, 64, 72) == (
        ops.DecodePlan.FLASH_DECODE, 0)
    for bad in ((ops.DecodePlan.SETS, None, bf, 1),
                (ops.DecodePlan.FLASH_DECODE, None, bf, 2),
                (ops.DecodePlan.SPLIT, None, f32, 2),
                (ops.DecodePlan.SPLIT, 2, bf, 2),
                (ops.DecodePlan.SETS, 0, bf, 2),
                (ops.DecodePlan.SETS, ops.MAX_SPLIT + 1, bf, 2)):
        plan, split, dtype, G = bad
        with pytest.raises(ValueError):
            lp(plan, split, dtype, G, 2, 2 * G, 2, 64, 72)


def _lens(W):
    """Row 0 fully masked, row 1 a third of W (at least one slot), row 2
    all of W."""
    return np.array([0, max(1, W // 3), W])


def _bias(lens, W):
    return np.where(np.arange(W)[None] < lens[:, None], 0.0,
                    NEG_INF).astype(np.float32)


def _t(dtype, *arrays):
    return [torch.from_numpy(a).to(dtype) if a.dtype == np.float32
            and i < 3 else torch.from_numpy(a)
            for i, a in enumerate(arrays)]


def _j(dtype, *arrays):
    return [jnp.asarray(a, dtype) if a.dtype == np.float32 and i < 3
            else jnp.asarray(a) for i, a in enumerate(arrays)]


@pytest.mark.parametrize("G,hd,W", SET_CASES)
def test_decode_plain_matches_pallas_at_set_edges(G, hd, W):
    """B = 3 over K = 2 kv heads, float32 at the reference's fp32
    tolerance and bf16 (both sides rounding once) at its bf16 one."""
    rng = np.random.RandomState(G * 1000 + hd + W)
    B, K = 3, 2
    H = G * K
    q = rng.randn(B, H, hd).astype(np.float32)
    k = rng.randn(B, W, K, hd).astype(np.float32)
    v = rng.randn(B, W, K, hd).astype(np.float32)
    bias = _bias(_lens(W), W)
    for tdt, jdt, tol in ((torch.float32, jnp.float32, FP32),
                          (torch.bfloat16, jnp.bfloat16, BF16)):
        out = ref.decode_attention_ref(*_t(tdt, q, k, v, bias))
        assert out.dtype == tdt and torch.isfinite(out).all()
        pallas = jops.decode_attention(*_j(jdt, q, k, v, bias))
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(pallas, np.float32), **tol)
    # the fully masked row is the mean of v over its W slots
    want = v[0].mean(0).repeat(G, axis=0)
    got = ref.decode_attention_ref(*_t(torch.float32, q, k, v, bias))[0]
    np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize("G,hd,W", SET_CASES)
def test_paged_decode_plain_matches_pallas_at_set_edges(G, hd, W):
    """The same lengths over pages of 16 in a shuffled table (page 0
    unnamed), float32 where the case's index is even, else bf16."""
    rng = np.random.RandomState(G * 1000 + hd + W + 1)
    B, K, page = 3, 2, 16
    H, n = G * K, -(-W // page)
    P = B * n + 1
    q = rng.randn(B, H, hd).astype(np.float32)
    kp = rng.randn(P, page, K, hd).astype(np.float32)
    vp = rng.randn(P, page, K, hd).astype(np.float32)
    pt = (1 + rng.permutation(B * n).reshape(B, n)).astype(np.int32)
    bias = _bias(_lens(W), n * page)
    f32 = SET_CASES.index((G, hd, W)) % 2 == 0
    tdt, jdt, tol = ((torch.float32, jnp.float32, FP32) if f32
                     else (torch.bfloat16, jnp.bfloat16, BF16))
    out = ref.paged_decode_attention_ref(*_t(tdt, q, kp, vp, pt, bias))
    assert out.dtype == tdt and torch.isfinite(out).all()
    pallas = jops.paged_decode_attention(*_j(jdt, q, kp, vp, pt, bias))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(pallas, np.float32), **tol)


def _load_chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel", ["decode_attention",
                                    "paged_decode_attention"])
def test_chip_smoke_set_cases_hold_on_the_cpu(kernel, monkeypatch):
    """Phase 3's grouped-query cases cover every G, hd and W under every
    bf16 plan; each runs untimed on the CPU, where the wrapper is its
    plain version, so each reads 0 and its P-split ratio 0 (or none where
    one bf16 P is exact)."""
    cs = _load_chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    check = {"decode_attention": cs.check_decode_attention,
             "paged_decode_attention": cs.check_paged_decode_attention}
    cases = cs.decode_set_cases()[kernel]
    got = {(c["H"] // c["K"], c["hd"],
            c["W"] if "W" in c else int(c["valid"].sum(1).max()),
            c["plan"]) for c in cases}
    want = {(G, hd, W, plan) for G, hd, W in cs.decode_set_shapes()
            for plan in (ops.DecodePlan.SPLIT, ops.DecodePlan.SETS)}
    assert got == want
    assert {hd for _, hd, _, _ in got} == set(ops.HEAD_DIMS)
    for c in cases[::3]:
        r = check[kernel](cs.case_rng(0, c["name"]), c, torch.device("cpu"),
                          timed=False)
        assert r["max_abs_err"] == 0.0 and r["plan"] == c["plan"].name
        assert r["p_split"]["ratio"] in (0.0, None)
    timed = cs.decode_timed_cases()[kernel]
    assert {c["H"] // c["K"] for c in timed} == (
        {3, 12} if kernel == "decode_attention" else {3, 6, 12})


def _launcher_source(name):
    return (CSRC / f"{name}.cu").read_text()


@pytest.mark.parametrize("name", ["decode_attention",
                                  "paged_decode_attention"])
def test_launchers_assert_shared_memory_and_keep_split(name):
    """The SETS kernel's launcher struct asserts its shared memory against
    the block's limit; SPLIT still launches Sizes<1, kMaxGroup>; the C
    plan enum and the launch function's arguments match ops.py."""
    src = _launcher_source(name)
    body = re.search(r"struct SetKernel \{(.*?)\};", src, re.S).group(1)
    assert re.search(r"static_assert\(\s*split_decode::SetSmem<HD>::kBytes"
                     r"\s*<=\s*split_decode::kBlockSmem", body)
    assert "split_decode::Sizes<1, split_decode::kMaxGroup>{}" in src
    enum = re.search(r"enum Plan \{([^}]*)\}", src).group(1)
    assert {m: int(v) for m, v in re.findall(r"k(\w+) = (\d+)", enum)} == {
        "FlashDecode": int(ops.DecodePlan.FLASH_DECODE),
        "Split": int(ops.DecodePlan.SPLIT), "Sets": int(ops.DecodePlan.SETS)}
    sig = re.search(rf'extern "C" int {name}_launch\((.*?)\)\s*\{{', src,
                    re.S).group(1)
    assert len(sig.split(",")) == len(ops._ARGTYPES[name])
