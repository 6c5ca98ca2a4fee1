"""The flash kernel's two bf16 designs: their tile edges, and the launcher's
choice between them.

The port's plain ``attention_ref`` (the wrapper's CPU path, and the oracle
the CUDA kernels are held against on the card) agrees with the reference's
``flash_attention`` (its Pallas kernel in interpret mode) at the edges of
the warp-specialised kernel's 128-row q tiles and wide kv tiles: S = 1, 65
and 129, hd 128 and 192, G = 1 and 12, causal and not. ``chip_smoke.py``
phase 3 lists those shapes as its edge cases and runs each under every bf16
plan; on CPU tensors each plan is the plain version, which this file
rehearses. ``flash_plan`` (the rule the launcher takes) gives every head
size a plan the library was built for, and the LISA-7B prefill the plan
the card measured faster; each kernel's launcher asserts at compile time
that its shared memory fits the card.
"""
import importlib.util
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfops
from repro_torch.configs import get_lisa_config
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref

torch.set_num_threads(1)

FP32 = dict(rtol=1e-4, atol=2e-5)       # the reference's fp32 kernel tests
BF16 = dict(rtol=5e-2, atol=5e-2)       # its bf16 tests: one rounding each
EDGE_S = (1, 65, 129)
EDGE_HD = (128, 192)
EDGE_G = {1: (2, 2), 12: (12, 1)}       # G: (H, K), heads cut for the CPU


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("G", sorted(EDGE_G))
@pytest.mark.parametrize("S", EDGE_S)
@pytest.mark.parametrize("hd", EDGE_HD)
def test_plain_matches_pallas_at_tile_edges(hd, S, G, causal):
    """float32 at the reference's fp32 tolerance, bf16 (both sides
    rounding once to bf16) at its bf16 tolerance."""
    H, K = EDGE_G[G]
    rng = np.random.RandomState(hd * 1000 + S * 10 + G)
    q = rng.randn(2, S, H, hd).astype(np.float32)
    k = rng.randn(2, S, K, hd).astype(np.float32)
    v = rng.randn(2, S, K, hd).astype(np.float32)
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, FP32),
                               (torch.bfloat16, jnp.bfloat16, BF16)):
        t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
        out = fops.flash_attention(*t, causal=causal)
        assert out.dtype == dtype and out.shape == (2, S, H, hd)
        want = jfops.flash_attention(*(jnp.asarray(a, jdtype)
                                       for a in (q, k, v)), causal=causal)
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


def test_edge_cases_cover_the_tile_edges():
    """Phase 3's edge cases are exactly those shapes, in bf16, each over a
    buffer whose rows past S are NaN."""
    cases = _chip_smoke().flash_edge_cases()
    got = {(c["hd"], c["S"], c["H"] // c["K"], c["causal"]) for c in cases}
    want = {(hd, S, G, causal) for hd in EDGE_HD for S in EDGE_S
            for G in EDGE_G for causal in (True, False)}
    assert got == want and len(cases) == len(want)
    for c in cases:
        assert c["dtype"] == torch.bfloat16 and c["pad"] > 0
        assert (c["H"], c["K"]) == EDGE_G[c["H"] // c["K"]]


def test_edge_checks_run_every_plan_on_the_cpu(monkeypatch):
    """``flash_edge_checks`` runs each edge case once under each bf16 plan
    of its G (three at G = 12, two at G = 1), on the case's
    own inputs; on CPU tensors each is the plain version (error 0,
    bit-equal twice)."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    res = cs.flash_edge_checks(0, torch.device("cpu"))
    cases = cs.flash_edge_cases()
    assert len(res) == sum(3 if c["H"] // c["K"] == 12 else 2
                           for c in cases)
    for c in cases:
        mine = [r for r in res if r["case"].startswith(c["name"] + "_")]
        assert sorted(r["plan"] for r in mine) == sorted(
            p.name for p in fops.plans(torch.bfloat16, c["H"] // c["K"]))
    assert all(r["max_abs_err"] == 0.0 and r["deterministic"] for r in res)
    # every case's P-split reading; at S = 1 one bf16 P is exact (one key a
    # row), so there is no ratio to hold
    for r in res:
        assert (r["p_split"]["ratio"] is None) == (r["S"] == 1)
        assert r["S"] == 1 or r["p_split"]["ratio"] == 0.0


# ---------------------------------------------------------------------------
# the launcher's plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", fops.HEAD_DIMS)
def test_every_head_size_gets_a_plan_that_fits(hd):
    """At every head size, dtype and G, at short and long sequences and
    small and large grids, the rule's plan is one the library holds (each
    kernel's fit in shared memory: ``test_shared_memory_of_each_plan``)."""
    for dtype in (torch.float32, torch.bfloat16):
        for G in (1, 2, 3, 12):
            built = fops.plans(dtype, G)
            assert built
            for B, S, H in ((1, 1, 12), (1, 204, 36), (4, 204, 36),
                            (1, 1500, 12), (2, 1024, 96), (1, 4096, 24)):
                assert fops.flash_plan(B, S, H, H // G, hd, dtype) in built


def test_shared_memory_of_each_plan():
    """Each kernel's launcher (the float32 split-TF32 kernel,
    flash_wgmma_kernel, flash_ws_kernel) asserts at compile time that its
    shared memory fits the 227 KB a block may use on the H100, and the
    library instantiates every head size of ``HEAD_DIMS``, so the
    compiler checks every plan at every size."""
    src = (Path(fops.__file__).parent / "csrc"
           / "flash_attention.cu").read_text()
    assert "constexpr size_t kBlockSmem = 232448;" in src
    for kernel in ("tf32", "wg", "ws"):
        assert re.search(rf"constexpr size_t bytes = {kernel}_smem_bytes<"
                         r"[^;]*;\n\s*static_assert\(bytes <= kBlockSmem",
                         src), kernel
    hds = [int(h) for h in re.findall(r"FLASH_HD\((\d+)\)", src)]
    assert hds == list(fops.HEAD_DIMS) * 2      # launch and tile
    assert [p.value for p in fops.FlashPlan] == [
        int(v) for v in re.findall(r"k(?:Wgmma|WsHalves|WsPairs|Tf32) = "
                                   r"(\d+),", src)]


def test_lisa_prefill_takes_the_plan_the_card_measured_faster():
    """LISA-7B's prefill (B = 1 and 4, S = clip tokens + query, H = 32,
    hd 128) ran faster on the one-warpgroup kernel (WGMMA) than on the
    warp-specialised one, as did S 1,500 over 4 heads and granite's hd 64;
    nemotron's, zamba2's, qwen2-vl's, SAM's tail and S 4,096 the other way
    (PERF.md §6, the A/B lines of phase 3)."""
    P = fops.FlashPlan
    llm = get_lisa_config("lisa-7b").llm
    S = get_lisa_config("lisa-7b").clip_tokens + 8
    bf16 = torch.bfloat16
    for B in (1, 4):
        assert fops.flash_plan(B, S, llm.num_heads, llm.num_kv_heads,
                               llm.resolved_head_dim, bf16) == P.WGMMA
    assert fops.flash_plan(1, 1500, 4, 2, 128, bf16) == P.WGMMA
    assert fops.flash_plan(2, 1024, 24, 8, 64, bf16) == P.WGMMA
    # two heads a CTA where G is even, two halves of a head where it is odd
    for B, S, H, K, hd in ((2, 1024, 96, 8, 192), (2, 1024, 12, 2, 128)):
        assert fops.flash_plan(B, S, H, K, hd, bf16) == P.WS_PAIRS
    for B, S, H, K, hd in ((2, 1024, 32, 32, 112), (1, 4096, 16, 16, 80),
                           (1, 4096, 32, 32, 128)):
        assert fops.flash_plan(B, S, H, K, hd, bf16) == P.WS_HALVES
    assert fops.flash_plan(2, 1024, 96, 8, 192,
                           torch.float32) == P.TF32


def test_rule_cases_straddle_the_thresholds():
    """Phase 3's rule cases lie on both sides of each of ``flash_plan``'s
    thresholds: at and below WS_MIN_S at a grid over WS_MIN_CTAS, and at
    and below WS_MIN_CTAS at WS_MIN_S; the rule gives the one-warpgroup
    kernel below each, the warp-specialised one at each."""
    P = fops.FlashPlan
    got = {}
    for c in _chip_smoke().flash_rule_cases():
        B, S, H, K, hd = (c[k] for k in ("B", "S", "H", "K", "hd"))
        assert c["dtype"] == torch.bfloat16 and c["causal"] and hd >= 80
        got[(S, B * H * -(-S // 128))] = fops.flash_plan(
            B, S, H, K, hd, c["dtype"])
    S0, n0 = fops.WS_MIN_S, fops.WS_MIN_CTAS
    below_s = [g for (S, n), g in got.items() if S < S0 and n >= n0]
    at_s = [g for (S, n), g in got.items() if S == S0 and n > n0]
    below_n = [g for (S, n), g in got.items() if S >= S0 and n < n0]
    at_n = [g for (S, n), g in got.items() if S >= S0 and n == n0]
    assert below_s == below_n == [P.WGMMA]
    assert at_s == at_n == [P.WS_HALVES]


def test_wrapper_refuses_a_plan_it_was_not_built_for():
    """An unknown plan, or one of another dtype or G, raises before any
    launch, on either device; every plan held runs (here: the plain
    version)."""
    P = fops.FlashPlan
    q = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 1, 128, dtype=torch.bfloat16)
    for plan in (7, P.TF32):
        with pytest.raises(ValueError, match="was built for"):
            fops.flash_attention(q, k, k, plan=plan)
    with pytest.raises(ValueError, match="was built for"):
        fops.flash_attention(q.float(), k.float(), k.float(),
                             plan=P.WGMMA)
    with pytest.raises(ValueError, match="was built for"):    # G = 1
        fops.flash_attention(q, q, q, plan=P.WS_PAIRS)
    for plan in fops.plans(torch.bfloat16, 2):
        out = fops.flash_attention(q, k, k, plan=plan)
        assert torch.equal(out, fref.attention_ref(q, k, k))


def test_product_bound_counts_the_split_and_whole_tiles():
    """Not causal, S a multiple of every tile: the kernels issue the
    function's q.k and P.V flops with P.V twice, 1.5 times the function.
    Causal: whole diagonal tiles, more for wider tiles, most where two
    halves of a head share the second half's extent. The tiles (query rows
    of a head, keys) of WGMMA, WS_HALVES and WS_PAIRS as
    ``flash_attention_tile`` gives them at hd 80 and 192."""
    cs = _chip_smoke()
    case = dict(B=1, S=4096, H=16, K=16, hd=80, causal=False)
    _, flops = cs.flash_bytes_flops(dict(case, dtype=torch.bfloat16), 2)
    for rows, keys in ((64, 64), (128, 128), (64, 128)):
        assert cs.flash_product_flops(case, rows, keys) == 1.5 * flops
    causal = dict(B=2, S=1024, H=96, K=8, hd=192, causal=True)
    small, halves, pairs = (cs.flash_product_flops(causal, *t)
                            for t in ((64, 64), (128, 96), (64, 96)))
    _, flops = cs.flash_bytes_flops(dict(causal, dtype=torch.bfloat16), 2)
    assert 1.5 * flops < small < pairs < halves


def test_ptxas_lines_name_each_kernel_and_guard_the_launch_registers(
        tmp_path):
    """``ptxas_lines`` names each instantiation by its kernel (the mangled
    name also carries the file's hash) and keeps warnings;
    ``ws_launch_regs`` passes 168 registers and stops on anything else."""
    cs = _chip_smoke()
    ws = ("_ZN45_GLOBAL__N__c2aef73_18_flash_attention_cu_23f0aea715"
          "flash_ws_kernelILi192ELb1ELi96ELi2EEEv14CUtensorMap_st")
    wg = ("_ZN45_GLOBAL__N__c2aef73_18_flash_attention_cu_23f0aea718"
          "flash_wgmma_kernelILi192ELb1EEEv14CUtensorMap_st")
    log = tmp_path / "ptxas.log"

    def write(regs):
        log.write_text(
            f"ptxas info    : Function properties for {ws}\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads\n"
            f"ptxas info    : Used {regs} registers, used 16 barriers\n"
            f"ptxas info    : Function properties for {wg}\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads\n"
            "ptxas info    : Used 199 registers, used 1 barriers\n"
            "ptxas warning : a warning line\n")
        return cs.ptxas_lines(log)

    lines = write(168)
    assert lines[0].startswith("flash_ws_kernelILi192ELb1ELi96ELi2E")
    assert lines[1].startswith("flash_wgmma_kernelILi192ELb1E")
    assert lines[2] == "ptxas warning : a warning line"
    assert cs.ws_launch_regs(lines) == [168]
    with pytest.raises(AssertionError, match="168"):
        cs.ws_launch_regs(write(128))
