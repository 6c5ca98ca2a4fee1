"""The float32 flash kernel (``flash_tf32_kernel``, plan TF32): its split
TF32 arithmetic, the launcher's float32 rule, its fit in shared memory, and
the trace classes and build checks of ``chip_smoke.py`` that name it.

The kernel splits each float32 operand as x = hi + lo, hi = tf32(x) and
lo = tf32(x - hi) (tf32: round to nearest, ties away from zero, by an
integer add and mask), takes each product as hi.hi + hi.lo + lo.hi on the
TF32 tensor cores, and runs the blocked online softmax over kv tiles of its
head size's keys (``TF_KEYS``). A plain emulation of that arithmetic (tf32
rounding by bit operations on float32) agrees with the reference's ``flash_attention`` (its Pallas kernel in
interpret mode) within the reference test's fp32 tolerance at that test's
five shapes and at the float32 edge shapes of ``chip_smoke.py``'s phase 3;
one TF32 product a product (hi.hi alone) misses that tolerance there. The
kernel itself runs only on the card (``chip_smoke.py`` phase 3).
"""
import dataclasses
import importlib.util
import math
import os
import re
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfops
from repro_torch.kernels.flash_attention import ops as fops

torch.set_num_threads(1)

FP32 = dict(rtol=1e-4, atol=2e-5)       # the reference's fp32 kernel tests
NEG_INF = -1e30
# the reference flash test's five shapes (tests/test_kernels.py)
REF_SHAPES = ((2, 128, 4, 2, 64), (1, 200, 4, 4, 32), (2, 64, 8, 2, 64),
              (1, 256, 4, 1, 128), (1, 96, 6, 3, 32))
SRC = (Path(fops.__file__).parent / "csrc" / "flash_attention.cu").read_text()


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the keys of flash_tf32_kernel's kv tile at each head size (TfShape<HD>::BN
# in csrc/flash_attention.cu): the blocks the emulation's softmax walks
TF_KEYS = {32: 64, 64: 64, 80: 32, 112: 32, 128: 32, 192: 32}


def tf32(x):
    """x rounded to tf32, to nearest with ties away from zero: add half of
    the 13 dropped bits' unit to the magnitude bits, then clear them."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _products(a, b, terms):
    """a @ b as the kernel takes it: hi.hi + hi.lo + lo.hi (terms 3), or
    one TF32 product hi.hi (terms 1)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    out = ah @ bh
    if terms == 3:
        out = out + ah @ bl + al @ bh
    return out


def emulate(q, k, v, causal, keys, terms=3):
    """The kernel's arithmetic on float32 tensors: q (B,S,H,hd), k/v
    (B,S,K,hd); kv tiles of ``keys`` keys, running max, sum and
    accumulator, keys after the query masked with NEG_INF when causal,
    P split after the softmax, the division by max(l, 1e-30)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd).permute(0, 2, 3, 1, 4)
    kt_all = k.permute(0, 2, 1, 3)[:, :, None]
    vt_all = v.permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((B, K, G, S, 1), NEG_INF)
    l = torch.zeros((B, K, G, S, 1))
    acc = torch.zeros((B, K, G, S, hd))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, keys):
        kt = kt_all[..., k0:k0 + keys, :]
        vt = vt_all[..., k0:k0 + keys, :]
        s = _products(qg, kt.transpose(-1, -2), terms) / math.sqrt(hd)
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[-2])[None, :]
            s = torch.where(cols <= rows, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + _products(p, vt, terms)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def _within(a, b):
    return np.allclose(a, b, **FP32)


def _held(shapes, seed):
    """The emulation with the split (within FP32 of the Pallas kernel at
    every shape) and with hi.hi alone (outside it at one shape or more)."""
    missed = []
    for B, S, H, K, hd, causal in shapes:
        rng = np.random.RandomState(seed + S * 7 + hd * 13 + H + causal)
        q = rng.randn(B, S, H, hd).astype(np.float32)
        k = rng.randn(B, S, K, hd).astype(np.float32)
        v = rng.randn(B, S, K, hd).astype(np.float32)
        want = np.asarray(jfops.flash_attention(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal))
        t = [torch.from_numpy(a) for a in (q, k, v)]
        keys = TF_KEYS[hd]
        got = emulate(*t, causal, keys).numpy()
        np.testing.assert_allclose(got, want, **FP32,
                                   err_msg=f"{(B, S, H, K, hd, causal)}")
        if not _within(emulate(*t, causal, keys, terms=1).numpy(), want):
            missed.append((B, S, H, K, hd, causal))
    assert missed, "one TF32 product a product held TOL at every shape"
    return missed


def test_split_matches_pallas_at_the_reference_shapes():
    """The reference test's five shapes, causal and not."""
    _held([s + (c,) for s in REF_SHAPES for c in (True, False)], 0)


@pytest.mark.parametrize("hd", fops.HEAD_DIMS)
def test_split_matches_pallas_at_the_edge_shapes(hd):
    """Phase 3's float32 edge shapes at this head size (S 1, 65, 129; G 1
    and 12; causal and not)."""
    shapes = [(c["B"], c["S"], c["H"], c["K"], c["hd"], c["causal"])
              for c in _chip_smoke().flash_f32_edge_cases() if c["hd"] == hd]
    assert len(shapes) == 12
    _held(shapes, 1)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """tf32() keeps 10 mantissa bits: a value a half unit above a tf32
    number rounds away from zero, just under it toward, signs alike; the
    split is exact to 2^-21 of x."""
    one = torch.tensor([1.0])
    unit = 2.0 ** -10
    for sign in (1.0, -1.0):
        x = sign * (one + unit / 2)
        assert tf32(x).item() == sign * (1 + unit)
        x = sign * (one + unit / 2 - 2.0 ** -20)
        assert tf32(x).item() == sign * 1.0
    x = torch.from_numpy(np.random.RandomState(3).randn(4096)
                         .astype(np.float32))
    hi, lo = _split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -21


# ---------------------------------------------------------------------------
# the launcher's float32 rule, the shared memory, the build checks
# ---------------------------------------------------------------------------


def test_float32_takes_the_tf32_kernel():
    """float32 has one plan, TF32: the card read it faster than the
    CUDA-core kernel it replaced at every timed float32 shape (PERF.md §6),
    so that kernel went. The timed shapes and the reference test's take it, and
    bf16 plans refuse float32 (and TF32 bf16) before any launch."""
    P = fops.FlashPlan
    assert fops.plans(torch.float32) == fops.plans(torch.float32, 12) \
        == (P.TF32,)
    assert P.TF32 not in fops.plans(torch.bfloat16, 2)
    cs = _chip_smoke()
    timed = [c for c in cs.flash_cases(_lisa7b()) if c["name"] ==
             cs.FLASH_F32_TIMED] + cs.flash_f32_timed_cases()
    assert [c["name"] for c in timed] == [
        "float32_B2_S3000_G4_hd64_full_online",
        "float32_B1_S2048_G1_hd128_causal", "float32_lisa_mini_prefill_B4"]
    assert (timed[2]["B"], timed[2]["S"], timed[2]["H"], timed[2]["K"],
            timed[2]["hd"]) == (4, 24, 4, 4, 32)
    for B, S, H, K, hd in [tuple(c[x] for x in ("B", "S", "H", "K", "hd"))
                           for c in timed] + list(REF_SHAPES):
        assert fops.flash_plan(B, S, H, K, hd, torch.float32) == P.TF32
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="was built for"):
        fops.flash_attention(q, q, q, plan=P.WGMMA)
    with pytest.raises(ValueError, match="was built for"):
        fops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                             plan=P.TF32)


def _lisa7b():
    from repro_torch.configs import get_lisa_config
    return get_lisa_config("lisa-7b")


@pytest.mark.parametrize("hd", fops.HEAD_DIMS)
def test_shared_memory_of_each_float32_instantiation(hd):
    """The launcher asserts tf32_smem_bytes<HD>() against the 227 KB a block
    may use, and the library instantiates this head size, so the compiler
    checks its fit."""
    assert re.search(r"constexpr size_t bytes = tf32_smem_bytes<HD>\(\);\n"
                     r"\s*static_assert\(bytes <= kBlockSmem", SRC)
    assert re.findall(rf"FLASH_HD\({hd}\)", SRC) == [f"FLASH_HD({hd})"] * 2
    assert hd in TF_KEYS


def test_trace_classes_name_every_flash_kernel():
    """Every ``__global__`` function of csrc/flash_attention.cu is classed
    as flash_attention by ``_kernel_class``, by its bare name and as the
    profiler shows an instantiation."""
    cs = _chip_smoke()
    names = re.findall(r"__global__ void[^\n]*\n(\w+)\(", SRC)
    assert names and len(names) == SRC.count("__global__")
    assert "flash_tf32_kernel" in names and "flash_ws_kernel" in names
    for n in names:
        assert cs._kernel_class(n) == "flash_attention", n
        assert cs._kernel_class(f"void (anonymous namespace)::{n}<64, true>"
                                f"(CUtensorMap_st, CUtensorMap_st, "
                                f"CUtensorMap_st, float*, int, int, int, "
                                f"float)") == "flash_attention", n
    assert set(cs.KERNEL_FUNCTIONS["flash_attention"]) == set(names)


def test_ptxas_lines_keep_digits_and_guard_spills(tmp_path):
    """``ptxas_lines`` names flash_tf32_kernel by its whole name (digits
    inside the identifier kept), and ``kernels_spill_free`` stops on any
    instantiation that spills or on none built."""
    cs = _chip_smoke()
    tf = ("_ZN45_GLOBAL__N__c2aef73_18_flash_attention_cu_23f0aea717"
          "flash_tf32_kernelILi192ELb1EEEv14CUtensorMap_stS1_S1_Pfiiif")
    log = tmp_path / "ptxas.log"

    def write(spill):
        log.write_text(
            f"ptxas info    : Function properties for {tf}\n"
            f"    {spill} bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads\n"
            "ptxas info    : Used 231 registers, used 16 barriers\n")
        return cs.ptxas_lines(log)

    lines = write(0)
    assert lines[0].startswith("flash_tf32_kernelILi192ELb1E")
    assert cs.kernels_spill_free(lines, "flash_tf32_") == lines
    with pytest.raises(AssertionError, match="spill"):
        cs.kernels_spill_free(write(360), "flash_tf32_")
    with pytest.raises(AssertionError, match="spill"):
        cs.kernels_spill_free(lines, "flash_ws_")


# ---------------------------------------------------------------------------
# the float32 callers' layouts
# ---------------------------------------------------------------------------


def _recording_flash(calls):
    """The wrapper, after asserting that q, k and v are laid out as the
    kernel takes them on the card (``_check``) with rows 16-byte aligned
    (``_check_rows_aligned``, which the CPU path does not reach)."""
    real = fops.flash_attention

    def flash(q, k, v, **kw):
        fops._check(q, k, v)
        fops._check_rows_aligned(q, k, v)
        calls.append((q.dtype, tuple(q.shape)))
        return real(q, k, v, **kw)
    return flash


def _aligned_calls(run):
    calls = []
    with mock.patch.object(fops, "flash_attention", _recording_flash(calls)):
        run()
    assert calls and all(d == torch.float32 for d, _ in calls)
    return calls


def test_lisa_mini_prefill_passes_aligned_rows():
    """lisa-mini's LLM prefill under ``use_flash`` (the float32 caller
    ``chip_smoke.py`` serves on the card) hands the kernel rows it takes:
    one call a layer."""
    from repro_torch.configs import get_lisa_config
    from repro_torch.core import vlm
    pcfg = get_lisa_config("lisa-mini")
    pcfg = dataclasses.replace(pcfg, llm=pcfg.llm.replace(use_flash=True))
    gen = torch.Generator().manual_seed(0)
    params = vlm.init_lisa(pcfg, gen, "cpu")
    rng = np.random.RandomState(0)
    ctx = torch.from_numpy(rng.randn(2, pcfg.clip_tokens, pcfg.llm.d_model)
                           .astype(np.float32))
    query = torch.from_numpy(rng.randint(0, pcfg.llm.vocab_size, (2, 8))
                             .astype(np.int32))
    calls = _aligned_calls(lambda: vlm.llm_reason(params, pcfg, ctx, query))
    assert len(calls) == pcfg.llm.num_layers


@pytest.mark.parametrize("name", ["nemotron-4-340b", "qwen1.5-32b",
                                  "phi4-mini-3.8b", "zamba2-7b",
                                  "granite-moe-3b-a800m", "qwen2-vl-2b"])
def test_reduced_configs_pass_aligned_rows(name):
    """The float32 reduced configs with a causal GQA layer, under
    ``use_flash``, through ``forward`` (M-RoPE's streams included)."""
    from repro_torch import configs
    from repro_torch import models
    cfg = configs.get_reduced(name).replace(use_flash=True)
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 16
    rng = np.random.RandomState(0)
    batch = {"tokens": torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.modality == "vlm":
        nv = cfg.num_vision_tokens
        batch["vision_embeds"] = torch.from_numpy(
            rng.randn(B, nv, cfg.frontend_dim).astype(np.float32))
        batch["positions"] = torch.arange(S, dtype=torch.int32)[
            None, None].expand(3, B, S).contiguous()
    _aligned_calls(lambda: models.forward(params, cfg, batch))
