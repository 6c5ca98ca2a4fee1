"""The per-layer check of the flash kernel, ``chip_smoke.flash_layer_check``,
on the CPU: two LLM prefills of bridged lisa_mini weights with
``llm.use_flash=True`` through the port's ``vlm.llm_reason``, with stand-ins
for the kernel.

The helper runs the path with the flash kernel's plain version in its place
and, at every prefill layer, holds the layer computed with the stand-in
against the layer computed with the plain version on the same input. The
plain version itself (and the wrapper, which takes it on CPU tensors) reads
exactly 0; the plain version with one bf16 ulp added to a few outputs reads
above 0 and under LAYER_RTOL; a stand-in with the wrong scale or no causal
mask fails, naming the first layer.

It also holds phase 3's check that the bf16 kernel keeps P near float32
(``chip_smoke.p_split_reading``): a kernel emulated with P in float64 reads
under P_SPLIT_RATIO, one that rounds P once to bf16 above it.
"""
import dataclasses
import importlib.util
import math
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs.lisa_mini import CONFIG as JP
from repro.models import stack as jstack
from repro.models.common import fan_in_init, normal_init
from repro_torch import bridge
from repro_torch.configs import get_lisa_config
from repro_torch.core import vlm as tv
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPF = get_lisa_config("lisa-mini")
TPF = dataclasses.replace(TPF, llm=TPF.llm.replace(use_flash=True))
PREFILLS = 2


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load_chip_smoke()


@pytest.fixture(scope="module")
def params():
    """The reference's LLM weights (what llm_reason reads), bridged."""
    llm = JP.llm
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    p = {"llm": {"embed": normal_init(ks[0], (llm.vocab_size, llm.d_model),
                                      0.02, llm.pdtype),
                 "groups": [jstack.init_group(ks[1], llm,
                                              jstack.layer_groups(llm)[0])],
                 "norm": jstack.init_norm(llm),
                 "answer_head": fan_in_init(ks[2], (llm.d_model,
                                                    llm.vocab_size),
                                            llm.pdtype)},
         "seg_proj": fan_in_init(ks[3], (llm.d_model, JP.sam.d_model),
                                 llm.pdtype)}
    return bridge.to_torch(jax.tree.map(np.asarray, p), "cpu")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    llm = TPF.llm
    return [(torch.from_numpy(rng.randn(2, TPF.clip_tokens, llm.d_model)
                              .astype(np.float32)),
             torch.from_numpy(rng.randint(0, llm.vocab_size, (2, 8))
                              .astype(np.int32)))
            for _ in range(PREFILLS)]


def _run(params, inputs):
    return lambda: [tv.llm_reason(params, TPF, c, q) for c, q in inputs]


def _nudged(q, k, v, causal=True, block_q=128, block_k=128):
    """The plain version with one bf16 ulp added to every 97th of the
    first 776 outputs."""
    o = ref.attention_ref(q, k, v, causal=causal).contiguous()
    flat = o.view(-1)
    idx = torch.arange(0, 776, 97)
    flat[idx] += 2.0 ** (torch.floor(torch.log2(flat[idx].abs())) - 7)
    return o


def _wrong_scale(q, k, v, causal=True, block_q=128, block_k=128):
    return ref.attention_ref(q / math.sqrt(q.shape[-1]), k, v,
                             causal=causal)


def _no_causal_mask(q, k, v, causal=True, block_q=128, block_k=128):
    return ref.attention_ref(q, k, v, causal=False)


@pytest.mark.parametrize("kernel", ["wrapper", "plain"])
def test_plain_stand_in_reads_zero(params, inputs, kernel):
    stand_in = None if kernel == "wrapper" else cs._flash_plain
    got, summary = cs.flash_layer_check("test", _run(params, inputs),
                                        stand_in)
    L = TPF.llm.num_layers
    assert summary["layers"] == PREFILLS * L
    assert summary["prefills"] == PREFILLS
    assert summary["worst"]["h"] == 0.0 and summary["worst"]["out"] == 0.0
    assert summary["per_prefill_max"] == [0.0] * PREFILLS
    assert summary["outputs_not_bit_equal"] == 0
    # what the run returns is the plain-flash replay's result
    with mock.patch.object(fops, "flash_attention", cs._flash_plain):
        want = _run(params, inputs)()
    for (a, s), (wa, ws) in zip(got, want):
        assert torch.equal(a, wa) and torch.equal(s, ws)


def test_one_ulp_off_is_within_limit(params, inputs):
    _, summary = cs.flash_layer_check("test", _run(params, inputs), _nudged)
    worst = summary["worst"]
    assert 0.0 < max(worst["h"], worst["out"]) < cs.LAYER_RTOL
    assert all(0.0 < m < cs.LAYER_RTOL for m in summary["per_prefill_max"])
    assert summary["outputs_not_bit_equal"] == summary["layers"]


@pytest.mark.parametrize("stand_in", [_wrong_scale, _no_causal_mask],
                         ids=["scale_1_over_hd", "no_causal_mask"])
def test_wrong_kernel_fails_at_first_layer(params, inputs, stand_in):
    with pytest.raises(AssertionError, match=r"prefill 0 layer 0 "):
        cs.flash_layer_check("test", _run(params, inputs), stand_in)


def _emulated(q, k, v, causal, round_p):
    """A flash kernel in float64: the probabilities kept, or rounded once
    to bf16 before P.V, normalised by the sum of the unrounded ones; the
    output rounded once to q's dtype."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    s = torch.einsum("bskgh,btkh->bkgst",
                     q.reshape(B, S, K, H // K, hd).double(),
                     k.double()) / math.sqrt(hd)
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                          ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if round_p:
        p = p.to(torch.bfloat16).double()
    o = torch.einsum("bkgst,btkh->bskgh", p / l, v.double())
    return o.reshape(B, S, H, hd).to(q.dtype)


@pytest.mark.parametrize("round_p", [False, True],
                         ids=["p_float64", "p_rounded_to_bf16"])
def test_p_split_reading_tells_one_bf16_p(round_p):
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 204, heads, 128)
                                .astype(np.float32)).bfloat16()
               for heads in (8, 4, 4))
    want = ref.attention_ref(q, k, v, causal=True)
    reading = cs.p_split_reading(_emulated(q, k, v, True, round_p), want,
                                 q, k, v, True)
    assert reading["limit"] == cs.P_SPLIT_RATIO
    assert 0.0 < reading["rel_err_p_bf16"] < 2.0 ** -8
    if round_p:
        assert reading["ratio"] > 2 * cs.P_SPLIT_RATIO
    else:
        assert reading["ratio"] < cs.P_SPLIT_RATIO / 4
