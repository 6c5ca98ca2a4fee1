"""The per-layer check of the decode kernels, ``chip_smoke.layer_check`` with
the kinds "decode" (``decode_attention``), "paged"
(``paged_decode_attention``) and "verify" (``paged_verify_attention``), on
the CPU: bridged lisa_mini weights from the reference, served through
``chip_smoke``'s own phase-6 run (the microbatch generate path,
``serve_requests``), phase-8 run (the paged ``InflightDecoder``,
``serve_inflight``) and phase-9 run A (the speculative decoder,
``serve_spec`` with 3 drafts over pages of 4), with stand-ins for the
kernels.

The helper runs the path with the kernel's plain version in its place and,
at every decode layer of every step, holds the layer computed with the
stand-in against the layer computed with the plain version on the same
input. The plain version itself (and the wrapper, which takes it on CPU
tensors) reads exactly 0 and returns the plain replay's result; the plain
version with one bf16 ulp added to a few outputs reads above 0 and under
LAYER_RTOL; a stand-in with a 1/hd scale, or one that ignores the bias (the
mask), fails naming step 0, layer 0, and so does a verify stand-in that
gives every chunk query the bias row of position 0. The speculative
decoder's verify layers and plain paged decode layers share the paged
block; each kind counts only its own.
"""
import importlib.util
import math
import os
import time
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs.lisa_mini import CONFIG as JP
from repro.core.profile import random_init_system
from repro_torch.configs import get_lisa_config
from repro_torch.core import lut as tlut
from repro_torch.core.streams import DualStreamExecutor as TExecutor
from repro_torch.engine.speculative import SpeculativeConfig
from repro_torch.kernels.decode_attention import ops, ref
from repro_torch.models import attention, stack

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = get_lisa_config("lisa-mini")
L = TP.llm.num_layers


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load_chip_smoke()


@pytest.fixture(autouse=True)
def _host_clock():
    """chip_smoke's runs read the host clock after a device synchronise;
    on the CPU there is nothing to synchronise."""
    with mock.patch.object(cs, "_sync_s", time.perf_counter):
        yield


@pytest.fixture(scope="module")
def weights():
    params, bns, _ = random_init_system(JP, seed=0)
    return (jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, bns))


def _executor(weights, **kw):
    params, bns = weights
    return TExecutor(pcfg=TP, params=params, bottlenecks=bns,
                     lut=tlut.paper_lut(), flash_decode=True, device="cpu",
                     **kw)


@pytest.fixture(scope="module")
def served(weights):
    """The executor of phases 6 and 8 (4 new tokens, pages of 16), phase
    5's six edge-encoded requests, phase 8's frames and the executor of
    phase 9 (6 new tokens, pages of 4)."""
    ex = _executor(weights, max_new_tokens=cs.MAX_NEW_TOKENS)
    sx = _executor(weights, max_new_tokens=cs.SPEC_MAX_NEW_TOKENS,
                   page_size=cs.SPEC_PAGE)
    with mock.patch.object(cs, "_sync_s", time.perf_counter):
        return (ex, cs.edge_encode(ex, TP, 0), cs.inflight_requests(ex, TP, 0),
                sx)


def _run(kind, served):
    ex, reqs, frames, sx = served
    if kind == "decode":
        return lambda: cs.serve_requests(ex, reqs)
    if kind == "verify":        # phase 9's run A
        return lambda: cs.serve_spec(sx, frames,
                                     SpeculativeConfig(draft_tokens=3))
    return lambda: cs.serve_inflight(ex, frames)


def _outputs(kind, result):
    """Every request's (tokens, answer logits, mask logits) and the run's
    steps of the kind (decode steps, or verify steps)."""
    if kind == "verify":
        results, _, calls = result
        steps = calls["cloud_verify_rows"]
    else:
        results, runner = result
    if kind == "decode":
        arrs = [(r.tokens, r.answer_logits, r.mask_logits) for r in results]
        return arrs, runner.n_microbatches * cs.MAX_NEW_TOKENS
    if kind == "paged":
        steps = runner.n_steps
    return ([(r["tokens"], r["answer_logits"], r["mask_logits"])
             for r in results], steps)


KINDS = ["decode", "paged", "verify"]
NAMES = {"decode": ("decode_attention", ref.decode_attention_ref),
         "paged": ("paged_decode_attention", ref.paged_decode_attention_ref),
         "verify": ("paged_verify_attention", ref.paged_verify_attention_ref)}


def _nudged(plain):
    """The plain version with one bf16 ulp added to every 97th output."""
    def fn(q, *rest):
        o = plain(q, *rest).contiguous()
        flat = o.view(-1)
        idx = torch.arange(0, flat.numel(), 97)
        flat[idx] += 2.0 ** (torch.floor(torch.log2(flat[idx].abs())) - 7)
        return o
    return fn


def _wrong_scale(plain):
    def fn(q, *rest):
        return plain(q / math.sqrt(q.shape[-1]), *rest)
    return fn


def _no_mask(plain):
    def fn(*args):
        return plain(*args[:-1], torch.zeros_like(args[-1]))
    return fn


def _first_bias_row(plain):
    """Every chunk query of a verify call given the bias row of position 0:
    causal-within-chunk dropped, the fault of a body that shares one bias
    row across its query set."""
    def fn(*args):
        bias = args[-1]
        return plain(*args[:-1], bias[:, :1].expand_as(bias).contiguous())
    return fn


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kernel", ["wrapper", "plain"])
def test_plain_stand_in_reads_zero(served, kind, kernel):
    name, plain = NAMES[kind]
    stand_in = None if kernel == "wrapper" else plain
    got, summary = cs.layer_check(kind, "test", _run(kind, served),
                                  stand_in)
    outs, steps = _outputs(kind, got)
    assert steps > 0
    assert summary["layers"] == steps * L
    assert summary["steps"] == steps
    assert summary["worst"]["h"] == 0.0 and summary["worst"]["out"] == 0.0
    assert summary["per_step_max"] == [0.0] * steps
    assert summary["outputs_not_bit_equal"] == 0
    # what the run returns is the plain replay's result
    with mock.patch.object(ops, name, plain):
        want, _ = _outputs(kind, _run(kind, served)())
    for a, b in zip(outs, want):
        for x, y in zip(a, b):
            assert (x is None and y is None) or np.array_equal(x, y)


@pytest.mark.parametrize("kind", KINDS)
def test_one_ulp_off_is_within_limit(served, kind):
    _, plain = NAMES[kind]
    _, summary = cs.layer_check(kind, "test", _run(kind, served),
                                _nudged(plain))
    worst = summary["worst"]
    assert 0.0 < max(worst["h"], worst["out"]) < cs.LAYER_RTOL
    assert all(0.0 < m < cs.LAYER_RTOL for m in summary["per_step_max"])
    assert summary["outputs_not_bit_equal"] == summary["layers"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("wrong", [_wrong_scale, _no_mask],
                         ids=["scale_1_over_hd", "ignores_bias"])
def test_wrong_kernel_fails_at_first_layer(served, kind, wrong):
    _, plain = NAMES[kind]
    with pytest.raises(AssertionError, match=r": step 0 layer 0 "):
        cs.layer_check(kind, "test", _run(kind, served), wrong(plain))


def test_kernel_call_reads_the_pages_the_plain_call_read(served):
    """A verify layer's pad entries all target the trash page, several to
    one slot, and an idle row attends that page; the card resolves a write
    with duplicate indices in no fixed order, so the layer's second run
    could leave other values there than the first. Emulated by applying
    every other pool write's entries one at a time in reverse order (of
    two entries for one slot, the first now lands last): the pool write
    gives the entries of one slot one row (``attention.write_pool``), so
    the order cannot matter, and the plain version as the kernel reads
    exactly 0 with no pages handed back to the kernel's call."""
    put = attention._put
    writes = []

    def any_order(pool_t, page, off, rows):
        writes.append(1)
        if len(writes) % 4 in (1, 2):       # the k and v of one write
            return put(pool_t, page, off, rows)
        for i in reversed(range(page.numel())):
            put(pool_t, page[i:i + 1], off[i:i + 1], rows[i:i + 1])

    with mock.patch.object(attention, "_put", any_order):
        (_, _, steps), summary = cs.layer_check(
            "verify", "test", _run("verify", served),
            ref.paged_verify_attention_ref)
    assert len(writes) >= 4 * steps["cloud_verify_rows"] * L
    assert summary["worst"]["h"] == 0.0 and summary["worst"]["out"] == 0.0
    assert summary["outputs_not_bit_equal"] == 0


def test_verify_with_one_bias_row_fails_at_first_layer(served):
    """A verify kernel that reads one bias row for all chunk queries (as
    the decode kernels share one) lets a query see the chunk tokens after
    it; the check fails at the first verify step's first layer."""
    with pytest.raises(AssertionError, match=r": step 0 layer 0 "):
        cs.layer_check("verify", "test", _run("verify", served),
                       _first_bias_row(ref.paged_verify_attention_ref))


def test_verify_layers_are_not_counted(served):
    """Phase 9's run A on lisa_mini (shared-weights draft, 3 drafts, pages
    of 4): only the plain steps' layers are checked, though every verify
    step runs the same paged block."""
    _, _, frames, sx = served
    verify_passes = []
    group = stack.group_verify_paged

    def counted(*a, **kw):
        verify_passes.append(1)
        return group(*a, **kw)

    with mock.patch.object(stack, "group_verify_paged", counted):
        (_, _, calls), summary = cs.layer_check(
            "paged", "test",
            lambda: cs.serve_spec(sx, frames,
                                  SpeculativeConfig(draft_tokens=3)))
    assert calls["cloud_verify_rows"] > 0 and calls["cloud_decode_rows"] > 0
    assert len(verify_passes) == calls["cloud_verify_rows"]
    assert summary["steps"] == calls["cloud_decode_rows"]
    assert summary["layers"] == calls["cloud_decode_rows"] * L


def test_paged_layers_are_not_counted_as_verify(served):
    """The same run under the "verify" kind: only the verify steps' layers
    are checked, though every plain step runs the same paged block."""
    paged_passes = []
    group = stack.group_decode_paged

    def counted(*a, **kw):
        paged_passes.append(1)
        return group(*a, **kw)

    with mock.patch.object(stack, "group_decode_paged", counted):
        (_, _, calls), summary = cs.layer_check("verify", "test",
                                                _run("verify", served))
    assert calls["cloud_verify_rows"] > 0 and calls["cloud_decode_rows"] > 0
    assert len(paged_passes) == calls["cloud_decode_rows"]
    assert summary["steps"] == calls["cloud_verify_rows"]
    assert summary["layers"] == calls["cloud_verify_rows"] * L


@pytest.mark.parametrize("kind", ["paged", "verify"])
def test_pool_write_cost_replays_both_writes(served, kind):
    """Phases 8 and 9 time one captured paged step with the shipped pool
    write and with a direct write of each entry's own row, in turns: each
    turn replays the step once with each, and only the shipped turns reach
    ``attention.write_pool`` (a layer each)."""
    ex, _, _, sx = served
    executor, stage = ((sx, "cloud_verify_rows") if kind == "verify"
                       else (ex, "cloud_decode_rows"))
    with cs.captured(executor, stage) as calls:
        _run(kind, served)()
    writes = []
    write = attention.write_pool

    def counted(*a):
        writes.append(1)
        return write(*a)

    with mock.patch.object(cs, "POOL_WRITE_TURNS", 2), \
            mock.patch.object(attention, "write_pool", counted):
        out = cs.pool_write_cost(executor, stage, calls[-1], "test")
    assert len(writes) == 2 * L
    assert out["fixed_ms"] > 0 and out["direct_ms"] > 0
    assert len(out["direct_quartiles_ms"]) == 2
