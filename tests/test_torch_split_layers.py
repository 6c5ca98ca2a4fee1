"""The per-layer check of the split point, ``chip_smoke.layer_check`` with
the kind "split" (the bottleneck pair, ``bottleneck_encode`` and
``bottleneck_decode``), on the CPU: one Insight frame per tier of bridged
lisa_mini weights through ``chip_smoke``'s own phase-10c run
(``split_point``: SAM head, encode, the packet, decode, SAM tail, the LLM,
the mask), with stand-ins for the kernels.

The helper runs the frames with the pair's plain versions in the kernels'
place and, at every frame, holds the boundary activation the stand-ins
reconstruct from the SAM-head output, and the first SAM-tail block on it,
against the plain pair's. The plain versions themselves (and the wrappers,
which take them on CPU tensors) read exactly 0; a stand-in whose codes are
off by one in one entry reads above 0 and under LAYER_RTOL; a decode
stand-in that scales each token by another token's scale, or an encode
stand-in that projects with the transposed weight, fails naming frame 0.
"""
import importlib.util
import os
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
from repro_torch.kernels.bottleneck import ops as bops

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = get_lisa_config("lisa-mini")


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load_chip_smoke()


@pytest.fixture(scope="module")
def served():
    """An executor of bridged lisa_mini weights and one frame per tier."""
    params, bns, _ = random_init_system(JP, seed=0)
    ex = TExecutor(pcfg=TP, params=jax.tree.map(np.asarray, params),
                   bottlenecks=jax.tree.map(np.asarray, bns),
                   lut=tlut.paper_lut(), flash_decode=True, device="cpu",
                   max_new_tokens=cs.MAX_NEW_TOKENS)
    return ex, cs.split_frames(ex, TP, 0)


def _run(served):
    ex, frames = served
    return lambda: cs._split_run(ex, frames)


def _one_code_off(x, w):
    codes, scales = cs._plain_encode(x, w)
    codes = codes.clone()
    c = codes.view(-1)
    c[7] = c[7] + 1 if c[7] < 127 else c[7] - 1
    return codes, scales


def _scales_of_the_next_token(codes, scales, w, out_dtype=torch.float32):
    return cs._plain_decode(codes, scales.roll(1, dims=-2), w, out_dtype)


def _transposed_weight(x, w):
    """An encode that reads the (d, r) weight as if it were stored (r, d):
    the same bytes, the wrong layout."""
    return cs._plain_encode(x, w.t().contiguous().view(w.shape))


@pytest.mark.parametrize("kernels", ["wrappers", "plain"])
def test_plain_stand_in_reads_zero(served, kernels):
    pair = None if kernels == "wrappers" else (cs._plain_encode,
                                               cs._plain_decode)
    got, summary = cs.layer_check("split", "test", _run(served), pair)
    ex, frames = served
    assert len(summary["frames"]) == len(frames) == len(ex.lut.tiers)
    assert [f["rank"] for f in summary["frames"]] == [
        ex.bottlenecks[t.name]["enc"].shape[1] for t, *_ in frames]
    for f in summary["frames"]:
        assert f["boundary"] == 0.0 and f["block"] == 0.0
        assert f["codes_off"] == 0 and f["scales"] == 0.0
    # what the run returns is the plain replay's result
    with mock.patch.object(bops, "bottleneck_encode", cs._plain_encode), \
            mock.patch.object(bops, "bottleneck_decode", cs._plain_decode):
        want = _run(served)()
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)


def test_one_code_off_is_within_limit(served):
    _, summary = cs.layer_check("split", "test", _run(served),
                                (_one_code_off, cs._plain_decode))
    for f in summary["frames"]:
        assert f["codes_off"] == 1 and f["codes_max_diff"] == 1
        assert 0.0 < f["boundary"] < cs.LAYER_RTOL
        assert 0.0 < f["block"] < cs.LAYER_RTOL


@pytest.mark.parametrize("pair", [
    (cs._plain_encode, _scales_of_the_next_token),
    (_transposed_weight, cs._plain_decode)],
    ids=["scale_of_another_row", "w_transposed"])
def test_wrong_stand_in_fails_at_first_frame(served, pair):
    with pytest.raises(AssertionError, match=r": frame 0 \(rank "):
        cs.layer_check("split", "test", _run(served), pair)
