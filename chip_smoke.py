#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out PATH]
    python3 chip_smoke.py --kernel NAME [--kernel NAME ...]

Phases, each fatal on failure:
  1. report the card (name and power limit from nvidia-smi);
  2. build every CUDA kernel of the serving path from the sources in this
     checkout (nvcc, sm_90a; one nvcc per source, all started together) and
     report the build time and ptxas' register and spill lines;
  3. hold each kernel against its plain PyTorch version on the card, at
     the serving path's own shapes (once more with lengths spread from 1
     to W across rows) and at a small fp32 shape, and time the
     kernel, the plain version and one PyTorch library call for the same
     function (CUDA graphs of many launches, timed with CUDA events);
     then hold the attention the encoders and the plain paths take
     (``attention.sdpa_f32``: bf16 operands multiplied on the tensor cores
     with a float32 result) against its float32 upcast at SAM's, CLIP's
     and the LLM prefill's shapes, and time both;
  4. check the serving path on a small input: LISA-mini in fp32, the
     scheduler's tokens with the kernel equal those of the plain path;
  5. serve six mixed Context/Insight requests over two bottleneck tiers at
     the full width of LISA-7B (random bf16 weights from ``--seed``)
     through ``MicrobatchScheduler(generate=True)``, with every kernel
     launch counter set to 0 just before and read just after;
  6. serve the same requests again with every kernel launch held against
     the plain version on that launch's own inputs, once with the plain
     version in the kernel's place (every decode layer also computed with
     the kernel on the same input and held to LAYER_RTOL, ``layer_check``)
     and once through the plain attention path (``flash_decode=False``):
     tokens equal, logits and masks within stated bf16 limits;
  7. replay one Context and one Insight microbatch warm, time each, and
     trace one more run of each with ``torch.profiler``: device time by
     kernel and the device's idle share;
  8. (inflight) serve eight requests from two operators (six Context, two
     Insight over two tiers) through ``InflightDecoder(slots=4)`` over a
     paged, shared-prefix ``PagePool`` at the full width of LISA-7B, in
     waves between ``pump`` calls, with the launch counters set to 0 just
     before and read just after: the paged kernel must launch exactly
     once per layer and decode step. Then replay the schedule with every
     paged launch held against its plain version on that launch's own
     inputs, and with the plain version in the kernel's place (every
     paged decode layer also computed with the kernel on the same input
     and held to LAYER_RTOL, ``layer_check``), and hold
     each request against the one-shot ``cloud_generate_batch``; time one
     decode step, a prefix miss and a prefix hit, and trace one step.
  9. (spec) serve six requests from two operators through
     ``InflightDecoder(slots=4, spec=...)`` at the full width of LISA-7B, on
     an executor of 6 new tokens over pages of 4 slots that shares the
     serving weights: run A drafts with the serving weights (3 drafts, one
     request kept plain), run B with a divergent random draft (4 drafts;
     rejections and page rollback). Each run's launch counters start at 0:
     verify launches must be verify steps x layers, paged decode launches
     plain steps x layers, contiguous launches draft steps x layers. Both
     runs give the tokens of a spec=None decoder (answer logits bit-equal)
     and of the one-shot ``cloud_generate_batch``; a replay holds every
     verify launch against its plain version on its own inputs, another
     puts the plain version in the kernel's place (every verify layer also
     computed with the kernel on the same input and held to LAYER_RTOL,
     ``layer_check``); one speculative step is timed and one traced.
 10. (split) on an executor with ``llm.use_flash=True`` that shares the
     serving weights, each run's launch counters set to 0 just before it:
     (a) phase 5's requests through the microbatch scheduler: one flash
     launch per layer and microbatch, tokens equal to phase 5's, logits
     and masks within SDPA_PATH_RTOL of it; a replay with the flash
     kernel's plain version in its place, in which every prefill layer is
     also computed with the kernel on the same input and held to
     LAYER_RTOL (``layer_check``), and whose tokens, logits and
     masks are held to SDPA_PATH_RTOL; (b) phase
     8's schedule through ``InflightDecoder(slots=4)``: one flash launch
     per layer and prefix miss, phase 8's paged launches and tokens;
     (c) one Insight frame per tier through the split point with both
     switches on (SAM head, ``bn.encode(use_kernel=True)``, the packet,
     ``bn.decode(use_kernel=True)``, SAM tail, ``llm_generate``, mask):
     one encode and one decode launch per frame, every launch held
     against its plain version on its own inputs, and the mask logits
     against a replay with each kernel kind's plain version in its place,
     one kind at a time: flash (with the per-layer check of (a);
     SDPA_PATH_RTOL), then the bottleneck pair (PATH_RTOL; every frame's
     boundary activation from the kernels and the first SAM-tail block on
     it also held against the plain pair's on the same SAM-head output,
     LAYER_RTOL, ``layer_check`` kind "split"), each reading on its own
     line beside its limit; one frame's encode and decode timed.
 11. (zoo) LISA-7B freed, then the zoo's Mamba path at full width with
     random bf16 weights from ``--seed``, one config after the other:
     falcon-mamba-7b (64 Mamba-1 layers) and zamba2-7b (81 Mamba-2 layers
     in 9 hybrid groups behind one shared attention block), each with
     ``use_ssm_kernel=True``: (a) ``prefill_step`` on B = 2 prompts of
     1,024 tokens, counters from 0: one scan launch per Mamba layer and no
     other kernel, finite last logits; every launch held against
     ``scan_ref`` on its own inputs, the logits against a replay with
     ``scan_ref`` in the kernel's place (PATH_RTOL) and against
     ``use_ssm_kernel=False`` (SDPA_PATH_RTOL); (b) a 64-token prompt
     through ``decode_step`` from ``init_cache`` and 4 greedy tokens: no
     kernel launch, the logits at the prompt's last position against
     ``prefill_step``'s; (c, falcon-mamba-7b) ``SplitPlan(cfg, 32)``:
     32 + 32 launches, the hidden state equal to ``forward``'s; (e) a
     warm prefill and a decode step timed, one falcon-mamba-7b prefill
     traced.
 12. (engine, run before 11 frees LISA-7B) the ``AveryEngine`` front door
     on the serving weights, each run's launch counters set to 0 just
     before it: (a) ``batching="generate"``, AdaptivePolicy over a
     ``ChannelTransport`` on ``paper_trace(seed)``, two operators' sessions
     of different mission goals, six frames through ``session.submit``
     (prompts that classify as Context and as Insight, so both edge stages
     run on the card): contiguous decode launches equal to decode steps x
     layers and no other kernel; each request's intent, tier and transmit
     record printed; tokens equal to the one-shot ``cloud_generate_batch``
     on the packet its transport carried; (b) ``batching="inflight"``
     through a ``QoSScheduler``, the same frames and one more after a
     ``pump`` that joins the running batch: paged launches equal to decode
     steps x layers, tokens equal to the one-shot path's, a late join and
     a prefix hit; the reference's canonical in-flight scenario gives the
     ``stats()`` keys of ``tests/fixtures/engine_stats_keys.json``; (c)
     ``speculative=3`` on phase 9's executor: verify, paged and contiguous
     launches equal to verify, plain and draft steps x layers, tokens
     equal to ``speculative=None``'s but for at most MAX_TIES near ties
     (where a request's tokens first differ, each run's token leads its
     own logits for it on the same prefix, the two tokens' logits within
     TIE_ULPS bf16 steps between the runs and all of them within
     PATH_RTOL, the margin printed), ``SpecStats`` printed;
     (d) a
     ``FaultInjector`` blackout over one send and a ``FaultyExecutor``
     decode fault, each with a ``RetryPolicy``: the blacked-out request
     retried, downshifted and served, the fault's victims equal to their
     fault-free run, and the counters equal to ``FAULT_COUNTERS`` (what the
     reference's engine gives on the same schedules, tests/
     test_torch_engine.py); then the TTFT, transmit and decode-step
     medians of (b)'s ``stats()`` and warm ``engine.pump()`` calls on four
     live rows, each timed whole and around the bare
     ``InflightDecoder.step`` it makes, each beside the card's name and
     power limit.

Phase 3 holds the contiguous decode kernel at the serving path's shapes
(B = 1 and 4, lengths spread) and at the edges of its bf16 split-K design
(W = 1, 33 and 2,048; G = 4 and 12), and the paged kernels too: the
decode kernel at the three shapes of the reference's kernel test, at the
in-flight path's shape (B = 4 and one row of it), at one page a row and at
128 pages with three rows sharing 100, and at G = 4; every case of the two
decode kernels launched twice and bit-equal (deterministic). The
verify kernel at the three shapes of its reference test, one with more
than 8 queries per kv head, in bf16 with more than 8 and at hd = 64 and
32, and the speculative path's shapes (C = 4 and 5, pages of 4 and 16,
and C = 1 in bf16 and fp32 against the paged decode kernel); with rows
sharing prefix pages, ragged lengths, a plain row's pad queries, an idle
row parked on the trash page, and every page no table names filled with
NaN; every case launched twice and bit-equal. It holds the flash kernel
at the five shapes of the reference's test (causal and not, fp32 and
bf16), at the LLM prefill's (B = 1 and 4,
S = 204, bf16), once more with q, k and v as views of buffers whose
rows past S are NaN, and at long sequences: bf16 causal at 1,500 and
4,096 (SAM's token grid, LLaMA-7B's heads), bf16 at 1,000 (not causal,
NaN past S) and 777 (hd = 32), float32 at 3,000 (the online kernel, with
NaN past S); the bottleneck encode and decode kernels at the
reference test's shapes, at ranks wider than a cluster of column tiles,
at odd widths and ragged tiles, and at the split point's (one frame of
4096 tokens x 1280, the three tiers' ranks); and the scan kernel at the
reference test's four shapes, its 512-step long-decay case, a bf16 case
and the two zoo prefills' shapes, counting the elements that are not
bit-equal to ``scan_ref``'s.

The last lines are the card line, a ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``. Exits non-zero, before printing any
result, when no CUDA device is available or the port is not beside this
script.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,      # dense tensor-core peak
              torch.float32: 67e12}        # float32 outside tensor cores
L2_BYTES = 50 * 2 ** 20
QUERY_LEN = 8
MAX_NEW_TOKENS = 4
# (rtol, atol) of a kernel against its plain version on the same inputs.
# Both compute in float32 and round the output once to q's dtype, so in
# bf16 they may differ by one rounding of the output: 2**-7 relative
# (rtol 8e-3), plus atol for float32 summation order near zero.
TOL = {torch.bfloat16: (8e-3, 1e-3),
       torch.float32: (1e-4, 2e-5)}        # summation order only
# The LISA-7B outputs of the kernel path against the same path with the
# kernel's plain version in its place, as a norm-wise relative error
# ||a - b|| / ||b||. Each launch differs by at most one bf16 rounding of
# its output (2**-8); eight such roundings are allowed: 2**-5. It holds
# the decode, paged, verify, bottleneck and scan replays. Not the flash
# replays: random-weight layers grew a correct flash kernel's one
# rounding to 0.0384 there (PERF.md §6), so each prefill layer is
# held to LAYER_RTOL on its own input, and the replay's outputs to
# SDPA_PATH_RTOL.
PATH_RTOL = 2.0 ** -5
# The same against the flash_decode=False path, whose attention rounds the
# probabilities to bf16 before P.V (as the reference's does) where the
# kernel keeps them in float32: a bf16 rounding of every output element
# in every layer and step. Its measured spread on LISA-7B (PERF.md) set
# this limit, which guards against gross faults, not rounding; it also
# holds the plain-flash replays, which differ from the kernel path only
# in rounding.
SDPA_PATH_RTOL = 2.0 ** -3
# A prefill or decode layer with a kernel against the same layer with the
# kernel's plain version, on the same input (layer_check: the flash,
# contiguous and paged decode kernels): the attention block's output and
# the layer's output, each as a norm-wise relative error. Both compute in
# float32 and round the attention output once to bf16, so they may differ
# by one bf16 rounding: 2**-8. A wrong mask, scale or head mapping is O(1).
LAYER_RTOL = 2.0 ** -8
# attention.sdpa_f32 with bf16 operands on the tensor cores against the
# float32 upcast it replaced, norm-wise, on the same inputs (check_sdpa).
# Both products are exact, only their order of sums differs, but where the
# two routes' scores differ in the last float32 bit a bf16 rounding of P
# can flip: the outputs read 2.7e-05 to 3.3e-05 at SAM's shape on an H100.
# A route that rounds its P.V result to bf16 reads some 1e-3; check_sdpa
# requires that control to fail this limit.
SDPA_RTOL = 1e-4
# The bf16 flash kernel keeps the probabilities near float32 through P.V
# (p_hi + p_lo, two bf16 MMAs). On the timed bf16 cases its norm-wise error
# against attention_ref must be under this share of the error of
# attention_ref with P rounded once to bf16 (FlashAttention's P). A kernel
# that rounds P once reads about 0.8 of it (normalised by the float32 sum),
# one that keeps P in float32 about 0.01 (tests/test_torch_flash_layers.py).
P_SPLIT_RATIO = 0.25
REPLACES = {  # the TPU kernel each CUDA kernel replaces
    "decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:246",
    "paged_decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:66",
    "paged_verify_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:158",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:71",
    "bottleneck_encode": "src/repro/kernels/bottleneck/bottleneck.py:32",
    "bottleneck_decode": "src/repro/kernels/bottleneck/bottleneck.py:63",
    "ssm_scan": "src/repro/kernels/ssm_scan/ssm_scan.py:41",
}
# the in-flight phase: slots of the decoder, and eight requests from two
# operators in three waves: (operator, kind, frame). A frame number names
# one edge-encoded packet and query; uav-A sends frame 0 twice (a prefix
# hit). Between waves the decoder takes PUMPS[w] steps, then drains.
INFLIGHT_SLOTS = 4
INFLIGHT_WAVES = (
    (("uav-A", "context", 0), ("uav-B", "insight", 1),
     ("uav-A", "context", 2)),
    (("uav-A", "context", 0), ("uav-B", "context", 3),
     ("uav-A", "insight", 4)),
    (("uav-B", "context", 5), ("uav-A", "context", 6)),
)
PUMPS = (1, 2, 0)
# the spec phase: an executor of 6 new tokens over pages of 4 slots (draft
# overhangs cross pages, so rollback fires), and six requests from two
# operators over phase 8's frames in two waves: (operator, frame, drafts).
# uav-A sends frame 0 twice (a prefix hit, and a reuse of the draft's
# prefix row); uav-B's frame 3 rides the verify batches without drafting.
# One step between the waves, then drain.
SPEC_PAGE = 4
SPEC_MAX_NEW_TOKENS = 6
SPEC_WAVES = (
    (("uav-A", 0, True), ("uav-B", 1, True), ("uav-A", 0, True),
     ("uav-B", 3, False)),
    (("uav-A", 4, True), ("uav-B", 5, True)),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def device_ms(fn, arg_sets, reps: int = 10) -> float:
    """Device time of one call: a CUDA graph of one call per argument set
    (the sets rotate through more than the L2 cache, so each call finds its
    inputs cold, as the serving loop does), replayed ``reps`` times between
    two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a in arg_sets:
            fn(*a)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets))


def l2_cold_copies(args, nbytes):
    """``args`` and enough copies of it on the device that rotating
    through them moves twice the L2 cache's bytes, so that each timed call
    finds its inputs cold."""
    copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
    return [args] + [tuple(t.clone() for t in args)
                     for _ in range(copies - 1)]


def _sync_s() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


# ---------------------------------------------------------------------------
# phase 3: decode_attention against its plain version
# ---------------------------------------------------------------------------


def decode_inputs(rng, B, H, K, hd, W, dtype, lens, dev):
    q = torch.from_numpy(rng.randn(B, H, hd).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, W, K, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, W, K, hd).astype(np.float32))
    bias = np.zeros((B, W), np.float32)
    for i, n in enumerate(lens):
        bias[i, n:] = -1e30
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(bias).to(dev))


def held_against(name, out, want, tol=None):
    """Max abs error of a kernel's output against its plain version's;
    raises if it is not finite or beyond ``tol`` (default TOL for its
    dtype)."""
    rtol, atol = tol or TOL[want.dtype]
    err = (out.float() - want.float()).abs()
    max_err = float(err.max())
    excess = float((err - rtol * want.float().abs()).max())
    if not (torch.isfinite(out).all() and excess <= atol):
        raise AssertionError(f"{name}: max abs err {max_err:.3g} beyond "
                             f"rtol {rtol} atol {atol}")
    return max_err


def deterministic(name, launch, args, out):
    """One more launch on the same inputs must give the same bits."""
    again = launch(*args)
    torch.cuda.synchronize()
    if not torch.equal(again, out):
        raise AssertionError(f"{name}: two launches on the same inputs "
                             f"differ in {int((again != out).sum())} "
                             f"elements")
    return True


def check_decode_attention(rng, case, dev, timed):
    from repro_torch.kernels.decode_attention import ops, ref
    B, H, K, hd, W, dtype, lens = (case[k] for k in
                                   ("B", "H", "K", "hd", "W", "dtype",
                                    "lens"))
    args = decode_inputs(rng, B, H, K, hd, W, dtype, lens, dev)
    out = ops.decode_attention(*args)
    torch.cuda.synchronize()
    name = f"decode_attention {case['name']}"
    max_err = held_against(name, out, ref.decode_attention_ref(*args))
    rtol, atol = TOL[dtype]
    res = {
        "case": case["name"], "B": B, "H": H, "K": K, "hd": hd, "W": W,
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": max_err, "rtol": rtol, "atol": atol,
        "deterministic": deterministic(name, ops.decode_attention, args,
                                       out)}
    msg = (f"[kernel] decode_attention {case['name']}: B={B} H={H} K={K} "
           f"hd={hd} W={W} {res['dtype']} max_abs_err={max_err:.3g} "
           f"(rtol {rtol}, atol {atol}); a second launch bit-equal")
    if timed:
        es = torch.finfo(dtype).bits // 8
        nbytes = (2 * B * H * hd + 2 * B * W * K * hd) * es + B * W * 4
        flops = 4 * B * H * W * hd
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        sets = l2_cold_copies(args, nbytes)
        lib_sets = [(a.view(B, H, 1, hd), b.permute(0, 2, 1, 3),
                     c.permute(0, 2, 1, 3), m[:, None, None, :].to(dtype))
                    for a, b, c, m in sets]
        gqa = {"enable_gqa": True} if K != H else {}

        def library(qq, kk, vv, mm):
            return torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mm, **gqa)

        res.update({
            "ms": device_ms(ops.decode_attention, sets),
            "plain_ms": device_ms(ref.decode_attention_ref, sets),
            "library_ms": device_ms(library, lib_sets),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops})
        msg += (f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f}"
                f" library_ms={res['library_ms']:.4f} bound_ms="
                f"{res['bound_ms']:.4f} ({res['bound_by']})")
    log(msg)
    return res


DECODE_TIMED = ("main_B1", "main_B4")


def kernel_cases(pcfg, batches):
    """The serving path's decode shapes (every cloud_*_gen call decodes
    at W = clip_tokens + query_len + max_new_tokens), the largest of them
    once more with lengths spread from 1 to W across rows (so that a
    wrong mask shows at full width), and the fp32 shape of the CPU tests
    with a fully masked idle row beside a live row. Then the edges of the
    bf16 split-K kernel: W = 1 (one slot, a fully masked row beside live
    ones), W = 33 (a split that takes fewer slots than the others; G = 4,
    hd = 64), W = 2,048 with lengths spread from 1 to W, and G = 12 query
    heads a kv head (two head chunks; hd = 32)."""
    llm = pcfg.llm
    S = pcfg.clip_tokens + QUERY_LEN
    W = S + MAX_NEW_TOKENS
    cases = [dict(name=f"main_B{B}", B=B, H=llm.num_heads,
                  K=llm.num_kv_heads, hd=llm.resolved_head_dim, W=W,
                  dtype=llm.adtype,
                  lens=np.linspace(S + 1, W, B).astype(int).tolist())
             for B in batches]
    B = max(batches)
    main = cases[-1]
    cases.append(dict(main, name=f"main_B{B}_ragged",
                      lens=np.linspace(1, W, B).astype(int).tolist()))
    cases.append(dict(name="fp32_idle_row", B=2, H=4, K=2, hd=64, W=128,
                      dtype=torch.float32, lens=[0, 128]))
    cases.append(dict(main, name=f"W1_B{B}_idle_row", W=1,
                      lens=[0] + [1] * (B - 1)))
    cases.append(dict(name="W33_G4_hd64", B=3, H=16, K=4, hd=64, W=33,
                      dtype=llm.adtype, lens=[1, 17, 33]))
    cases.append(dict(main, name=f"W2048_B{B}_ragged", W=2048,
                      lens=np.linspace(1, 2048, B).astype(int).tolist()))
    cases.append(dict(name="W300_G12_hd32", B=2, H=24, K=2, hd=32, W=300,
                      dtype=llm.adtype, lens=[300, 150]))
    return cases


# ---------------------------------------------------------------------------
# phase 3: paged_decode_attention against its plain version
# ---------------------------------------------------------------------------


def paged_inputs(rng, case, dev):
    """q, k/v pools, page table and bias of one paged case. ``valid``
    (B, n*page) marks each row's attended slots; every pool page that no
    table names is NaN, so a kernel reading outside its table fails."""
    B, H, K, hd, P, page = (case[k] for k in ("B", "H", "K", "hd", "P",
                                              "page"))
    table, valid = case["table"], case["valid"]
    q = rng.randn(B, H, hd).astype(np.float32)
    kp = rng.randn(P, page, K, hd).astype(np.float32)
    vp = rng.randn(P, page, K, hd).astype(np.float32)
    unnamed = np.setdiff1d(np.arange(P), table)
    kp[unnamed] = np.nan
    vp[unnamed] = np.nan
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    dtype = case["dtype"]
    return (torch.from_numpy(q).to(dev, dtype),
            torch.from_numpy(kp).to(dev, dtype),
            torch.from_numpy(vp).to(dev, dtype),
            torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(bias).to(dev))


def paged_bytes_flops(case, es):
    """What the kernel must move and compute on these inputs: q, each
    distinct page a table names (k and v, read once however many rows
    share it), the tables, the bias and the output; 4 flops per
    (query head, slot, head-dim element)."""
    B, H, K, hd, page = (case[k] for k in ("B", "H", "K", "hd", "page"))
    table = case["table"]
    n = table.shape[1]
    pages = len(np.unique(table))
    nbytes = (2 * B * H * hd + 2 * pages * page * K * hd) * es \
        + B * n * page * 4 + B * n * 4
    return nbytes, 4 * B * H * n * page * hd


def check_paged_decode_attention(rng, case, dev, timed):
    from repro_torch.kernels.decode_attention import ops, ref
    args = paged_inputs(rng, case, dev)
    out = ops.paged_decode_attention(*args)
    torch.cuda.synchronize()
    want = ref.paged_decode_attention_ref(*args)
    name = f"paged_decode_attention {case['name']}"
    max_err = held_against(name, out, want)
    dtype = case["dtype"]
    rtol, atol = TOL[dtype]
    B, H, K, hd, page = (case[k] for k in ("B", "H", "K", "hd", "page"))
    n = case["table"].shape[1]
    res = {"case": case["name"], "B": B, "H": H, "K": K, "hd": hd,
           "P": case["P"], "page": page, "n": n,
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": max_err, "rtol": rtol, "atol": atol,
           "deterministic": deterministic(name, ops.paged_decode_attention,
                                          args, out)}
    msg = (f"[kernel] paged_decode_attention {case['name']}: B={B} H={H} "
           f"K={K} hd={hd} P={case['P']} page={page} n={n} {res['dtype']} "
           f"max_abs_err={max_err:.3g} (rtol {rtol}, atol {atol}); a second "
           f"launch bit-equal")
    if timed:
        nbytes, flops = paged_bytes_flops(case, torch.finfo(dtype).bits // 8)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[dtype]
        sets = l2_cold_copies(args, nbytes)
        gqa = {"enable_gqa": True} if K != H else {}

        def gather_sdpa(q, kp, vp, table, bias):
            # two library calls: the page gather, then SDPA
            idx = table.long()
            kg = kp[idx].reshape(B, n * page, K, hd).transpose(1, 2)
            vg = vp[idx].reshape(B, n * page, K, hd).transpose(1, 2)
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kg, vg,
                attn_mask=bias[:, None, None, :].to(q.dtype), **gqa)

        res.update({
            "ms": device_ms(ops.paged_decode_attention, sets),
            "plain_ms": device_ms(ref.paged_decode_attention_ref, sets),
            "gather_sdpa_ms": device_ms(gather_sdpa, sets),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "distinct_pages": int(len(np.unique(case["table"])))})
        msg += (f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f}"
                f" gather_sdpa_ms={res['gather_sdpa_ms']:.4f} bound_ms="
                f"{res['bound_ms']:.5f} ({res['bound_by']}, "
                f"{res['distinct_pages']} distinct pages)")
    log(msg)
    return res


def paged_cases(pcfg):
    """The three shapes of the reference's paged kernel test (fp32, random
    tables, ragged lengths), and the in-flight path's shape: B = slots,
    the LLM's heads, n = 13 prefix pages (clip tokens + query) + 1 private
    page. ``main``: the tables of a decode step, rows 0 and 1 sharing
    their prefix pages (one operator's repeated frame), each row at its
    own step, and its row 0 alone (``main_B1``); ``main_ragged_idle``:
    row 0 idle (every entry on the trash page 0, every slot masked), the
    others with lengths spread to n*page, rows 1 and 2 sharing pages; once
    in bf16, once in fp32. Then the edges of the bf16 split-K kernel: one
    page a row (n = 1), n = 128 pages with rows 0 to 2 sharing their first
    100 pages, and G = 4 at hd = 64 over pages of 8."""
    rng = np.random.RandomState(1)
    cases = []
    for B, H, K, hd, P, page, n in ((2, 4, 2, 64, 9, 16, 3),
                                    (1, 8, 8, 32, 5, 8, 4),
                                    (3, 4, 1, 128, 12, 32, 2)):
        table = rng.randint(0, P, (B, n))
        lens = np.linspace(page, n * page, B).astype(int)
        valid = np.arange(n * page)[None] < lens[:, None]
        cases.append(dict(name=f"fp32_B{B}_P{P}_page{page}", B=B, H=H, K=K,
                          hd=hd, P=P, page=page, table=table, valid=valid,
                          dtype=torch.float32))
    llm, page = pcfg.llm, 16
    prefix = pcfg.clip_tokens + QUERY_LEN
    n_pre = -(-prefix // page)
    n = n_pre + -(-MAX_NEW_TOKENS // page)
    B = INFLIGHT_SLOTS
    base = dict(B=B, H=llm.num_heads, K=llm.num_kv_heads,
                hd=llm.resolved_head_dim, page=page)
    # main: row r owns prefix pages (rows 0 and 1 share) + 1 private page
    pre = [list(range(1 + i * n_pre, 1 + (i + 1) * n_pre))
           for i in (0, 0, 1, 2)]
    private = 1 + 3 * n_pre + np.arange(B)
    table = np.array([p + [int(private[r])] for r, p in enumerate(pre)])
    valid = np.zeros((B, n * page), bool)
    valid[:, :prefix] = True
    for r in range(B):
        valid[r, n_pre * page:n_pre * page + r + 1] = True
    cases.append(dict(base, name=f"main_B{B}", P=int(table.max()) + 2,
                      table=table, valid=valid, dtype=llm.adtype))
    cases.append(dict(cases[-1], name="main_B1", B=1, table=table[:1],
                      valid=valid[:1]))
    # ragged + idle: lengths 1 .. n*page on rows 1..B-1
    table = np.zeros((B, n), int)
    table[1] = np.arange(1, n + 1)
    table[2] = np.concatenate([np.arange(1, n_pre + 1),
                               [n + 1]])        # shares row 1's prefix
    table[3] = np.arange(n + 2, 2 * n + 2)
    lens = np.linspace(1, n * page, B - 1).astype(int)
    valid = np.zeros((B, n * page), bool)
    valid[1:] = np.arange(n * page)[None] < lens[:, None]
    for dtype in (llm.adtype, torch.float32):
        cases.append(dict(base, name=f"main_B{B}_ragged_idle_"
                          f"{str(dtype).replace('torch.', '')}",
                          P=2 * n + 3, table=table, valid=valid,
                          dtype=dtype))
    # one page a row, lengths 1 .. page
    lens = np.linspace(1, page, B).astype(int)
    cases.append(dict(base, name=f"n1_B{B}", P=B + 2,
                      table=np.arange(1, B + 1)[:, None],
                      valid=np.arange(page)[None] < lens[:, None],
                      dtype=llm.adtype))
    # 128 pages: rows 0..2 share their first 100 pages
    n, shared = 128, 100
    own = n - shared
    table = np.zeros((B, n), int)
    for r in range(3):
        table[r, :shared] = np.arange(1, shared + 1)
        table[r, shared:] = 1 + shared + r * own + np.arange(own)
    table[3] = 1 + shared + 3 * own + np.arange(n)
    lens = np.array([n * page, 1700, shared * page + 1, 1000])
    cases.append(dict(base, name=f"n128_B{B}_shared100",
                      P=int(table.max()) + 2, table=table,
                      valid=np.arange(n * page)[None] < lens[:, None],
                      dtype=llm.adtype))
    # GQA: G = 4, hd = 64, pages of 8
    table = rng.randint(0, 12, (3, 5))
    lens = np.linspace(1, 40, 3).astype(int)
    cases.append(dict(name="G4_hd64_page8", B=3, H=16, K=4, hd=64, P=12,
                      page=8, table=table,
                      valid=np.arange(40)[None] < lens[:, None],
                      dtype=llm.adtype))
    return cases


# ---------------------------------------------------------------------------
# phase 3: paged_verify_attention against its plain version
# ---------------------------------------------------------------------------


def verify_inputs(rng, case, dev):
    """q (B,C,H,hd), k/v pools, page table and per-query bias of one verify
    case. ``valid`` (B, C, n*page) marks each query's attended slots; every
    pool page that no table names is NaN."""
    B, C, H, K, hd, P, page = (case[k] for k in ("B", "C", "H", "K", "hd",
                                                 "P", "page"))
    table, valid = case["table"], case["valid"]
    q = rng.randn(B, C, H, hd).astype(np.float32)
    kp = rng.randn(P, page, K, hd).astype(np.float32)
    vp = rng.randn(P, page, K, hd).astype(np.float32)
    unnamed = np.setdiff1d(np.arange(P), table)
    kp[unnamed] = np.nan
    vp[unnamed] = np.nan
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    dtype = case["dtype"]
    return (torch.from_numpy(q).to(dev, dtype),
            torch.from_numpy(kp).to(dev, dtype),
            torch.from_numpy(vp).to(dev, dtype),
            torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(bias).to(dev))


def verify_bytes_flops(case, es):
    """What the kernel must move and compute on these inputs: q and the
    output, each distinct page a table names (k and v, read once however
    many rows share it), the tables and the per-query bias; 4 flops per
    (query, head, slot, head-dim element)."""
    B, C, H, K, hd, page = (case[k] for k in ("B", "C", "H", "K", "hd",
                                              "page"))
    table = case["table"]
    n = table.shape[1]
    pages = len(np.unique(table))
    nbytes = (2 * B * C * H * hd + 2 * pages * page * K * hd) * es \
        + B * C * n * page * 4 + B * n * 4
    return nbytes, 4 * B * C * H * n * page * hd


def check_paged_verify_attention(rng, case, dev, timed):
    from repro_torch.kernels.decode_attention import ops, ref
    args = verify_inputs(rng, case, dev)
    out = ops.paged_verify_attention(*args)
    torch.cuda.synchronize()
    want = ref.paged_verify_attention_ref(*args)
    max_err = held_against(f"paged_verify_attention {case['name']}", out,
                           want)
    dtype = case["dtype"]
    rtol, atol = TOL[dtype]
    B, C, H, K, hd, page = (case[k] for k in ("B", "C", "H", "K", "hd",
                                              "page"))
    n = case["table"].shape[1]
    name = f"paged_verify_attention {case['name']}"
    res = {"case": case["name"], "B": B, "C": C, "H": H, "K": K, "hd": hd,
           "P": case["P"], "page": page, "n": n,
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": max_err, "rtol": rtol, "atol": atol,
           "deterministic": deterministic(name, ops.paged_verify_attention,
                                          args, out)}
    msg = (f"[kernel] paged_verify_attention {case['name']}: B={B} C={C} "
           f"H={H} K={K} hd={hd} P={case['P']} page={page} n={n} "
           f"{res['dtype']} max_abs_err={max_err:.3g} (rtol {rtol}, atol "
           f"{atol}); a second launch bit-equal")
    if C == 1:
        # column 0 of a C=1 call is the paged decode kernel's answer: in
        # float32 both kernels run flash_decode.cuh (to 1e-6), in bf16 both
        # run split_decode.cuh at other set sizes (within TOL)
        q, kp, vp, table, bias = args
        dec = ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, table,
                                         bias[:, 0].contiguous())
        torch.cuda.synchronize()
        diff = float((out[:, 0].float() - dec.float()).abs().max())
        if dtype == torch.float32 and not diff <= 1e-6:
            raise AssertionError(f"{name}: C=1 off the paged decode kernel "
                                 f"by {diff:.3g}, limit 1e-6")
        if dtype != torch.float32:
            held_against(f"{name} column 0 against the paged decode kernel",
                         out[:, 0], dec)
        res["max_abs_diff_paged_decode"] = diff
        msg += f"; column 0 vs the paged decode kernel {diff:.3g}"
    if timed:
        nbytes, flops = verify_bytes_flops(case, torch.finfo(dtype).bits // 8)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[dtype]
        sets = l2_cold_copies(args, nbytes)
        G = H // K

        def gather_sdpa(q, kp, vp, table, bias):
            # two library calls: the page gather, then SDPA with the
            # C queries of each kv head's G heads as its query rows
            idx = table.long()
            kg = kp[idx].reshape(B, n * page, K, hd).transpose(1, 2)
            vg = vp[idx].reshape(B, n * page, K, hd).transpose(1, 2)
            qg = q.reshape(B, C, K, G, hd).permute(0, 2, 3, 1, 4) \
                .reshape(B, K, G * C, hd)
            mask = bias[:, None, None].expand(B, 1, G, C, n * page) \
                .reshape(B, 1, G * C, n * page).to(q.dtype)
            return torch.nn.functional.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask)

        res.update({
            "ms": device_ms(ops.paged_verify_attention, sets),
            "plain_ms": device_ms(ref.paged_verify_attention_ref, sets),
            "gather_sdpa_ms": device_ms(gather_sdpa, sets),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "distinct_pages": int(len(np.unique(case["table"])))})
        msg += (f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f}"
                f" gather_sdpa_ms={res['gather_sdpa_ms']:.4f} bound_ms="
                f"{res['bound_ms']:.5f} ({res['bound_by']}, "
                f"{res['distinct_pages']} distinct pages)")
    log(msg)
    return res


def verify_cases(pcfg):
    """The three shapes of the reference's verify kernel test (fp32, random
    tables, per-query ragged lengths), one with G*C > 8 queries per kv
    head (split over CTAs), and the speculative path's shapes: B = slots,
    the LLM's heads, C = 4 and 5 (3 and 4 drafts), the 204-token prefix in
    51 pages of 4 slots + 2 private pages (phase 9's pages) or 13 pages of
    16 + 1. Rows 0 and 1 share their prefix pages and draft (each at its
    own step, causal within the chunk); row 2 is a plain row riding the
    batch, its chunk one real entry and pad queries; row 3 is idle (every
    entry on the trash page 0, every slot masked). Then C=1 in bf16 and
    fp32, each held also against the paged decode kernel. In bf16, the
    edges of the split-K body's query sets: G*C = 10 > 8 at hd = 128 (a
    kv head's queries over two clusters, sets of 8 and 2), C = 4 at
    hd = 64 and C = 5 at hd = 32 (more queries than lanes a row)."""
    rng = np.random.RandomState(2)
    cases = []
    for B, C, H, K, hd, P, page, n, dtype in (
            (2, 4, 4, 2, 64, 9, 16, 3, torch.float32),
            (1, 3, 8, 8, 32, 5, 8, 4, torch.float32),
            (3, 2, 4, 1, 128, 12, 32, 2, torch.float32),
            (2, 5, 8, 2, 64, 9, 16, 3, torch.float32),
            (3, 5, 8, 4, 128, 12, 16, 4, torch.bfloat16),
            (2, 4, 8, 8, 64, 9, 8, 6, torch.bfloat16),
            (3, 5, 8, 8, 32, 10, 8, 5, torch.bfloat16)):
        table = rng.randint(0, P, (B, n))
        lens = rng.randint(1, n * page + 1, (B, C))
        valid = np.arange(n * page)[None, None] < lens[..., None]
        dt = "fp32" if dtype == torch.float32 else "bf16"
        cases.append(dict(name=f"{dt}_B{B}_C{C}_G{H // K}_hd{hd}_page{page}",
                          B=B, C=C, H=H, K=K, hd=hd, P=P, page=page,
                          table=table, valid=valid, dtype=dtype))
    llm = pcfg.llm
    prefix = pcfg.clip_tokens + QUERY_LEN
    B = INFLIGHT_SLOTS
    for page, C, dtype in ((SPEC_PAGE, 4, llm.adtype),
                           (SPEC_PAGE, 5, llm.adtype),
                           (16, 4, llm.adtype), (SPEC_PAGE, 1, llm.adtype),
                           (16, 1, torch.float32)):
        n_pre = -(-prefix // page)
        n_priv = -(-SPEC_MAX_NEW_TOKENS // page)
        n = n_pre + n_priv
        base = n_pre * page
        pre = [list(range(1 + i * n_pre, 1 + (i + 1) * n_pre))
               for i in (0, 0, 1)]
        priv = 1 + 2 * n_pre + np.arange(3 * n_priv).reshape(3, n_priv)
        table = np.zeros((B, n), int)
        valid = np.zeros((B, C, n * page), bool)
        for r, done in enumerate((1, 2, 3)):     # tokens emitted so far
            table[r] = pre[r] + priv[r].tolist()
            valid[r, :, :prefix] = True
            for c in range(C):
                # chunk token c sits at slot base + done - 1 + c; row 2's
                # pad queries (c >= 1) see what its real entry sees
                last = base + done - 1 + (c if r < 2 else 0)
                valid[r, c, base:last + 1] = True
        name = (f"main_B{B}_C{C}_page{page}"
                + ("" if dtype == llm.adtype else "_fp32"))
        cases.append(dict(name=name, B=B, C=C, H=llm.num_heads,
                          K=llm.num_kv_heads, hd=llm.resolved_head_dim,
                          P=int(table.max()) + 3, page=page, table=table,
                          valid=valid, dtype=dtype))
    return cases


# ---------------------------------------------------------------------------
# phase 3: flash_attention against its plain version
# ---------------------------------------------------------------------------


def flash_inputs(rng, case, dev):
    """q (B,S,H,hd), k/v (B,S,K,hd). With ``pad`` each is a view of a
    (B, S + pad, heads, hd) buffer whose rows past S are NaN: a kernel that
    reads a key or query past S fails."""
    B, S, H, K, hd, pad, dtype = (case[k] for k in ("B", "S", "H", "K", "hd",
                                                    "pad", "dtype"))

    def buf(heads):
        a = rng.randn(B, S + pad, heads, hd).astype(np.float32)
        a[:, S:] = np.nan
        return torch.from_numpy(a).to(dev, dtype)[:, :S]

    return buf(H), buf(K), buf(K)


def flash_bytes_flops(case, es):
    """q, k, v read once and the output written once; 4 flops per (query
    head, attended key, head-dim element), the causal triangle only when
    causal."""
    B, S, H, K, hd = (case[k] for k in ("B", "S", "H", "K", "hd"))
    pairs = S * (S + 1) // 2 if case["causal"] else S * S
    return (2 * B * S * H * hd + 2 * B * S * K * hd) * es, \
        4 * B * H * hd * pairs


def attention_p_bf16(q, k, v, causal=True):
    """``attention_ref`` with the probabilities rounded to bf16 before P.V,
    as one bf16 P in the P.V MMA would have them."""
    from repro_torch.kernels.flash_attention.ref import NEG_INF
    B, S, H, hd = q.shape
    K = k.shape[2]
    scores = torch.einsum("bskgh,btkh->bkgst",
                          q.reshape(B, S, K, H // K, hd).float(),
                          k.float()) / math.sqrt(hd)
    if causal:
        above = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(above, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16).float()
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def p_split_reading(out, want, q, k, v, causal):
    """How near ``out`` keeps P to float32: its norm-wise error against
    ``want`` (attention_ref), the error of ``attention_p_bf16`` against the
    same, and their ratio, which must be under P_SPLIT_RATIO."""
    err = _rel(out, want)
    err_p = _rel(attention_p_bf16(q, k, v, causal), want)
    return {"rel_err": err, "rel_err_p_bf16": err_p, "ratio": err / err_p,
            "limit": P_SPLIT_RATIO}


def check_flash_attention(rng, case, dev, timed):
    from repro_torch.kernels.flash_attention import ops, ref
    causal = case["causal"]
    args = flash_inputs(rng, case, dev)
    out = ops.flash_attention(*args, causal=causal)
    torch.cuda.synchronize()
    want = ref.attention_ref(*args, causal=causal)
    max_err = held_against(f"flash_attention {case['name']}", out, want)
    dtype = case["dtype"]
    rtol, atol = TOL[dtype]
    B, S, H, K, hd = (case[k] for k in ("B", "S", "H", "K", "hd"))
    res = {"case": case["name"], "B": B, "S": S, "H": H, "K": K, "hd": hd,
           "causal": causal, "nan_past_S": case["pad"] > 0,
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": max_err, "rtol": rtol, "atol": atol}
    msg = (f"[kernel] flash_attention {case['name']}: B={B} S={S} H={H} "
           f"K={K} hd={hd} causal={causal} {res['dtype']} max_abs_err="
           f"{max_err:.3g} (rtol {rtol}, atol {atol})")
    if timed:
        nbytes, flops = flash_bytes_flops(case, torch.finfo(dtype).bits // 8)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
        sets = [args] + [flash_inputs(rng, case, dev)
                         for _ in range(copies - 1)]
        gqa = {"enable_gqa": True} if K != H else {}

        def library(q, k, v):
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, **gqa)

        res.update({
            "ms": device_ms(lambda q, k, v: ops.flash_attention(
                q, k, v, causal=causal), sets),
            "plain_ms": device_ms(lambda q, k, v: ref.attention_ref(
                q, k, v, causal=causal), sets),
            "library_ms": device_ms(library, sets),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops})
        msg += (f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f}"
                f" library_ms={res['library_ms']:.4f} bound_ms="
                f"{res['bound_ms']:.5f} ({res['bound_by']})")
        if dtype == torch.bfloat16:
            p = res["p_split"] = p_split_reading(out, want, *args, causal)
            msg += (f"; P near float32: norm-wise err {p['rel_err']:.3g}, "
                    f"with P rounded to bf16 {p['rel_err_p_bf16']:.3g}, "
                    f"ratio {p['ratio']:.3g} (limit {P_SPLIT_RATIO})")
    log(msg)
    if "p_split" in res and not res["p_split"]["ratio"] < P_SPLIT_RATIO:
        raise AssertionError(f"flash_attention {case['name']}: the kernel "
                             f"keeps P no nearer float32 than P_SPLIT_RATIO "
                             f"of one bf16 P's error: {res['p_split']}")
    return res


# the flash cases that are timed: the prefill's two shapes and the long
# sequences
FLASH_TIMED = ("main_B1", "main_B4", "bf16_B1_S1500_G2_hd128_causal",
               "bf16_B1_S4096_G1_hd128_causal")


def flash_cases(pcfg):
    """The five shapes of the reference's flash test, causal and not, in
    fp32 and bf16; the LLM prefill's shapes (B = 1 and 4, S = clip tokens
    + query, bf16, causal); the B = 4 prefill once more with q, k and v as
    views of buffers whose rows past S are NaN; and long sequences: bf16
    causal at S = 1,500 and 4,096, bf16 not causal at 1,000 (with NaN past
    S) and causal at 777 (hd = 32), float32 at 3,000 with NaN past S."""
    cases = []
    for B, S, H, K, hd in ((2, 128, 4, 2, 64), (1, 200, 4, 4, 32),
                           (2, 64, 8, 2, 64), (1, 256, 4, 1, 128),
                           (1, 96, 6, 3, 32)):
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                cases.append(dict(
                    name=f"{str(dtype).replace('torch.', '')}_B{B}_S{S}_G"
                         f"{H // K}_hd{hd}_{'causal' if causal else 'full'}",
                    B=B, S=S, H=H, K=K, hd=hd, causal=causal, dtype=dtype,
                    pad=0))
    llm = pcfg.llm
    for B in (1, 4):
        cases.append(dict(name=f"main_B{B}", B=B,
                          S=pcfg.clip_tokens + QUERY_LEN, H=llm.num_heads,
                          K=llm.num_kv_heads, hd=llm.resolved_head_dim,
                          causal=True, dtype=llm.adtype, pad=0))
    cases.append(dict(cases[-1], name="main_B4_nan_past_S", pad=52))
    # long sequences: bf16 causal at S = 1,500 and at SAM's token grid
    # (4,096, LLaMA-7B's heads), float32 not causal with NaN past S
    cases.append(dict(name="bf16_B1_S1500_G2_hd128_causal", B=1, S=1500,
                      H=4, K=2, hd=128, causal=True, dtype=torch.bfloat16,
                      pad=0))
    cases.append(dict(name="bf16_B1_S4096_G1_hd128_causal", B=1, S=4096,
                      H=llm.num_heads, K=llm.num_kv_heads,
                      hd=llm.resolved_head_dim, causal=True,
                      dtype=torch.bfloat16, pad=0))
    # bf16 not causal with NaN past S at hd = 64, and causal at hd = 32
    # with an odd S
    cases.append(dict(name="bf16_B2_S1000_G2_hd64_full", B=2, S=1000, H=8,
                      K=4, hd=64, causal=False, dtype=torch.bfloat16,
                      pad=24))
    cases.append(dict(name="bf16_B1_S777_G4_hd32_causal", B=1, S=777, H=4,
                      K=1, hd=32, causal=True, dtype=torch.bfloat16, pad=0))
    cases.append(dict(name="float32_B2_S3000_G4_hd64_full_online", B=2,
                      S=3000, H=8, K=2, hd=64, causal=False,
                      dtype=torch.float32, pad=40))
    return cases


# ---------------------------------------------------------------------------
# phase 3: bottleneck_encode / bottleneck_decode against their plain versions
# ---------------------------------------------------------------------------

# encode: scales in float32 to summation order (the reference's test);
# codes within 1 where a sum order moves z / s across a .5 tie, on fewer
# than CODES_OFF_FRAC of entries
SCALES_TOL = (1e-5, 1e-7)
CODES_OFF_FRAC = 1e-3
# decode: the output rounded once to bf16, or float32 summation order over
# the rank (the reference's own test)
DECODE_TOL = {torch.bfloat16: (8e-3, 1e-3), torch.float32: (1e-5, 1e-4)}


def codes_held_against(name, codes, scales, want_codes, want_scales):
    """Encode output against the plain version's: scales within
    SCALES_TOL, codes within 1 on fewer than CODES_OFF_FRAC of entries.
    Returns (max code difference, fraction of codes off, max scale
    error)."""
    s_err = held_against(f"{name} scales", scales, want_scales, SCALES_TOL)
    diff = (codes.int() - want_codes.int()).abs()
    max_diff = int(diff.max())
    off = float((diff > 0).float().mean())
    if codes.dtype != torch.int8 or max_diff > 1 or off >= CODES_OFF_FRAC:
        raise AssertionError(f"{name}: codes {codes.dtype} off the plain "
                             f"version by up to {max_diff} on {off:.3g} of "
                             f"entries (limit 1 on < {CODES_OFF_FRAC})")
    return max_diff, off, s_err


def encode_inputs(rng, case, dev):
    x = rng.randn(*case["lead"], case["d"]).astype(np.float32)
    w = (rng.randn(case["d"], case["r"]) * case["w_scale"]).astype(np.float32)
    return (torch.from_numpy(x).to(dev, case["x_dtype"]),
            torch.from_numpy(w).to(dev, case["w_dtype"]))


def decode_inputs_bn(rng, case, dev):
    codes = rng.randint(-127, 128, (*case["lead"], case["r"])).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, (*case["lead"], 1)).astype(np.float32)
    w = (rng.randn(case["r"], case["d"]) * case["w_scale"]).astype(np.float32)
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(scales).to(dev),
            torch.from_numpy(w).to(dev, case["w_dtype"]))


def bottleneck_cases(pcfg, ranks):
    """Encode: the four shapes of the reference's test in fp32 and bf16
    (x and w of one dtype), its batched (2, 37, 64) -> 16, two ranks wider
    than a cluster of column tiles, odd widths, and the split
    point's shapes: one frame's SAM boundary (1, 4096, 1280) in bf16 with
    the float32 weight of each tier's rank. Decode: the reference's two
    shapes with fp32 and bf16 weights into fp32, its batched shape, ragged
    tiles, an odd rank, and the split point's (codes of each rank back to
    1280, bf16 out)."""
    enc, dec = [], []
    for T, d, r in ((128, 128, 32), (64, 256, 100), (100, 64, 16),
                    (256, 1280, 638)):
        for dt in (torch.float32, torch.bfloat16):
            enc.append(dict(name=f"{str(dt).replace('torch.', '')}_T{T}_d{d}"
                                 f"_r{r}", lead=(T,), d=d, r=r, x_dtype=dt,
                            w_dtype=dt, w_scale=0.05))
    enc.append(dict(name="batched_2x37_d64_r16", lead=(2, 37), d=64, r=16,
                    x_dtype=torch.float32, w_dtype=torch.float32,
                    w_scale=0.1))
    # ranks wider than a cluster of 8 column tiles: every CTA walks two
    # (14 tiles), or all but the last (9 tiles); a ragged token tile
    enc.append(dict(name="float32_T40_d64_r3500_walk", lead=(40,), d=64,
                    r=3500, x_dtype=torch.float32, w_dtype=torch.float32,
                    w_scale=0.1))
    enc.append(dict(name="bfloat16_T300_d256_r2100_walk", lead=(300,),
                    d=256, r=2100, x_dtype=torch.bfloat16,
                    w_dtype=torch.float32, w_scale=0.0625))
    # odd widths: x's rows and the codes' rows not in pairs
    for wdt in (torch.float32, torch.bfloat16):
        enc.append(dict(name=f"bfloat16_T33_d63_r37_w{str(wdt)[6:]}",
                        lead=(33,), d=63, r=37, x_dtype=torch.bfloat16,
                        w_dtype=wdt, w_scale=0.125))
    for T, d, r in ((128, 128, 32), (64, 256, 100)):
        for dt in (torch.float32, torch.bfloat16):
            dec.append(dict(name=f"w{str(dt).replace('torch.', '')}_T{T}_r{r}"
                                 f"_d{d}", lead=(T,), d=d, r=r, w_dtype=dt,
                            out_dtype=torch.float32, w_scale=0.05))
    dec.append(dict(name="batched_2x37_r16_d64", lead=(2, 37), d=64, r=16,
                    w_dtype=torch.float32, out_dtype=torch.float32,
                    w_scale=0.1))
    # a ragged column tile and token tile; odd rank (codes not in pairs)
    dec.append(dict(name="wfloat32_T300_r1278_d1000", lead=(300,), d=1000,
                    r=1278, w_dtype=torch.float32,
                    out_dtype=torch.bfloat16, w_scale=1278 ** -0.5))
    dec.append(dict(name="wbfloat16_T50_r37_d96", lead=(50,), d=96, r=37,
                    w_dtype=torch.bfloat16, out_dtype=torch.float32,
                    w_scale=0.125))
    d, T = pcfg.sam.d_model, pcfg.sam_tokens
    for r in ranks:
        enc.append(dict(name=f"main_r{r}", lead=(1, T), d=d, r=r,
                        x_dtype=pcfg.sam.adtype, w_dtype=torch.float32,
                        w_scale=d ** -0.5))
        dec.append(dict(name=f"main_r{r}", lead=(1, T), d=d, r=r,
                        w_dtype=torch.float32, out_dtype=pcfg.sam.adtype,
                        w_scale=r ** -0.5))
    return enc, dec


def _bn_bound(nbytes, flops, products):
    """Least time for these bytes and the products the kernel takes on the
    tensor cores: ``products`` bf16 products of ``flops`` operations each
    (ops.tensor_core_products), at the peak of ops.PRODUCT_DTYPE. Beside it
    the float32 bound of the same function on the CUDA cores (the first
    design's), as a yardstick."""
    from repro_torch.kernels.bottleneck import ops
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = products * flops / PEAK_FLOPS[ops.PRODUCT_DTYPE]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": products * flops,
            "products": products,
            "f32_bound_ms": 1e3 * max(t_bytes,
                                      flops / PEAK_FLOPS[torch.float32])}


def check_bottleneck_encode(rng, case, dev, timed):
    from repro_torch.kernels.bottleneck import ops, ref
    x, w = encode_inputs(rng, case, dev)
    codes, scales = ops.bottleneck_encode(x, w)
    torch.cuda.synchronize()
    d, r = case["d"], case["r"]
    want_c, want_s = ref.encode_ref(x.reshape(-1, d), w)
    if tuple(codes.shape) != (*case["lead"], r) or \
            tuple(scales.shape) != (*case["lead"], 1):
        raise AssertionError(f"bottleneck_encode {case['name']}: shapes "
                             f"{tuple(codes.shape)}, {tuple(scales.shape)}")
    max_diff, off, s_err = codes_held_against(
        f"bottleneck_encode {case['name']}", codes.reshape(-1, r),
        scales.reshape(-1, 1), want_c, want_s)
    T = int(np.prod(case["lead"]))
    res = {"case": case["name"], "T": T, "d": d, "r": r,
           "x_dtype": str(case["x_dtype"]).replace("torch.", ""),
           "w_dtype": str(case["w_dtype"]).replace("torch.", ""),
           "max_abs_err": max_diff, "codes_off_frac": off,
           "scales_max_abs_err": s_err}
    msg = (f"[kernel] bottleneck_encode {case['name']}: T={T} d={d} r={r} "
           f"x {res['x_dtype']} w {res['w_dtype']}: codes off by <= "
           f"{max_diff} on {off:.3g} of entries (limit 1 on < "
           f"{CODES_OFF_FRAC}); scales max abs err {s_err:.3g} (rtol "
           f"{SCALES_TOL[0]}, atol {SCALES_TOL[1]})")
    if timed:
        nbytes = x.numel() * x.element_size() + w.numel() * w.element_size() \
            + T * r + T * 4
        res.update(_bn_bound(nbytes, 2 * T * d * r, ops.tensor_core_products(
            x.dtype, w.dtype)))
        copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
        sets = [(x, w)] + [encode_inputs(rng, case, dev)
                           for _ in range(copies - 1)]

        def matmul_quant(xx, ww):
            # ten library calls: cast, matmul, abs, amax, div, add, div,
            # round, clamp, cast
            z = torch.matmul(xx.float(), ww)
            s = torch.amax(torch.abs(z), dim=-1, keepdim=True) / 127.0 + 1e-8
            return torch.clamp(torch.round(z / s), -127, 127).to(torch.int8), s

        res.update({
            "ms": device_ms(ops.bottleneck_encode, sets),
            "plain_ms": device_ms(
                lambda xx, ww: ref.encode_ref(xx.reshape(-1, d), ww), sets),
            "matmul_quant_ms": device_ms(matmul_quant, sets),
            "matmul_quant_calls": 10})
        msg += (f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f}"
                f" matmul_quant_ms={res['matmul_quant_ms']:.4f} (10 calls)"
                f" bound_ms={res['bound_ms']:.4f} ({res['bound_by']}, "
                f"{res['products']} bf16 products; float32 "
                f"{res['f32_bound_ms']:.4f})")
    log(msg)
    return res


def check_bottleneck_decode(rng, case, dev, timed):
    from repro_torch.kernels.bottleneck import ops, ref
    codes, scales, w = decode_inputs_bn(rng, case, dev)
    out_dtype = case["out_dtype"]
    out = ops.bottleneck_decode(codes, scales, w, out_dtype)
    torch.cuda.synchronize()
    d, r = case["d"], case["r"]
    want = ref.decode_ref(codes.reshape(-1, r), scales.reshape(-1, 1), w,
                          out_dtype)
    if tuple(out.shape) != (*case["lead"], d) or out.dtype != out_dtype:
        raise AssertionError(f"bottleneck_decode {case['name']}: "
                             f"{out.dtype} {tuple(out.shape)}")
    tol = DECODE_TOL[out_dtype]
    max_err = held_against(f"bottleneck_decode {case['name']}",
                           out.reshape(-1, d), want, tol)
    T = int(np.prod(case["lead"]))
    res = {"case": case["name"], "T": T, "r": r, "d": d,
           "w_dtype": str(case["w_dtype"]).replace("torch.", ""),
           "out_dtype": str(out_dtype).replace("torch.", ""),
           "max_abs_err": max_err, "rtol": tol[0], "atol": tol[1]}
    msg = (f"[kernel] bottleneck_decode {case['name']}: T={T} r={r} d={d} "
           f"w {res['w_dtype']} -> {res['out_dtype']} max_abs_err="
           f"{max_err:.3g} (rtol {tol[0]}, atol {tol[1]})")
    if timed:
        nbytes = T * r + T * 4 + w.numel() * w.element_size() \
            + T * d * out.element_size()
        res.update(_bn_bound(nbytes, 2 * T * r * d, ops.tensor_core_products(
            codes.dtype, w.dtype)))
        copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
        sets = [(codes, scales, w)] + [decode_inputs_bn(rng, case, dev)
                                       for _ in range(copies - 1)]

        def dequant_matmul(c, s, ww):
            # four library calls: cast, mul, matmul, cast
            return torch.matmul(c.float() * s, ww).to(out_dtype)

        res.update({
            "ms": device_ms(lambda c, s, ww: ops.bottleneck_decode(
                c, s, ww, out_dtype), sets),
            "plain_ms": device_ms(lambda c, s, ww: ref.decode_ref(
                c.reshape(-1, r), s.reshape(-1, 1), ww, out_dtype), sets),
            "dequant_matmul_ms": device_ms(dequant_matmul, sets),
            "dequant_matmul_calls": 4})
        msg += (f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f}"
                f" dequant_matmul_ms={res['dequant_matmul_ms']:.4f} (4 calls)"
                f" bound_ms={res['bound_ms']:.4f} ({res['bound_by']}, "
                f"{res['products']} bf16 products; float32 "
                f"{res['f32_bound_ms']:.4f})")
    log(msg)
    return res


# ---------------------------------------------------------------------------
# the encoders' and plain paths' attention (models/attention.py:sdpa_f32)
# ---------------------------------------------------------------------------


def sdpa_upcast_f32(q, k, v, mask, scale):
    """``attention.sdpa_f32`` as it was before it multiplied bf16 operands
    on the tensor cores: float32 copies of q, k, v and the bf16
    probabilities, multiplied in float32 (TF32 off). The yardstick of
    ``check_sdpa``."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    scores = scores + mask.reshape(mask.shape[0], 1, 1, *mask.shape[1:])
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, S, H, hd)


def sdpa_cases(pcfg):
    """The three shapes that reach ``_sdpa`` on the served paths: SAM's
    global attention over one frame's token grid, CLIP's over a Context
    microbatch of 4, and the LLM prefill of the plain path
    (``use_flash=False``) at B = 4, causal."""
    sam, clip, llm = pcfg.sam, pcfg.clip, pcfg.llm
    return [
        dict(name="sam_B1", B=1, S=pcfg.sam_tokens, H=sam.num_heads,
             K=sam.num_kv_heads, hd=sam.resolved_head_dim, causal=False),
        dict(name="clip_B4", B=4, S=pcfg.clip_tokens, H=clip.num_heads,
             K=clip.num_kv_heads, hd=clip.resolved_head_dim, causal=False),
        dict(name="llm_prefill_B4", B=4, S=pcfg.clip_tokens + QUERY_LEN,
             H=llm.num_heads, K=llm.num_kv_heads, hd=llm.resolved_head_dim,
             causal=True)]


def check_sdpa(rng, case, dev, dtype=torch.bfloat16):
    """``attention.sdpa_f32`` on the card against the float32 upcast
    (``sdpa_upcast_f32``) on the same bf16 inputs. Each of its two products
    (``attention.scores_f32`` and ``attention.pv_f32``: ``torch.bmm`` of
    the native operands with a float32 result) against the same product of
    the upcast operands, q.k and then P.V on one bf16 P, within
    TOL[float32]: the products are exact in both, only the summation order
    differs. The outputs within SDPA_RTOL (norm-wise), which the same
    output rounded to bf16 (a route with a bf16 P.V result) must fail.
    Both routes timed."""
    from repro_torch.models import attention
    B, S, H, K, hd = (case[n] for n in ("B", "S", "H", "K", "hd"))
    q, k, v = (torch.from_numpy(rng.randn(B, S, n, hd).astype(np.float32)
                                ).to(dev, dtype) for n in (H, K, K))
    mask = torch.zeros((1, S, S), dtype=torch.float32, device=dev)
    if case["causal"]:
        mask = torch.triu(torch.full((1, S, S), -1e30, device=dev), 1)
    scale = 1.0 / math.sqrt(hd)
    name = f"sdpa {case['name']}"
    qg = q.reshape(B, S, K, H // K, hd).permute(0, 2, 3, 1, 4).reshape(
        B * K, -1, hd)
    kt = k.permute(0, 2, 3, 1).reshape(B * K, hd, S)
    scores = torch.bmm(qg.float(), kt.float())
    qk_err = held_against(f"{name} q.k", attention.scores_f32(q, k), scores,
                          TOL[torch.float32])
    probs = torch.softmax(scores * scale, dim=-1).to(dtype)
    vg = v.permute(0, 2, 1, 3).reshape(B * K, S, hd)
    pv_err = held_against(f"{name} p.v", attention.pv_f32(probs, v),
                          torch.bmm(probs.float(), vg.float()),
                          TOL[torch.float32])
    del scores, probs
    got = attention.sdpa_f32(q, k, v, mask, scale)
    want = sdpa_upcast_f32(q, k, v, mask, scale)
    rel = _rel(got, want)
    control = _rel(got.to(dtype).float(), want)
    if not (torch.isfinite(got).all() and rel <= SDPA_RTOL):
        raise AssertionError(f"{name}: output off the float32 upcast by "
                             f"{rel:.3g} (norm-wise), limit {SDPA_RTOL}")
    if not control > SDPA_RTOL:
        raise AssertionError(f"{name}: the output rounded to bf16 reads "
                             f"{control:.3g}, within the limit {SDPA_RTOL}: "
                             f"the check cannot tell a bf16 P.V result")
    off = int((got.to(dtype) != want.to(dtype)).sum())
    res = {"case": case["name"], "qk_max_abs_err": qk_err,
           "pv_max_abs_err": pv_err, "rel_err": rel,
           "bf16_pv_rel_err": control, "limit": SDPA_RTOL,
           "max_abs_err": float((got - want).abs().max()),
           "bf16_not_bit_equal": off, "elements": got.numel()}
    del got, want
    args = [(q, k, v, mask)]
    res["ms"] = device_ms(lambda *a: attention._sdpa(*a, scale), args)
    res["upcast_ms"] = device_ms(
        lambda *a: sdpa_upcast_f32(*a, scale).to(dtype), args)
    log(f"[sdpa] {case['name']}: B={B} S={S} H={H} K={K} hd={hd}: bf16 "
        f"operands on the tensor cores against the float32 upcast: q.k max "
        f"abs err {qk_err:.3g}, p.v {pv_err:.3g} (rtol "
        f"{TOL[torch.float32][0]}, atol {TOL[torch.float32][1]}); output "
        f"{rel:.3g} norm-wise (limit {SDPA_RTOL}; rounded to bf16 "
        f"{control:.3g}), max abs "
        f"{res['max_abs_err']:.3g}, {off} of {res['elements']} bf16 outputs "
        f"not bit-equal; ms {res['ms']:.4f}, upcast ms "
        f"{res['upcast_ms']:.4f}")
    return res


# ---------------------------------------------------------------------------
# phase 3: ssm_scan against its plain version
# ---------------------------------------------------------------------------

# the scan kernel against scan_ref on the same inputs: both round a
# multiply and an add per step in float32, so they agree bit for bit;
# the limits are the reference's own kernel test's
# (tests/test_kernels.py), 2e-4 for its long-decay case
SCAN_TOL = (1e-5, 1e-6)
SCAN_LONG_TOL = (2e-4, 2e-4)


def scan_cases(zoo_cfgs):
    """The four shapes of the reference's scan test and its 512-step
    long-decay case (float32), a bf16-input case, and the two prefill
    path shapes at B = 2, S = 1024: falcon-mamba-7b (C = d_inner, N) and
    zamba2-7b (C = d_inner, the heads' P x N flattened as the path
    flattens them, N)."""
    cases = [dict(name=f"float32_B{B}_S{S}_C{C}_N{N}", shape=(B, S, C, N),
                  dtype=torch.float32, lo=0.5, hi=1.0, drive=0.1,
                  tol=SCAN_TOL)
             for B, S, C, N in ((2, 64, 128, 16), (1, 100, 60, 8),
                                (2, 128, 256, 4), (1, 33, 16, 16))]
    cases.append(dict(name="float32_long_decay_B1_S512_C32_N8",
                      shape=(1, 512, 32, 8), dtype=torch.float32, lo=0.9,
                      hi=0.999, drive=1.0, tol=SCAN_LONG_TOL))
    cases.append(dict(name="bf16_B2_S256_C512_N16", shape=(2, 256, 512, 16),
                      dtype=torch.bfloat16, lo=0.5, hi=1.0, drive=0.1,
                      tol=SCAN_TOL))
    for name, cfg in zoo_cfgs.items():
        # mamba1's (B, S, d_inner, N); mamba2's (B, S, heads, P, N) as
        # (B, S, heads * P = d_inner, N)
        shape = (ZOO_BATCH, ZOO_PROMPT, cfg.ssm.expand * cfg.d_model,
                 cfg.ssm.state_size)
        cases.append(dict(name=f"main_{name}", shape=shape,
                          dtype=torch.float32, lo=0.5, hi=1.0, drive=0.1,
                          tol=SCAN_TOL))
    return cases


def scan_inputs(gen, case, dev):
    """decay uniform in [lo, hi), drive normal times ``drive``, made on
    the card (the path shapes are 1-4 GB a tensor)."""
    shape, dtype = case["shape"], case["dtype"]
    decay = torch.rand(shape, generator=gen, device=dev)
    decay = decay.mul_(case["hi"] - case["lo"]).add_(case["lo"])
    drive = torch.randn(shape, generator=gen, device=dev).mul_(case["drive"])
    return decay.to(dtype), drive.to(dtype)


def scan_held_against(name, h, want, tol):
    """A scan output against scan_ref's: within ``tol``; returns (max abs
    error, elements not bit-equal)."""
    err = held_against(name, h, want, tol)
    return err, int((h != want).sum())


def check_ssm_scan(gen, case, dev, timed):
    from repro_torch.kernels.ssm_scan import ops, ref
    decay, drive = scan_inputs(gen, case, dev)
    h = ops.chunked_scan(decay, drive)
    torch.cuda.synchronize()
    want = ref.scan_ref(decay, drive)
    if h.dtype != torch.float32 or h.shape != decay.shape:
        raise AssertionError(f"ssm_scan {case['name']}: {h.dtype} "
                             f"{tuple(h.shape)}")
    rtol, atol = case["tol"]
    max_err, off = scan_held_against(f"ssm_scan {case['name']}", h, want,
                                     case["tol"])
    B, S, C, N = case["shape"]
    res = {"case": case["name"], "B": B, "S": S, "C": C, "N": N,
           "dtype": str(case["dtype"]).replace("torch.", ""),
           "max_abs_err": max_err, "not_bit_equal": off,
           "elements": h.numel(), "rtol": rtol, "atol": atol}
    msg = (f"[kernel] ssm_scan {case['name']}: B={B} S={S} C={C} N={N} "
           f"{res['dtype']} max_abs_err={max_err:.3g} (rtol {rtol}, atol "
           f"{atol}), {off} of {h.numel()} elements not bit-equal")
    del want
    if timed:
        # decay and drive read once, h written once; one multiply and one
        # add an element (float32, outside the tensor cores)
        nbytes = h.numel() * (2 * decay.element_size() + 4)
        flops = 2 * h.numel()
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[
            torch.float32]
        copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
        sets = [(decay, drive)] + [scan_inputs(gen, case, dev)
                                   for _ in range(copies - 1)]
        res.update({
            "ms": device_ms(ops.chunked_scan, sets),
            "plain_ms": device_ms(ref.scan_ref, sets, reps=3),
            "same_bytes_ms": device_ms(
                lambda d, x: torch.add(d, x, out=h), sets),
            "library_ms": None,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops})
        msg += (f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f}"
                f" same_bytes_ms={res['same_bytes_ms']:.4f} (torch.add, "
                f"same bytes) bound_ms={res['bound_ms']:.4f} "
                f"({res['bound_by']})")
    log(msg)
    return res


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------

KINDS = ("context", "context", "insight", "context", "insight", "context")


def make_system(pcfg, seed, dev):
    from repro_torch.core import bottleneck as bn
    from repro_torch.core import vlm
    from repro_torch.core.lut import paper_lut
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = vlm.init_lisa(pcfg, gen, dev)
    lut = paper_lut()
    d = pcfg.sam.d_model
    bns = {t.name: bn.init_bottleneck(
        gen, bn.BottleneckSpec(d, bn.rank_for_ratio(d, t.ratio, 4), 4),
        device=dev) for t in lut.tiers}
    return params, bns, lut


def serve(executor, pcfg, seed, timings=None):
    """Edge-encode six requests, then serve them through the scheduler.
    Returns (requests, results aligned with them, the scheduler)."""
    reqs = edge_encode(executor, pcfg, seed, timings)
    return (reqs,) + serve_requests(executor, reqs, timings)


def edge_encode(executor, pcfg, seed, timings=None):
    """Six requests (KINDS) from seeded images and queries, their packets
    made by the executor's edge stages."""
    from repro_torch.core.intent import Intent
    from repro_torch.runtime.scheduler import ServeRequest
    rng = np.random.RandomState(seed)
    lut, n_ins, reqs = executor.lut, 0, []
    for i, kind in enumerate(KINDS):
        img = rng.rand(1, pcfg.image_size, pcfg.image_size,
                       3).astype(np.float32)
        query = rng.randint(0, pcfg.llm.vocab_size,
                            (1, QUERY_LEN)).astype(np.int32)
        t0 = _sync_s()
        if kind == "context":
            pkt, _ = executor.edge_context(img, i, 0.0)
            intent = Intent.CONTEXT
        else:
            pkt = executor.edge_insight(img, lut.tiers[n_ins % 2], i, 0.0)
            intent, n_ins = Intent.INSIGHT, n_ins + 1
        if timings is not None:
            timings.append({"stage": f"edge_{kind}", "seq_id": i,
                            "s": _sync_s() - t0})
        reqs.append(ServeRequest(seq_id=i, intent=intent, packet=pkt,
                                 query=query))
    return reqs


def serve_requests(executor, reqs, timings=None):
    """Serve the requests through MicrobatchScheduler(generate=True).
    Returns (results aligned with them, the scheduler)."""
    from repro_torch.runtime.scheduler import MicrobatchScheduler
    sched = MicrobatchScheduler(executor=executor, max_batch=4,
                                generate=True)
    for r in reqs:
        sched.submit(r)
    by_id = {}
    while sched.pending:
        t0 = _sync_s()
        out = sched.step()
        if timings is not None:
            timings.append({"stage": f"cloud_generate_batch[{out[0].intent.value}"
                                     f",{out[0].tier_name}]",
                            "batch": len(out), "s": _sync_s() - t0})
        by_id.update({res.seq_id: res for res in out})
    return [by_id[r.seq_id] for r in reqs], sched


def small_input_check(seed, dev):
    """LISA-mini, fp32, on the card: the serving path with the kernel gives
    the same greedy tokens as the plain path, and logits and masks within
    fp32 summation-order tolerance."""
    from repro_torch.configs import get_lisa_config
    from repro_torch.core.streams import DualStreamExecutor
    pcfg = get_lisa_config("lisa-mini")
    params, bns, lut = make_system(pcfg, seed, dev)
    outs = {}
    for flash in (True, False):
        ex = DualStreamExecutor(pcfg=pcfg, params=params, bottlenecks=bns,
                                lut=lut, max_new_tokens=MAX_NEW_TOKENS,
                                flash_decode=flash, device=dev)
        outs[flash] = serve(ex, pcfg, seed)[1]
    worst = 0.0
    for a, b in zip(outs[True], outs[False]):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"seq {a.seq_id}: kernel tokens "
                                 f"{a.tokens} != plain {b.tokens}")
        pairs = [(a.answer_logits, b.answer_logits)]
        if a.mask_logits is not None:
            pairs.append((a.mask_logits, b.mask_logits))
        for x, y in pairs:
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4)
            worst = max(worst, float(np.abs(x - y).max()))
    log(f"[small] lisa-mini fp32: tokens equal with and without the kernel "
        f"on {len(outs[True])} requests; max |logit/mask diff| {worst:.3g}")
    return {"requests": len(outs[True]), "max_abs_diff": worst}


def _rel(a, b):
    """Norm-wise relative error of ``a`` against ``b``: arrays, or tensors
    (two tensors on their own device)."""
    if torch.is_tensor(a) and torch.is_tensor(b):
        a, b = a.double(), b.double()
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))
    a, b = (x.double().cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def compare_paths(results, other, limit, label):
    """Hold the main path's results against another path's on the same
    requests: greedy tokens equal, answer and mask logits within ``limit``
    as a norm-wise relative error. Returns the worst error of each."""
    worst = {"answer_logits": 0.0, "mask_logits": 0.0}
    for a, b in zip(results, other):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"seq {a.seq_id}: kernel-path tokens "
                                 f"{a.tokens} != {label} {b.tokens}")
        for key in worst:
            x, y = getattr(a, key), getattr(b, key)
            if x is None:
                continue
            rel = _rel(x, y)
            worst[key] = max(worst[key], rel)
            if not rel <= limit:
                raise AssertionError(f"seq {a.seq_id}: {key} of the kernel "
                                     f"path off the {label} by {rel:.3g} "
                                     f"(norm-wise), limit {limit}")
    log(f"[parity] lisa-7b: kernel path vs {label} on {len(other)} "
        f"requests: tokens equal; norm-wise relative error answer_logits "
        f"{worst['answer_logits']:.3g}, mask_logits "
        f"{worst['mask_logits']:.3g} (limit {limit})")
    return worst


def full_width_parity(executor, reqs, results, expect):
    """LISA-7B at full width, after the main path's counted run.

    (a) Serve the same requests again with every kernel launch held
    against the plain version on the launch's own inputs: the real
    caches (in-place views with their strides), masks and queries of all
    layers and decode steps. (b) Serve them with the kernel's plain
    version in its place, every decode layer also computed with the
    kernel on the same input and held to LAYER_RTOL (``layer_check``), and
    (c) through the plain attention path (``flash_decode=False``), on the
    same weights, and hold the main path's outputs against each: greedy
    tokens equal, logits and masks within PATH_RTOL and
    SDPA_PATH_RTOL."""
    from repro_torch.kernels.decode_attention import ops, ref
    launch, errs, n_diff, n_out = ops.decode_attention, [], 0, 0

    def checked(q, k, v, bias):
        nonlocal n_diff, n_out
        out = launch(q, k, v, bias)
        want = ref.decode_attention_ref(q, k, v, bias)
        errs.append(held_against("decode_attention on the main path's "
                                 "inputs", out, want))
        n_diff += int((out != want).sum())
        n_out += out.numel()
        return out

    ops.decode_attention = checked
    try:
        serve_requests(executor, reqs)
    finally:
        ops.decode_attention = launch
    if len(errs) != expect:
        raise AssertionError(f"held {len(errs)} kernel launches against "
                             f"the plain version, expected {expect}")
    log(f"[parity] lisa-7b: {len(errs)} kernel launches on the main path's "
        f"own inputs agree with the plain version; max abs err "
        f"{max(errs):.3g} (rtol {TOL[torch.bfloat16][0]}, atol "
        f"{TOL[torch.bfloat16][1]}); {n_diff} of {n_out} output elements "
        f"not bit-equal")

    (plain_kernel, _), layers = layer_check(
        "decode", "6 microbatch", lambda: serve_requests(executor, reqs))
    if layers["layers"] != expect:
        raise AssertionError(f"checked {layers['layers']} decode layers, "
                             f"expected {expect}")
    rel = compare_paths(results, plain_kernel, PATH_RTOL,
                        "path with the kernel's plain version")
    sdpa, _ = serve_requests(dataclasses.replace(executor,
                                                 flash_decode=False), reqs)
    rel_sdpa = compare_paths(results, sdpa, SDPA_PATH_RTOL,
                             "flash_decode=False path")
    logits = np.concatenate([r.answer_logits for r in results])
    unit = logits / np.linalg.norm(logits, axis=1, keepdims=True)
    min_cos = float((unit @ unit.T)[np.triu_indices(len(results), 1)].min())
    log(f"[parity] lisa-7b: least cosine between two requests' "
        f"answer_logits {min_cos:.6f}")
    return {"launches_checked": len(errs), "max_abs_err": max(errs),
            "elements_not_bit_equal": n_diff, "elements": n_out,
            "layers": layers,
            "rel_err_plain_kernel": rel, "rel_limit_plain_kernel": PATH_RTOL,
            "rel_err_sdpa": rel_sdpa, "rel_limit_sdpa": SDPA_PATH_RTOL,
            "min_cosine_answer_logits": min_cos}


# ---------------------------------------------------------------------------
# phase 8 (inflight): InflightDecoder over a paged, shared-prefix pool
# ---------------------------------------------------------------------------


def inflight_requests(executor, pcfg, seed, timings=None):
    """Edge-encode the frames INFLIGHT_WAVES names (seeded images and
    queries; Insight frames alternate over two tiers). Returns
    {frame: (kind, packet, query)}."""
    rng = np.random.RandomState(seed + 1)
    frames, n_ins = {}, 0
    for wave in INFLIGHT_WAVES:
        for _, kind, f in wave:
            if f in frames:
                continue
            img = rng.rand(1, pcfg.image_size, pcfg.image_size,
                           3).astype(np.float32)
            query = rng.randint(0, pcfg.llm.vocab_size,
                                (1, QUERY_LEN)).astype(np.int32)
            t0 = _sync_s()
            if kind == "context":
                pkt, _ = executor.edge_context(img, f, 0.0)
            else:
                pkt = executor.edge_insight(img, executor.lut.tiers[n_ins % 2],
                                            f, 0.0)
                n_ins += 1
            if timings is not None:
                timings.append({"stage": f"edge_{kind}", "frame": f,
                                "s": _sync_s() - t0})
            frames[f] = (kind, pkt, query)
    return frames


def serve_inflight(executor, frames, step_times=None):
    """Submit INFLIGHT_WAVES to a fresh InflightDecoder(slots=4), taking
    PUMPS[w] decode steps after wave w, then drain. Returns (results in
    submission order, the decoder). With ``step_times`` each decode step's
    host wall time (ending in the device-to-host copy of its logits) is
    appended, with its live rows."""
    from repro_torch.core.intent import Intent
    from repro_torch.engine import InflightDecoder
    dec = InflightDecoder(executor, slots=INFLIGHT_SLOTS)
    if step_times is not None:
        stage = executor.cloud_decode_rows

        def timed(*args):
            t0 = _sync_s()
            out = stage(*args)
            step_times.append({"live": len(dec.active),
                               "wall_ms": (_sync_s() - t0) * 1e3})
            return out

        executor.cloud_decode_rows = timed
    done = {}
    seq = 0
    try:
        for wave, pumps in zip(INFLIGHT_WAVES, PUMPS):
            for operator, kind, f in wave:
                _, pkt, query = frames[f]
                dec.submit(seq, Intent(kind), pkt, query,
                           lambda r: done.__setitem__(r["seq_id"], r),
                           operator_id=operator)
                seq += 1
            dec.pump(pumps)
        dec.drain()
    finally:
        if step_times is not None:
            del executor.cloud_decode_rows
    failed = [r for r in done.values() if "failure" in r]
    if len(done) != seq or failed:
        raise AssertionError(f"in-flight run served {len(done)} of {seq} "
                             f"requests; failures {failed}")
    return [done[i] for i in range(seq)], dec


def _submissions():
    return [(operator, kind, f) for wave in INFLIGHT_WAVES
            for operator, kind, f in wave]


def check_inflight_outputs(pcfg, results, dec, kinds=None,
                           new_tokens=MAX_NEW_TOKENS):
    """Every output finite with the expected shape; a prefix hit, a join
    after step 0 and slot reuse happened; the pool's invariants hold and
    only the stored prefixes' pages stay in use. ``kinds``: each result's
    request kind (default: phase 8's submissions)."""
    g = pcfg.image_size // pcfg.patch_size \
        * int(round(max(1, pcfg.mask_pixels_per_patch) ** 0.5))
    if kinds is None:
        kinds = [kind for _, kind, _ in _submissions()]
    for kind, r in zip(kinds, results):
        arrs = [r["answer_logits"], r["tokens"]]
        if r["tokens"].shape != (1, new_tokens) or \
                r["answer_logits"].shape != (1, pcfg.llm.vocab_size):
            raise AssertionError(f"seq {r['seq_id']}: bad output shapes")
        if kind == "insight":
            if r["mask_logits"] is None or r["mask_logits"].shape != (1, g,
                                                                      g):
                raise AssertionError(f"seq {r['seq_id']}: bad mask")
            arrs.append(r["mask_logits"])
        elif r["mask_logits"] is not None:
            raise AssertionError(f"seq {r['seq_id']}: Context with a mask")
        if not all(np.isfinite(a).all() for a in arrs):
            raise AssertionError(f"seq {r['seq_id']}: non-finite output")
    hits = sum(r["prefix_hit"] for r in results)
    late = max(r["joined_step"] for r in results)
    if hits < 1 or late < 1 or len(results) <= INFLIGHT_SLOTS:
        raise AssertionError(f"schedule did not exercise the decoder: "
                             f"{hits} prefix hits, latest join at step "
                             f"{late}")
    acct = dec.pool.check_invariants()
    stats = dec.pool.stats()
    if stats["kv_pages_in_use"] != stats["prefix_entries"] * \
            dec.n_prefix_pages:
        raise AssertionError(f"pages in use {stats['kv_pages_in_use']} != "
                             f"{stats['prefix_entries']} prefixes x "
                             f"{dec.n_prefix_pages} pages")
    return {"prefix_hits": hits, "latest_join_step": late,
            "joined_steps": [r["joined_step"] for r in results],
            "pool": acct, "pool_stats": stats}


def compare_inflight(results, other, limits, label, tag="inflight"):
    """Hold the in-flight results against another run's on the same
    requests: tokens equal, answer and mask logits within ``limits``
    (key -> norm-wise relative error; 0 means bit-equal)."""
    worst = {k: 0.0 for k in limits}
    for a, b in zip(results, other):
        if not np.array_equal(a["tokens"], b["tokens"]):
            raise AssertionError(f"seq {a['seq_id']}: tokens {a['tokens']} "
                                 f"!= {label} {b['tokens']}")
        for key, limit in limits.items():
            x, y = a[key], b[key]
            if x is None:
                continue
            rel = _rel(x, y)
            worst[key] = max(worst[key], rel)
            if not rel <= limit:
                raise AssertionError(f"seq {a['seq_id']}: {key} off the "
                                     f"{label} by {rel:.3g} (norm-wise), "
                                     f"limit {limit}")
    log(f"[{tag}] lisa-7b: vs {label} on {len(other)} requests: tokens "
        f"equal; norm-wise relative error "
        + ", ".join(f"{k} {v:.3g} (limit {limits[k]})"
                    for k, v in worst.items()))
    return worst


def inflight_parity(executor, frames, results, expect):
    """(a) Replay the schedule with every paged launch held against the
    plain version on that launch's own inputs (the real pool views, page
    tables and masks of every layer and step); (b) replay it with the
    plain version in the kernel's place, every paged decode layer also
    computed with the kernel on the same input and held to LAYER_RTOL
    (``layer_check``): tokens and answer logits equal, mask logits within
    PATH_RTOL; (c) hold each request against the
    one-shot ``cloud_generate_batch([packet], [query])``, the in-flight
    path's oracle: tokens equal, logits and masks within SDPA_PATH_RTOL
    (the batch sizes of the GEMMs differ, so their bf16 sums do)."""
    from repro_torch.kernels.decode_attention import ops, ref
    launch, errs, n_diff, n_out = ops.paged_decode_attention, [], 0, 0

    def checked(*args):
        nonlocal n_diff, n_out
        out = launch(*args)
        want = ref.paged_decode_attention_ref(*args)
        errs.append(held_against("paged_decode_attention on the in-flight "
                                 "path's inputs", out, want))
        n_diff += int((out != want).sum())
        n_out += out.numel()
        return out

    ops.paged_decode_attention = checked
    try:
        serve_inflight(executor, frames)
    finally:
        ops.paged_decode_attention = launch
    if len(errs) != expect:
        raise AssertionError(f"held {len(errs)} paged launches against the "
                             f"plain version, expected {expect}")
    log(f"[inflight] lisa-7b: {len(errs)} paged kernel launches on the "
        f"in-flight path's own inputs agree with the plain version; max abs "
        f"err {max(errs):.3g} (rtol {TOL[torch.bfloat16][0]}, atol "
        f"{TOL[torch.bfloat16][1]}); {n_diff} of {n_out} output elements "
        f"not bit-equal")
    (plain, _), layers = layer_check(
        "paged", "8 in-flight", lambda: serve_inflight(executor, frames))
    if layers["layers"] != expect:
        raise AssertionError(f"checked {layers['layers']} paged decode "
                             f"layers, expected {expect}")
    rel_plain = compare_inflight(
        results, plain, {"answer_logits": 0.0, "mask_logits": PATH_RTOL},
        "path with the paged kernel's plain version")
    oracle = []
    for (_, kind, f), r in zip(_submissions(), results):
        _, pkt, query = frames[f]
        out = executor.cloud_generate_batch([pkt], [query])[0]
        oracle.append({"seq_id": r["seq_id"], "tokens": out[-1],
                       "answer_logits": out[-2],
                       "mask_logits": out[0] if kind == "insight" else None})
    rel_oracle = compare_inflight(
        results, oracle, {"answer_logits": SDPA_PATH_RTOL,
                          "mask_logits": SDPA_PATH_RTOL},
        "one-shot cloud_generate_batch")
    return {"launches_checked": len(errs), "max_abs_err": max(errs),
            "elements_not_bit_equal": n_diff, "elements": n_out,
            "layers": layers, "rel_err_plain_kernel": rel_plain,
            "rel_err_generate_batch": rel_oracle}


def inflight_timings(executor, frames):
    """Admission wall time (host clock, ending in a synchronise) of a
    prefix miss (the first one on a fresh pool also creates the pool) and
    of a hit, on an idle decoder; then one decode step with every slot
    live, traced: its device time and the device's idle share."""
    from repro_torch.core.intent import Intent
    from repro_torch.engine import InflightDecoder
    dec = InflightDecoder(executor, slots=INFLIGHT_SLOTS)
    contexts = [f for f, (kind, _, _) in sorted(frames.items())
                if kind == "context"]
    out = {}
    seq = 0

    def admit(label, f, operator):
        nonlocal seq
        _, pkt, query = frames[f]
        t0 = _sync_s()
        dec.submit(seq, Intent.CONTEXT, pkt, query, lambda r: None,
                   operator_id=operator)
        out[label] = (_sync_s() - t0) * 1e3
        seq += 1

    for label, f in (("miss_first_ms", contexts[0]),
                     ("miss_ms", contexts[1]), ("hit_ms", contexts[1])):
        admit(label, f, "uav-C")
        dec.drain()
    if dec.active:
        raise AssertionError("decoder not idle after drain")
    for i, f in enumerate(contexts[:INFLIGHT_SLOTS]):
        admit(f"fill_{i}", f, "uav-D")
    if len(dec.active) != INFLIGHT_SLOTS:
        raise AssertionError("timing decoder has idle slots")
    # the trace's warm-up runs the first step with every slot live
    with captured(executor, "cloud_decode_rows") as calls:
        out["step_traced"] = trace("cloud_decode_rows (4 live rows)",
                                   dec.step)
    out["pool_write"] = pool_write_cost(executor, "cloud_decode_rows",
                                        calls[-1], "inflight")
    dec.drain()
    log(f"[inflight] admission wall: prefix miss {out['miss_ms']:.1f} ms "
        f"(first, creating the pool: {out['miss_first_ms']:.1f} ms), prefix "
        f"hit {out['hit_ms']:.2f} ms")
    return {k: v for k, v in out.items() if not k.startswith("fill_")}


@contextlib.contextmanager
def captured(executor, stage):
    """Within the block, the arguments of every call of the executor's
    ``stage`` method, in order, its numpy arrays copied (the decoder
    updates its tables in place after the call)."""
    real, calls = getattr(executor, stage), []

    def record(*args):
        calls.append(tuple(a.copy() if isinstance(a, np.ndarray) else a
                           for a in args))
        return real(*args)

    setattr(executor, stage, record)
    try:
        yield calls
    finally:        # as serve_spec, which may run inside, restores it
        vars(executor).pop(stage, None)


POOL_WRITE_TURNS = 40


def pool_write_cost(executor, stage, args, tag):
    """What fixing the winner of each pool slot costs a paged step: the
    executor's ``stage`` call on ``args`` (one captured step) replayed in
    POOL_WRITE_TURNS turns (A B, B A, ...) with the shipped write
    (``stack._write_src`` once a step, ``attention.write_pool`` a layer)
    and with a direct write of each entry's own row (the write before the
    winners were fixed: duplicate slots keep no fixed winner). A replay
    writes the same rows into the same slots. Host wall of each call,
    ending in a synchronise: medians and quartiles in ms, and of each
    turn's difference (shipped minus direct), which host drift between
    turns does not move."""
    from repro_torch.models import attention, stack
    stage_fn = getattr(executor, stage)

    def direct(pool, write_page, write_off, k, v, src):
        page, off = write_page.reshape(-1), write_off.reshape(-1)
        for name, x in (("k", k), ("v", v)):
            pool[name][page, off] = x.reshape(-1, *x.shape[-2:])

    walls = {"fixed": [], "direct": []}
    for turn in range(POOL_WRITE_TURNS):
        for label in (("fixed", "direct") if turn % 2 == 0
                      else ("direct", "fixed")):
            with contextlib.ExitStack() as patches:
                if label == "direct":
                    patches.enter_context(mock.patch.object(
                        stack, "_write_src", lambda *a: None))
                    patches.enter_context(mock.patch.object(
                        attention, "write_pool", direct))
                t0 = _sync_s()
                stage_fn(*args)
                walls[label].append((_sync_s() - t0) * 1e3)
    walls["diff"] = list(np.subtract(walls["fixed"], walls["direct"]))
    out = {}
    for k, w in walls.items():
        out[f"{k}_ms"] = float(np.median(w))
        out[f"{k}_quartiles_ms"] = [float(np.percentile(w, q))
                                    for q in (25, 75)]
    q = {k: "-".join(f"{x:.2f}" for x in out[f"{k}_quartiles_ms"])
         for k in walls}
    log(f"[{tag}] pool write A/B, {stage} with {INFLIGHT_SLOTS} live rows, "
        f"{POOL_WRITE_TURNS} turns: fixed winners median "
        f"{out['fixed_ms']:.2f} ms (quartiles {q['fixed']}), direct write "
        f"{out['direct_ms']:.2f} ({q['direct']}); a turn's difference "
        f"median {out['diff_ms']:+.2f} ms ({q['diff']})")
    return out


KERNELS = ("paged_verify_attention", "paged_decode_attention",
           "decode_attention", "flash_attention", "bottleneck_encode",
           "bottleneck_decode", "ssm_scan")


def _launch_counts():
    """Each kernel wrapper's launch counter."""
    from repro_torch.kernels.bottleneck import ops as bops
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssm_scan import ops as sops
    return {"decode_attention": ops.launches,
            "paged_decode_attention": ops.paged_launches,
            "paged_verify_attention": ops.verify_launches,
            "flash_attention": fops.flash_launches,
            "bottleneck_encode": bops.encode_launches,
            "bottleneck_decode": bops.bottleneck_decode_launches,
            "ssm_scan": sops.scan_launches}


def _reset_launch_counts():
    from repro_torch.kernels.bottleneck import ops as bops
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssm_scan import ops as sops
    ops.launches = ops.paged_launches = ops.verify_launches = 0
    fops.flash_launches = 0
    bops.encode_launches = bops.bottleneck_decode_launches = 0
    sops.scan_launches = 0


def _only(**want):
    """The launch counts of a run that launches the kernels named (with
    these counts) and no other."""
    return {k: want.get(k, 0) for k in KERNELS}


def _kernel_class(name: str) -> str:
    """The port kernel a traced kernel name belongs to (checked longest
    name first: one is a suffix of another), else a library class."""
    for k in KERNELS:
        if f"{k}_kernel" in name:
            return k
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul"
    if "softmax" in low:
        return "softmax"
    return "other"


TRACE_SETTLE_S = 0.2


def trace(label, fn):
    """Run ``fn`` twice under ``torch.profiler``: once as the profiler's
    warm-up, whose events are discarded (the first traced kernels can be
    lost while the tracer starts), then once recorded. Reports the recorded
    run's traced wall time, device time by kernel class, the top kernels,
    and the device's idle share (1 - kernel time / traced wall). Fails if
    the trace holds another count of any port kernel than its wrapper
    launched in the recorded run (the profiler dropped events), or more
    kernel time than the traced wall (it counted a span as a kernel)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        # the device may still run the warm-up's kernels: let it finish,
        # or they land in the recorded window
        torch.cuda.synchronize()
        prof.step()
        # let the switch from warm-up to recording settle before the first
        # recorded launch: without this pause a speculative step's first
        # draft kernels were missing from the trace (93 and 95 of its 96
        # decode launches found, all 32 verify launches, which come last)
        time.sleep(TRACE_SETTLE_S)
        before = _launch_counts()
        t0 = _sync_s()
        fn()
        traced = _sync_s() - t0
        made = {k: v - before[k] for k, v in _launch_counts().items()}
        prof.step()
    by_class, top = {}, []
    seen = {k: 0 for k in KERNELS}
    for e in prof.key_averages():
        dev_us = e.self_device_time_total
        if (dev_us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith("ProfilerStep")):
            continue          # the schedule's step span is no kernel
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
        top.append((dev_us / 1e3, e.count, e.key[:90]))
        if cls in seen:
            seen[cls] += e.count
    if seen != made:
        raise AssertionError(
            f"{label}: the trace holds port kernels {seen} but {made} were "
            f"launched; the profiler dropped events")
    busy = sum(by_class.values())
    if not 0 < busy <= traced * 1e3:
        raise AssertionError(f"{label}: the profiler recorded {busy:.2f} ms "
                             f"of device time in {traced * 1e3:.2f} ms")
    top.sort(reverse=True)
    log(f"[profile] {label}: traced wall {traced * 1e3:.2f} ms, device "
        f"{busy:.2f} ms (idle share {1.0 - busy / (traced * 1e3):.3f}); by "
        "class " + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])))
    for t, c, n in top[:6]:
        log(f"[profile]   {t:8.3f} ms  x{c:<5d} {n}")
    return {"traced_wall_ms": traced * 1e3, "device_ms": busy,
            "idle_share": 1.0 - busy / (traced * 1e3),
            "port_kernels_traced": seen,
            "device_ms_by_class": by_class,
            "top_kernels": [{"ms": t, "count": c, "name": n}
                            for t, c, n in top[:10]]}


def profile_microbatches(executor, reqs):
    """Warm replays of one Context and one Insight microbatch: the
    untraced wall time, then a traced run's device time by kernel class
    and the device's idle share."""
    batches = {
        "context": [r for r in reqs if r.packet.kind == "context"],
        "insight": [r for r in reqs if r.packet.kind == "insight"][:1]}
    report = {}
    for label, batch in batches.items():
        args = ([r.packet for r in batch], [r.query for r in batch])
        executor.cloud_generate_batch(*args)
        t0 = _sync_s()
        executor.cloud_generate_batch(*args)
        warm = _sync_s() - t0
        log(f"[profile] {label} B={len(batch)}: warm wall "
            f"{warm * 1e3:.1f} ms")
        report[f"{label}_B{len(batch)}"] = dict(
            warm_wall_ms=warm * 1e3,
            **trace(f"{label} B={len(batch)}",
                    lambda: executor.cloud_generate_batch(*args)))
    return report


def inflight_phase(executor, pcfg, seed):
    """Phase 8: the paged in-flight path at LISA-7B's full width, with the
    launch counters set to 0 just before its counted run and read just
    after, then its parity checks and timings. Returns (report, the
    edge-encoded frames)."""
    timings, steps = [], []
    frames = inflight_requests(executor, pcfg, seed, timings)
    _reset_launch_counts()
    t0 = _sync_s()
    results, dec = serve_inflight(executor, frames, steps)
    wall = _sync_s() - t0
    launches = _launch_counts()
    expect = dec.n_steps * pcfg.llm.num_layers
    log(f"[inflight] {len(results)} requests on {INFLIGHT_SLOTS} slots in "
        f"{dec.n_steps} decode steps (mean live slots "
        f"{dec.mean_live_slots:.2f}), wall {wall:.2f} s; joined at steps "
        f"{[r['joined_step'] for r in results]}, prefix hits "
        f"{[int(r['prefix_hit']) for r in results]}; launches {launches} "
        f"(paged expected {expect})")
    if launches != _only(paged_decode_attention=expect) or expect == 0:
        raise AssertionError(f"in-flight path launches {launches}, expected "
                             f"{expect} paged and no others")
    shape = check_inflight_outputs(pcfg, results, dec)
    log(f"[inflight] outputs finite with expected shapes; pool "
        f"{shape['pool']}, {shape['pool_stats']['prefix_entries']} prefixes "
        f"x {dec.n_prefix_pages} pages in use; tokens "
        f"{[r['tokens'].tolist()[0] for r in results]}")
    full = [t["wall_ms"] for t in steps if t["live"] == INFLIGHT_SLOTS]
    step_ms = float(np.median(full)) if full else None
    log(f"[inflight] cloud_decode_rows wall with {INFLIGHT_SLOTS} live rows: "
        f"median {step_ms} ms over {len(full)} steps; all steps "
        f"{[round(t['wall_ms'], 1) for t in steps]}")
    out = {"wall_s": wall, "n_steps": dec.n_steps,
           "mean_live_slots": dec.mean_live_slots, "launches": launches,
           "expected_paged_launches": expect, "edge": timings,
           "steps": steps, "step_wall_ms_full": step_ms, **shape}
    out["parity"] = inflight_parity(executor, frames, results, expect)
    out["timings"] = inflight_timings(executor, frames)
    return out, frames, results


# ---------------------------------------------------------------------------
# phase 9 (spec): speculative decoding in the in-flight decoder
# ---------------------------------------------------------------------------


def _spec_submissions(frames):
    """(operator, kind, frame, drafts) of every SPEC_WAVES request."""
    return [(op, frames[f][0], f, drafts) for wave in SPEC_WAVES
            for op, f, drafts in wave]


def serve_spec(executor, frames, spec, step_times=None):
    """Submit SPEC_WAVES to a fresh InflightDecoder(slots=4, spec=spec),
    one step after the first wave, then drain. Returns (results in
    submission order, the decoder, the number of verify and of plain
    decode steps). With ``step_times`` each step's host wall time (ending
    in the device-to-host copy of its logits) is appended, with its stage
    and live rows."""
    from repro_torch.core.intent import Intent
    from repro_torch.engine import InflightDecoder
    dec = InflightDecoder(executor, slots=INFLIGHT_SLOTS, spec=spec)
    calls = {"cloud_verify_rows": 0, "cloud_decode_rows": 0}

    def counted(name):
        stage = getattr(executor, name)

        def run(*args):
            calls[name] += 1
            t0 = _sync_s() if step_times is not None else 0.0
            out = stage(*args)
            if step_times is not None:
                step_times.append({"stage": name, "live": len(dec.active),
                                   "wall_ms": (_sync_s() - t0) * 1e3})
            return out
        return run

    for name in calls:
        setattr(executor, name, counted(name))
    done = {}
    seq = 0
    try:
        for w, wave in enumerate(SPEC_WAVES):
            for operator, f, drafts in wave:
                kind, pkt, query = frames[f]
                dec.submit(seq, Intent(kind), pkt, query,
                           lambda r: done.__setitem__(r["seq_id"], r),
                           operator_id=operator,
                           speculative=None if drafts else False)
                seq += 1
            if w == 0:
                dec.pump(1)
        dec.drain()
    finally:
        for name in calls:
            delattr(executor, name)
    failed = [r for r in done.values() if "failure" in r]
    if len(done) != seq or failed:
        raise AssertionError(f"spec run served {len(done)} of {seq} "
                             f"requests; failures {failed}")
    return [done[i] for i in range(seq)], dec, calls


def spec_run(executor, pcfg, frames, spec, label, step_times=None):
    """One counted run: launch counters set to 0 just before, read just
    after; verify launches must be verify steps x layers, paged decode
    launches plain steps x layers, contiguous launches the draft model's
    decode steps x layers."""
    _reset_launch_counts()
    t0 = _sync_s()
    results, dec, calls = serve_spec(executor, frames, spec, step_times)
    wall = _sync_s() - t0
    launches = _launch_counts()
    L = pcfg.llm.num_layers
    draft_steps = dec.draft.n_steps if dec.draft is not None else 0
    expect = _only(paged_verify_attention=calls["cloud_verify_rows"] * L,
                   paged_decode_attention=calls["cloud_decode_rows"] * L,
                   decode_attention=draft_steps * L)
    stats = dec.spec_stats.as_dict()
    log(f"[spec] {label}: {len(results)} requests on {INFLIGHT_SLOTS} slots "
        f"in {calls['cloud_verify_rows']} verify and "
        f"{calls['cloud_decode_rows']} plain steps, {draft_steps} draft "
        f"steps, {dec.draft.n_prefills if dec.draft else 0} draft prefills,"
        f" wall {wall:.2f} s; launches {launches} (expected {expect}); "
        f"joined at steps {[r['joined_step'] for r in results]}, prefix "
        f"hits {[int(r['prefix_hit']) for r in results]}")
    log(f"[spec] {label}: SpecStats {json.dumps(stats)}")
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect}")
    kinds = [kind for _, kind, _, _ in _spec_submissions(frames)]
    shape = check_inflight_outputs(pcfg, results, dec, kinds,
                                   SPEC_MAX_NEW_TOKENS)
    log(f"[spec] {label}: outputs finite with expected shapes; pool "
        f"{shape['pool']}; tokens {[r['tokens'].tolist()[0] for r in results]}")
    return results, dec, {"wall_s": wall, "launches": launches,
                          "expected_launches": expect, "steps": calls,
                          "draft_steps": draft_steps,
                          "draft_prefills": dec.draft.n_prefills
                          if dec.draft else 0,
                          "spec_stats": stats, **shape}


def spec_parity(executor, frames, spec, results, expect):
    """(a) Replay run A with every verify launch held against the plain
    version on that launch's own inputs (the real pool views, page tables
    and per-query masks of every layer and step); (b) replay it with the
    plain version in the kernel's place: tokens and answer logits equal,
    mask logits within PATH_RTOL; (c) in that replay, every verify layer
    also computed with the kernel on the same input and held to
    LAYER_RTOL (``layer_check``), ``expect`` layers in all."""
    from repro_torch.kernels.decode_attention import ops, ref
    launch, errs, n_diff, n_out = ops.paged_verify_attention, [], 0, 0

    def checked(*args):
        nonlocal n_diff, n_out
        out = launch(*args)
        want = ref.paged_verify_attention_ref(*args)
        errs.append(held_against("paged_verify_attention on the spec "
                                 "path's inputs", out, want))
        n_diff += int((out != want).sum())
        n_out += out.numel()
        return out

    ops.paged_verify_attention = checked
    try:
        serve_spec(executor, frames, spec)
    finally:
        ops.paged_verify_attention = launch
    if len(errs) != expect:
        raise AssertionError(f"held {len(errs)} verify launches against the "
                             f"plain version, expected {expect}")
    log(f"[spec] lisa-7b: {len(errs)} verify kernel launches on the spec "
        f"path's own inputs agree with the plain version; max abs err "
        f"{max(errs):.3g} (rtol {TOL[torch.bfloat16][0]}, atol "
        f"{TOL[torch.bfloat16][1]}); {n_diff} of {n_out} output elements "
        f"not bit-equal")
    (plain, _, _), layers = layer_check(
        "verify", "9 spec run A", lambda: serve_spec(executor, frames, spec))
    if layers["layers"] != expect:
        raise AssertionError(f"checked {layers['layers']} verify layers, "
                             f"expected {expect}")
    rel = compare_inflight(results, plain,
                           {"answer_logits": 0.0, "mask_logits": PATH_RTOL},
                           "spec path with the verify kernel's plain version",
                           tag="spec")
    return {"launches_checked": len(errs), "max_abs_err": max(errs),
            "elements_not_bit_equal": n_diff, "elements": n_out,
            "layers": layers, "rel_err_plain_kernel": rel}


def spec_timings(executor, frames, spec):
    """Three decoders with every slot live and speculating (Context frames
    of uav-C, their draft prefix rows shared): the wall time of one step
    (draft rounds + verify, ending in a synchronise) on the first, then
    one traced step on the third, the second's step being the trace's
    warm-up. Each is its decoder's first step: full chunks of k+1."""
    from repro_torch.core.intent import Intent
    from repro_torch.core.paging import PagePool
    from repro_torch.engine import InflightDecoder
    contexts = [f for f, (kind, _, _) in sorted(frames.items())
                if kind == "context"][:INFLIGHT_SLOTS]
    pool, rows, decs = PagePool(page_size=SPEC_PAGE), {}, []
    for _ in range(3):
        dec = InflightDecoder(executor, slots=INFLIGHT_SLOTS, pool=pool,
                              spec=spec, spec_prefix_rows=rows)
        for i, f in enumerate(contexts):
            _, pkt, query = frames[f]
            dec.submit(i, Intent.CONTEXT, pkt, query, lambda r: None,
                       operator_id="uav-C")
        if len(dec.active) != INFLIGHT_SLOTS:
            raise AssertionError("timing decoder has idle slots")
        decs.append(dec)
    with captured(executor, "cloud_verify_rows") as calls:
        t0 = _sync_s()
        decs[0].step()
        step_ms = (_sync_s() - t0) * 1e3
    # before the other decoders take pages that this step's rollback freed
    write = pool_write_cost(executor, "cloud_verify_rows", calls[-1],
                            "spec")
    log(f"[spec] one speculative step (draft + verify) with "
        f"{INFLIGHT_SLOTS} live rows: wall {step_ms:.1f} ms")
    queue = decs[1:]
    traced = trace(f"speculative step ({INFLIGHT_SLOTS} live rows)",
                   lambda: queue.pop(0).step())
    want = executor.pcfg.llm.num_layers
    if traced["port_kernels_traced"]["paged_verify_attention"] != want:
        raise AssertionError(f"the traced step holds "
                             f"{traced['port_kernels_traced']} port kernels;"
                             f" expected {want} verify kernels")
    for dec in decs:
        dec.drain()
    return {"step_wall_ms": step_ms, "step_traced": traced,
            "pool_write": write}


def spec_phase(executor, pcfg, seed, frames):
    """Phase 9: speculative decoding at LISA-7B's full width on an executor
    of 6 new tokens over pages of 4 that shares the serving executor's
    weight tensors. Run A drafts with the serving weights (3 drafts), run
    B with a divergent draft (4 drafts; the LLM and seg_proj of a second
    random LISA-7B from ``seed``+1). Each counts its launches from 0; both
    must give the tokens of a spec=None decoder (answer logits bit-equal)
    and of the one-shot cloud_generate_batch."""
    from repro_torch.core import vlm
    from repro_torch.core.streams import DualStreamExecutor
    from repro_torch.engine.speculative import SpeculativeConfig
    dev = executor.device
    sx = DualStreamExecutor(pcfg=pcfg, params=executor.params,
                            bottlenecks=executor.bottlenecks,
                            lut=executor.lut,
                            max_new_tokens=SPEC_MAX_NEW_TOKENS,
                            flash_decode=True, page_size=SPEC_PAGE,
                            device=dev)
    if sx.params["llm"]["embed"] is not executor.params["llm"]["embed"]:
        raise AssertionError("the spec executor copied the weights")
    out = {}
    step_times = []
    spec_a = SpeculativeConfig(draft_tokens=3)
    res_a, dec_a, out["run_a"] = spec_run(sx, pcfg, frames, spec_a,
                                          "run A (shared draft, k=3)",
                                          step_times)
    if not (out["run_a"]["steps"]["cloud_verify_rows"]
            and out["run_a"]["steps"]["cloud_decode_rows"]
            and out["run_a"]["draft_prefills"] < sum(
                d for *_, d in _spec_submissions(frames))):
        raise AssertionError("run A did not exercise verify steps, plain "
                             "steps and the draft's prefix-row reuse")
    full = [t["wall_ms"] for t in step_times
            if t["stage"] == "cloud_verify_rows"
            and t["live"] == INFLIGHT_SLOTS]
    out["run_a"]["stage_walls"] = step_times
    out["run_a"]["verify_wall_ms_full"] = float(np.median(full)) \
        if full else None
    log(f"[spec] cloud_verify_rows wall with {INFLIGHT_SLOTS} live rows: "
        f"median {out['run_a']['verify_wall_ms_full']} ms over {len(full)} "
        f"steps; all stage calls "
        f"{[(t['stage'][6:12], t['live'], round(t['wall_ms'], 1)) for t in step_times]}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    other = vlm.init_lisa(pcfg, gen, dev)
    draft = {"llm": other["llm"], "seg_proj": other["seg_proj"]}
    del other
    spec_b = SpeculativeConfig(draft_tokens=4, draft_params=draft)
    res_b, dec_b, out["run_b"] = spec_run(sx, pcfg, frames, spec_b,
                                          "run B (divergent draft, k=4)")
    st = dec_b.spec_stats
    if not (st.acceptance_rate < 1.0 and st.pages_rolled_back > 0):
        raise AssertionError(f"run B shows no rejection and rollback: "
                             f"{st.as_dict()}")
    del dec_b, spec_b, draft
    torch.cuda.empty_cache()

    plain, _, _ = serve_spec(sx, frames, None)
    oracle = []
    for (_, kind, f, _), r in zip(_spec_submissions(frames), res_a):
        _, pkt, query = frames[f]
        o = sx.cloud_generate_batch([pkt], [query])[0]
        oracle.append({"seq_id": r["seq_id"], "tokens": o[-1],
                       "answer_logits": o[-2],
                       "mask_logits": o[0] if kind == "insight" else None})
    for label, res in (("run A", res_a), ("run B", res_b)):
        out[label.replace(" ", "_").lower()]["rel_err_spec_none"] = \
            compare_inflight(res, plain, {"answer_logits": 0.0,
                                          "mask_logits": SDPA_PATH_RTOL},
                             f"spec=None decoder ({label})", tag="spec")
        out[label.replace(" ", "_").lower()]["rel_err_generate_batch"] = \
            compare_inflight(res, oracle,
                             {"answer_logits": SDPA_PATH_RTOL,
                              "mask_logits": SDPA_PATH_RTOL},
                             f"one-shot cloud_generate_batch ({label})",
                             tag="spec")
    out["parity"] = spec_parity(
        sx, frames, spec_a, res_a,
        out["run_a"]["launches"]["paged_verify_attention"])
    out["timings"] = spec_timings(sx, frames, spec_a)
    return out


# ---------------------------------------------------------------------------
# phase 10 (split): the LLM prefill through flash_attention (llm.use_flash)
# and the Insight split point through the bottleneck kernels (use_kernel)
# ---------------------------------------------------------------------------


def _flash_plain(q, k, v, causal=True, block_q=128, block_k=128):
    from repro_torch.kernels.flash_attention import ref
    return ref.attention_ref(q, k, v, causal=causal)


def _layer_kind(kind):
    """What ``layer_check`` wraps for one kind of layer: the stack's block
    body, the attention function whose output is h, the group pass that
    starts a new prefill or step, the kernel wrapper's module and name,
    its plain version, and the word for one group pass."""
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.kernels.flash_attention import ops as fops
    return {
        "flash": ("_dense_block_full", "attn_full", "group_forward", fops,
                  "flash_attention", _flash_plain, "prefill"),
        "decode": ("_dense_block_decode", "attn_decode", "group_decode", ops,
                   "decode_attention", ref.decode_attention_ref, "step"),
        "paged": ("_dense_block_decode_paged", "attn_decode_paged",
                  "group_decode_paged", ops, "paged_decode_attention",
                  ref.paged_decode_attention_ref, "step"),
        "verify": ("_dense_block_decode_paged", "attn_verify_paged",
                   "group_verify_paged", ops, "paged_verify_attention",
                   ref.paged_verify_attention_ref, "step"),
    }[kind]


def layer_check(kind, label, run, kernel=None):
    """Run ``run()`` with a kernel's plain version in the kernel's place,
    so that it follows the plain trajectory, and hold every layer of
    ``kind`` that reaches the kernel: on the layer's input as the plain run
    has it, the layer computed with ``kernel`` (default: the kernel's
    wrapper) against the layer computed with the plain version, in the
    same weights and dtype. Kinds: "flash" (dense prefill layers,
    ``_dense_block_full`` / ``attn_full``, each ``group_forward`` pass a
    prefill), "decode" (``_dense_block_decode`` / ``attn_decode`` with
    ``decode_attention``, each ``group_decode`` pass a step), "paged"
    (``_dense_block_decode_paged`` / ``attn_decode_paged`` with
    ``paged_decode_attention``, each ``group_decode_paged`` pass a step;
    the same block's verify layers, whose ``attn_fn`` is
    ``attn_verify_paged``, pass through unchecked) and "verify" (the same
    block's verify layers, exactly those called with ``attn_fn=
    attn_verify_paged``, with ``paged_verify_attention``, each
    ``group_verify_paged`` pass a step; the plain paged decode layers,
    which pass no ``attn_fn``, pass through unchecked).

    Two norm-wise relative errors a layer, each within LAYER_RTOL: the
    attention block's output h (before the residual add, so a small
    attention term cannot hide behind a large residual) and the layer's
    output. The plain output goes on, so no error carries from one layer
    to the next. The decode kinds write the new token's k/v into the cache
    or pool in place before attending; the second run of a layer computes
    the same k/v from the same input and writes the same values to the
    same slots. That holds for the paged kinds too, whose pad and idle
    entries all target the shared trash page, several to one slot, which
    an idle row attends: the pool write gives every entry of a slot the
    row of the last entry for it (``attention.write_pool``), so however the
    card orders the duplicates, both runs leave the same values there.
    Raises naming the first (prefill or step, layer) past the limit.
    Returns (what ``run`` returns, which is the plain replay's result, and
    a summary). Kind "split" is the split point's check
    (``split_layer_check``; ``kernel`` an (encode, decode) pair)."""
    if kind == "split":
        return split_layer_check(label, run, kernel)
    from repro_torch.models import attention, stack
    block_name, attn_name, group_name, mod, name, plain_fn, unit = \
        _layer_kind(kind)
    kernel = getattr(mod, name) if kernel is None else kernel
    block, attn_fn = getattr(stack, block_name), getattr(attention, attn_name)
    group = getattr(stack, group_name)
    # the paged block's attn_fn: the "paged" kind checks the calls that
    # pass none (its default), the "verify" kind those that pass attn_fn
    unset = None if kind == "verify" else attn_fn
    passes = []                 # one list of layer readings a group pass

    def grouped(*a, **kw):
        passes.append([])
        return group(*a, **kw)

    def layer(fn, *a, **kw):
        seen = {"kernel": 0}

        def counted(*x, **y):
            seen["kernel"] += 1
            return fn(*x, **y)

        def attn(*x, **y):
            seen["h"], rest = attn_fn(*x, **y)
            return seen["h"], rest

        if kind in ("paged", "verify"):   # the block and the group pass
            kw = dict(kw, attn_fn=attn)     # bind attn_fn before this call
        with mock.patch.object(mod, name, counted), \
                mock.patch.object(attention, attn_name, attn):
            y, rest = block(*a, **kw)
        return seen, y, rest

    def checked(*a, **kw):
        if kw.get("attn_fn", unset) is not attn_fn:
            return block(*a, **kw)      # a layer of the other paged kind
        plain, y, rest = layer(plain_fn, *a, **kw)
        if plain["kernel"]:
            got, y_k, _ = layer(kernel, *a, **kw)
            passes[-1].append({"h": _rel(got["h"], plain["h"]),
                               "out": _rel(y_k, y),
                               "bit_equal": bool(torch.equal(y_k, y))})
        return y, rest

    with mock.patch.object(stack, block_name, checked), \
            mock.patch.object(stack, group_name, grouped):
        result = run()
    passes = [p for p in passes if p]   # e.g. the encoders take no flash
    layers = [(i, j, r) for i, p in enumerate(passes)
              for j, r in enumerate(p)]
    if not layers:
        raise AssertionError(f"{label}: no layer reached {name}")
    i, j, r = max(layers, key=lambda t: max(t[2]["h"], t[2]["out"]))
    per_pass = [max(max(r["h"], r["out"]) for r in p) for p in passes]
    off = sum(not r["bit_equal"] for _, _, r in layers)
    summary = {"layers": len(layers), f"{unit}s": len(passes),
               "worst": {unit: i, "layer": j, "h": r["h"], "out": r["out"]},
               f"per_{unit}_max": per_pass,
               "outputs_not_bit_equal": off, "limit": LAYER_RTOL}
    log(f"[layers] {label}: {len(layers)} layers in {len(passes)} {unit}s, "
        f"each against the plain version on its own input; worst {unit} "
        f"{i} layer {j}: attention h {r['h']:.3g}, layer output "
        f"{r['out']:.3g} (limit {LAYER_RTOL}); per-{unit} max "
        + ", ".join(f"{m:.3g}" for m in per_pass)
        + f"; {off} of {len(layers)} layer outputs not bit-equal")
    bad = [(i, j, r) for i, j, r in layers
           if not max(r["h"], r["out"]) <= LAYER_RTOL]
    if bad:
        i, j, r = bad[0]
        raise AssertionError(
            f"{label}: {unit} {i} layer {j} with the {name} kernel is off "
            f"the plain version's on the same input: attention h by "
            f"{r['h']:.3g}, layer output by {r['out']:.3g} (norm-wise), "
            f"limit {LAYER_RTOL}; {len(bad)} layers past it")
    return result, summary


def flash_layer_check(label, run, kernel=None):
    """``layer_check`` of the dense prefill layers with the flash kernel."""
    return layer_check("flash", label, run, kernel)


def _plain_encode(x, w):
    """The bottleneck encode kernel's plain version, in the wrapper's
    shapes."""
    from repro_torch.kernels.bottleneck import ref
    r = w.shape[1]
    c, sc = ref.encode_ref(x.reshape(-1, x.shape[-1]), w)
    return c.reshape(*x.shape[:-1], r), sc.reshape(*x.shape[:-1], 1)


def _plain_decode(codes, scales, w, out_dtype=torch.float32):
    """The bottleneck decode kernel's plain version, in the wrapper's
    shapes."""
    from repro_torch.kernels.bottleneck import ref
    r, d = w.shape
    return ref.decode_ref(codes.reshape(-1, r), scales.reshape(-1, 1), w,
                          out_dtype).reshape(*codes.shape[:-1], d)


def split_layer_check(label, run, kernels=None):
    """``layer_check`` of the split point (kind "split"): run ``run()`` with
    the bottleneck pair's plain versions in the kernels' place, and at
    every frame, on the SAM-head output as the plain run has it, hold the
    boundary activation the kernels reconstruct (``kernels``, an (encode,
    decode) pair, default the two wrappers: decode of encode's codes and
    scales) against the plain pair's, and the first SAM-tail block on
    each, each as a norm-wise relative error within LAYER_RTOL. Counts the
    codes that are off the plain version's and by how much. The plain
    activation goes on. Raises naming the first frame past the limit.
    Returns (what ``run`` returns, a summary)."""
    from repro_torch.core import vlm
    from repro_torch.kernels.bottleneck import ops as bops
    enc_k, dec_k = kernels or (bops.bottleneck_encode,
                               bops.bottleneck_decode)
    frames = []
    tail = vlm.sam_tail

    def encode(x, w):
        codes, scales = _plain_encode(x, w)
        k_codes, k_scales = enc_k(x, w)
        diff = (k_codes.int() - codes.int()).abs()
        frames.append({"rank": int(w.shape[1]), "codes": codes.numel(),
                       "codes_off": int((diff > 0).sum()),
                       "codes_max_diff": int(diff.max()),
                       "scales": _rel(k_scales, scales),
                       "pair": (k_codes, k_scales)})
        return codes, scales

    def decode(codes, scales, w, out_dtype=torch.float32):
        a = _plain_decode(codes, scales, w, out_dtype)
        f = frames[-1]
        f["a"] = dec_k(*f.pop("pair"), w, out_dtype)
        f["boundary"] = _rel(f["a"], a)
        return a

    def sam_tail(params, pcfg, x, split_k=None):
        k = pcfg.split_layer if split_k is None else split_k
        f, groups = frames[-1], params["sam"]["groups"]
        f["block"] = _rel(
            vlm._encoder_blocks(groups, pcfg.sam, f.pop("a"), k, k + 1),
            vlm._encoder_blocks(groups, pcfg.sam, x, k, k + 1))
        return tail(params, pcfg, x, split_k)

    with mock.patch.object(bops, "bottleneck_encode", encode), \
            mock.patch.object(bops, "bottleneck_decode", decode), \
            mock.patch.object(vlm, "sam_tail", sam_tail):
        result = run()
    if not frames or any("block" not in f for f in frames):
        raise AssertionError(f"{label}: {len(frames)} frames reached the "
                             f"split point, or a frame skipped its tail")
    i, worst = max(enumerate(frames),
                   key=lambda t: max(t[1]["boundary"], t[1]["block"]))
    summary = {"frames": [{k: f[k] for k in ("rank", "boundary", "block",
                                             "codes", "codes_off",
                                             "codes_max_diff", "scales")}
                          for f in frames],
               "worst": {"frame": i, "boundary": worst["boundary"],
                         "block": worst["block"]},
               "limit": LAYER_RTOL}
    log(f"[layers] {label}: {len(frames)} frames, the bottleneck pair "
        f"against its plain version on each frame's SAM-head output; worst "
        f"frame {i} (rank {worst['rank']}): boundary activation "
        f"{worst['boundary']:.3g}, first SAM-tail block "
        f"{worst['block']:.3g} (limit {LAYER_RTOL}); per frame (rank: "
        f"boundary, block, codes off / codes, max off, scales) "
        + "; ".join(f"{f['rank']}: {f['boundary']:.3g}, {f['block']:.3g}, "
                    f"{f['codes_off']} / {f['codes']}, "
                    f"{f['codes_max_diff']}, {f['scales']:.3g}"
                    for f in frames))
    bad = [(j, f) for j, f in enumerate(frames)
           if not max(f["boundary"], f["block"]) <= LAYER_RTOL]
    if bad:
        j, f = bad[0]
        raise AssertionError(
            f"{label}: frame {j} (rank {f['rank']}) with the bottleneck "
            f"kernels is off the plain pair's on the same input: boundary "
            f"activation by {f['boundary']:.3g}, first SAM-tail block by "
            f"{f['block']:.3g} (norm-wise), limit {LAYER_RTOL}; {len(bad)} "
            f"frames past it")
    return result, summary


def split_microbatch(fx, reqs, base_results):
    """10a: phase 5's requests through MicrobatchScheduler(generate=True)
    on the use_flash executor, counters from 0: one flash launch per layer
    and microbatch (the prefill of each cloud_*_gen call), the decode
    steps' launches as in phase 5. Tokens equal to phase 5's, logits and
    masks within SDPA_PATH_RTOL of it (its _sdpa rounds P to bf16, the
    kernel does not); a replay with the flash kernel's plain version in
    its place, every prefill layer held against the kernel on its own
    input (flash_layer_check, LAYER_RTOL), the outputs within
    SDPA_PATH_RTOL."""
    L = fx.pcfg.llm.num_layers
    _reset_launch_counts()
    t0 = _sync_s()
    results, sched = serve_requests(fx, reqs)
    wall = _sync_s() - t0
    launches = _launch_counts()
    n = sched.n_microbatches
    expect = _only(flash_attention=n * L,
                   decode_attention=n * MAX_NEW_TOKENS * L)
    log(f"[split] microbatch: {len(results)} requests in {n} microbatches, "
        f"wall {wall:.2f} s; launches {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"use_flash microbatch launches {launches}, "
                             f"expected {expect}")
    out = {"wall_s": wall, "microbatches": n, "launches": launches,
           "expected_launches": expect}
    out["rel_err_use_flash_false"] = compare_paths(
        results, base_results, SDPA_PATH_RTOL,
        "use_flash=False path (phase 5)")
    (plain, _), out["layers"] = flash_layer_check(
        "10a microbatch", lambda: serve_requests(fx, reqs))
    if out["layers"]["layers"] != n * L:
        raise AssertionError(f"checked {out['layers']['layers']} prefill "
                             f"layers, expected {n * L}")
    out["rel_err_plain_kernel"] = compare_paths(
        results, plain, SDPA_PATH_RTOL, "path with the flash kernel's plain "
        "version")
    return out


def split_inflight(fx, frames, base_results, base_paged):
    """10b: phase 8's schedule through InflightDecoder(slots=4) on the
    use_flash executor, counters from 0: one flash launch per layer and
    prefix miss (cloud_prefix), the paged launches of phase 8. Tokens
    equal to phase 8's, logits and masks within SDPA_PATH_RTOL."""
    L = fx.pcfg.llm.num_layers
    _reset_launch_counts()
    t0 = _sync_s()
    results, dec = serve_inflight(fx, frames)
    wall = _sync_s() - t0
    launches = _launch_counts()
    misses = sum(not r["prefix_hit"] for r in results)
    expect = _only(flash_attention=misses * L,
                   paged_decode_attention=dec.n_steps * L)
    log(f"[split] in-flight: {len(results)} requests, {misses} prefix "
        f"misses, {dec.n_steps} decode steps, wall {wall:.2f} s; launches "
        f"{launches} (expected {expect}; phase 8 paged {base_paged})")
    if launches != expect or dec.n_steps * L != base_paged:
        raise AssertionError(f"use_flash in-flight launches {launches}, "
                             f"expected {expect} with {base_paged} paged")
    rel = compare_inflight(results, base_results,
                           {"answer_logits": SDPA_PATH_RTOL,
                            "mask_logits": SDPA_PATH_RTOL},
                           "use_flash=False in-flight run (phase 8)",
                           tag="split")
    return {"wall_s": wall, "prefix_misses": misses, "n_steps": dec.n_steps,
            "launches": launches, "expected_launches": expect,
            "rel_err_use_flash_false": rel}


def split_frames(fx, pcfg, seed):
    """One Insight frame per tier: a seeded image and query, and its CLIP
    features (the edge's Context pass, which the packet carries)."""
    from repro_torch.core import vlm
    rng = np.random.RandomState(seed + 2)
    frames = []
    for tier in fx.lut.tiers:
        img = torch.from_numpy(rng.rand(1, pcfg.image_size, pcfg.image_size,
                                        3).astype(np.float32)).to(fx.device)
        query = torch.from_numpy(rng.randint(
            0, pcfg.llm.vocab_size, (1, QUERY_LEN)).astype(np.int32)
        ).to(fx.device)
        with torch.inference_mode():
            ctx = vlm.clip_encode(fx.params, pcfg, img)
        frames.append((tier, img, query, ctx))
    return frames


@torch.inference_mode()
def split_point(fx, frame, i):
    """One Insight frame through the reference's edge_insight and
    cloud_insight_gen stage bodies with both switches on: SAM head,
    bn.encode(use_kernel=True), the packet, bn.decode(use_kernel=True),
    SAM tail, llm_generate on the use_flash config, mask decode. Returns
    (mask_logits, answer_logits, tokens) as numpy, and the packet."""
    from repro_torch.core import bottleneck as bn
    from repro_torch.core import packets as pk
    from repro_torch.core import vlm
    from repro_torch.core.streams import _host
    tier, img, query, ctx = frame
    pcfg, p, bp = fx.pcfg, fx.params, fx.bottlenecks[tier.name]
    a = vlm.sam_head(p, pcfg, img)
    codes, scales = bn.encode(bp, a, use_kernel=True)
    pkt = pk.make_insight_packet(i, 0.0, tier.name, _host(codes),
                                 _host(scales), clip_feats=_host(ctx))
    a = bn.decode(bp, fx._dev(pkt.content["codes"]),
                  fx._dev(pkt.content["scales"]), out_dtype=pcfg.sam.adtype,
                  use_kernel=True)
    feats = vlm.sam_tail(p, pcfg, a)
    tokens, logits0, seg = vlm.llm_generate(p, fx._gen_pcfg, ctx, query,
                                            MAX_NEW_TOKENS)
    mask = vlm.mask_decode(p, pcfg, feats, seg)
    return (_host(mask), _host(logits0), _host(tokens)), pkt


def _split_run(fx, frames):
    return [split_point(fx, f, i)[0] for i, f in enumerate(frames)]


def split_point_phase(fx, pcfg, seed):
    """10c: one frame per tier through the split point with both switches
    on, counters from 0: exactly one encode and one decode launch per
    frame, one flash launch per layer and frame. Then (a) a replay with
    every launch of the three kernels held against its plain version on
    that launch's own inputs (outputs bit-equal to the counted run's);
    (b) a replay with flash's plain version in its place, every prefill
    layer also computed with the kernel on the same input and held to
    LAYER_RTOL (flash_layer_check), its tokens equal and mask logits within
    SDPA_PATH_RTOL of the counted run's, and (c) one with the bottleneck
    pair's plain versions in theirs, every frame's split point also
    computed with the kernels on the same input and held to LAYER_RTOL
    (``layer_check`` kind "split"): tokens equal, mask logits within
    PATH_RTOL, each reading on its own. Times one frame's edge encode and
    cloud decode."""
    from repro_torch.core import bottleneck as bn
    from repro_torch.core import vlm
    from repro_torch.kernels.bottleneck import ops as bops
    from repro_torch.kernels.bottleneck import ref as bref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    L = pcfg.llm.num_layers
    frames = split_frames(fx, pcfg, seed)
    n = len(frames)
    _reset_launch_counts()
    t0 = _sync_s()
    outs = _split_run(fx, frames)
    wall = _sync_s() - t0
    launches = _launch_counts()
    expect = _only(bottleneck_encode=n, bottleneck_decode=n,
                   flash_attention=n * L,
                   decode_attention=n * MAX_NEW_TOKENS * L)
    log(f"[split] split point: {n} Insight frames (ranks "
        f"{[fx.bottlenecks[f[0].name]['enc'].shape[1] for f in frames]}), "
        f"wall {wall:.2f} s; launches {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"split-point launches {launches}, expected "
                             f"{expect}")
    g = pcfg.image_size // pcfg.patch_size \
        * int(round(max(1, pcfg.mask_pixels_per_patch) ** 0.5))
    for i, (mask, logits, tokens) in enumerate(outs):
        if (mask.shape != (1, g, g)
                or logits.shape != (1, pcfg.llm.vocab_size)
                or tokens.shape != (1, MAX_NEW_TOKENS)):
            raise AssertionError(f"split frame {i}: bad output shapes")
        if not all(np.isfinite(a).all() for a in (mask, logits)):
            raise AssertionError(f"split frame {i}: non-finite output")
    out = {"wall_s": wall, "launches": launches, "expected_launches": expect,
           "tokens": [o[2].tolist()[0] for o in outs]}

    # (a) every launch against its plain version on its own inputs
    errs = {"flash_attention": [], "bottleneck_encode": [],
            "bottleneck_decode": []}
    # output elements not bit-equal to the plain version's, and elements
    not_equal = {k: [0, 0] for k in errs}
    enc, dec, fl = (bops.bottleneck_encode, bops.bottleneck_decode,
                    fops.flash_attention)

    def count(name, out, want):
        not_equal[name][0] += int((out != want).sum())
        not_equal[name][1] += out.numel()

    def enc_checked(x, w):
        codes, scales = enc(x, w)
        r = w.shape[1]
        want_c, want_s = bref.encode_ref(x.reshape(-1, x.shape[-1]), w)
        errs["bottleneck_encode"].append(codes_held_against(
            "bottleneck_encode on the split point's inputs",
            codes.reshape(-1, r), scales.reshape(-1, 1), want_c, want_s))
        count("bottleneck_encode", codes.reshape(-1, r), want_c)
        return codes, scales

    def dec_checked(codes, scales, w, out_dtype=torch.float32):
        y = dec(codes, scales, w, out_dtype)
        d, r = w.shape[1], w.shape[0]
        want = bref.decode_ref(codes.reshape(-1, r), scales.reshape(-1, 1),
                               w, out_dtype)
        errs["bottleneck_decode"].append(held_against(
            "bottleneck_decode on the split point's inputs",
            y.reshape(-1, d), want, DECODE_TOL[out_dtype]))
        count("bottleneck_decode", y.reshape(-1, d), want)
        return y

    def flash_checked(q, k, v, causal=True, block_q=128, block_k=128):
        o = fl(q, k, v, causal=causal)
        want = fref.attention_ref(q, k, v, causal=causal)
        errs["flash_attention"].append(held_against(
            "flash_attention on the split point's inputs", o, want))
        count("flash_attention", o, want)
        return o

    with mock.patch.object(bops, "bottleneck_encode", enc_checked), \
            mock.patch.object(bops, "bottleneck_decode", dec_checked), \
            mock.patch.object(fops, "flash_attention", flash_checked):
        checked = _split_run(fx, frames)
    if [len(v) for v in errs.values()] != [n * L, n, n]:
        raise AssertionError(f"held {[len(v) for v in errs.values()]} "
                             f"launches against their plain versions, "
                             f"expected {[n * L, n, n]}")
    for a, b in zip(outs, checked):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError("the checked replay's outputs differ from "
                                 "the counted run's")
    enc_worst = max(e[1] for e in errs["bottleneck_encode"])
    log(f"[split] every launch on its own inputs agrees with its plain "
        f"version: flash {len(errs['flash_attention'])} launches, max abs "
        f"err {max(errs['flash_attention']):.3g}; encode {n}: codes off by "
        f"<= {max(e[0] for e in errs['bottleneck_encode'])} on <= "
        f"{enc_worst:.3g} of entries, scales max abs err "
        f"{max(e[2] for e in errs['bottleneck_encode']):.3g}; decode {n}: "
        f"max abs err {max(errs['bottleneck_decode']):.3g}; output elements "
        f"not bit-equal: " + ", ".join(f"{k} {a} of {b}" for k, (a, b) in
                                       not_equal.items()))
    out["launches_checked"] = {k: len(v) for k, v in errs.items()}
    out["elements_not_bit_equal"] = not_equal
    out["max_abs_err"] = {
        "flash_attention": max(errs["flash_attention"]),
        "bottleneck_encode": max(e[0] for e in errs["bottleneck_encode"]),
        "bottleneck_decode": max(errs["bottleneck_decode"])}
    out["encode_codes_off_frac"] = enc_worst
    out["encode_scales_max_abs_err"] = max(
        e[2] for e in errs["bottleneck_encode"])

    # (b), (c): each kernel kind's plain version in its place, on its own,
    # each with its per-layer check
    flash_plain, out["layers"] = flash_layer_check(
        "10c split point", lambda: _split_run(fx, frames))
    if out["layers"]["layers"] != n * L:
        raise AssertionError(f"checked {out['layers']['layers']} prefill "
                             f"layers, expected {n * L}")
    bn_plain, out["split_layers"] = layer_check(
        "split", "10c split point", lambda: _split_run(fx, frames))
    if len(out["split_layers"]["frames"]) != n:
        raise AssertionError(f"checked {len(out['split_layers']['frames'])}"
                             f" frames at the split point, expected {n}")
    failed = []
    for label, other, limit in (
            ("flash_attention", flash_plain, SDPA_PATH_RTOL),
            ("bottleneck pair", bn_plain, PATH_RTOL)):
        per_frame = [{"mask_logits": _rel(a[0], b[0]),
                      "answer_logits": _rel(a[1], b[1]),
                      "tokens_equal": bool(np.array_equal(a[2], b[2]))}
                     for a, b in zip(outs, other)]
        worst = max(f["mask_logits"] for f in per_frame)
        out[f"rel_err_plain_{label.replace(' ', '_')}"] = per_frame
        log(f"[split] plain {label} in its place: mask_logits norm-wise "
            f"relative error {worst:.3g} (limit {limit}); per frame "
            + ", ".join(f"{f['mask_logits']:.3g}" for f in per_frame)
            + "; answer_logits per frame "
            + ", ".join(f"{f['answer_logits']:.3g}" for f in per_frame)
            + f"; tokens equal {[f['tokens_equal'] for f in per_frame]}")
        if not (worst <= limit and all(f["tokens_equal"]
                                           for f in per_frame)):
            failed.append(f"{label}: mask_logits off by {worst:.3g} (limit "
                          f"{limit}) or tokens differ")
    if failed:
        raise AssertionError(f"split point against each kernel kind's plain "
                             f"version: {failed}")

    # one frame's edge encode and cloud decode, warm, host wall to a sync
    tier, img, _, _ = frames[0]
    bp = fx.bottlenecks[tier.name]
    with torch.inference_mode():
        a = vlm.sam_head(fx.params, pcfg, img)
        times = {}
        for _ in range(2):
            t0 = _sync_s()
            codes, scales = bn.encode(bp, a, use_kernel=True)
            times["encode_ms"] = (_sync_s() - t0) * 1e3
            t0 = _sync_s()
            bn.decode(bp, codes, scales, out_dtype=pcfg.sam.adtype,
                      use_kernel=True)
            times["decode_ms"] = (_sync_s() - t0) * 1e3
    out["frame_wall_ms"] = dict(times, rank=int(bp["enc"].shape[1]))
    log(f"[split] one frame at rank {bp['enc'].shape[1]}, warm: edge encode "
        f"{times['encode_ms']:.3f} ms, cloud decode {times['decode_ms']:.3f} "
        f"ms (host wall to a synchronise)")
    return out


def split_phase(executor, pcfg, seed, reqs, results, frames,
                inflight_results, inflight_paged):
    """Phase 10: LISA-7B at full width on an executor with
    ``llm.use_flash=True`` that shares the serving executor's weight
    tensors: 10a microbatch, 10b in-flight, 10c split point."""
    from repro_torch.core.streams import DualStreamExecutor
    fcfg = dataclasses.replace(pcfg, llm=pcfg.llm.replace(use_flash=True))
    fx = DualStreamExecutor(pcfg=fcfg, params=executor.params,
                            bottlenecks=executor.bottlenecks,
                            lut=executor.lut, max_new_tokens=MAX_NEW_TOKENS,
                            flash_decode=True, device=executor.device)
    if fx.params["llm"]["embed"] is not executor.params["llm"]["embed"]:
        raise AssertionError("the use_flash executor copied the weights")
    return {"microbatch": split_microbatch(fx, reqs, results),
            "inflight": split_inflight(fx, frames, inflight_results,
                                       inflight_paged),
            "split_point": split_point_phase(fx, fcfg, seed)}


# ---------------------------------------------------------------------------
# phase 12 (engine): the AveryEngine front door
# ---------------------------------------------------------------------------

# six frames from two operators through OperatorSession.submit: (operator,
# prompt, mission time). Each prompt classifies as Context or Insight
# (core/intent.py), so both edge stages run on the card.
ENGINE_FRAMES = (
    ("uav-A", "segment the stranded person on the roof", 0.0),
    ("uav-B", "how many boats are there", 0.4),
    ("uav-A", "describe the flooded area", 0.8),
    ("uav-B", "outline the collapsed bridge", 1.2),
    ("uav-A", "is there anyone on the road", 1.6),
    ("uav-B", "highlight the rescue boat", 2.0),
)
# 12b: after one pump, uav-A sends frame 0 again (it joins the running
# batch and hits the prefix store)
ENGINE_REPEAT_T = 2.4
# 12d: a blackout window over frame 0's send, and a decode fault on the
# second cloud_decode_rows call, when both of two rows are live
FAULT_BLACKOUT = ((0.0, 0.3),)
FAULT_DECODE_CALL = 1
# the counters the two fault runs must end with. They are structural: the
# blackout catches only sends that start in its window, and only frame 0
# is sent there (the others start at 0.4 s or later, the retry after a
# 0.5 s backoff); the stage fault is at a decode call's index. Neither
# depends on a packet's size or the trace's rates, so they hold for
# LISA-7B's packets on any paper_trace seed. The CPU tests get the same
# from the reference's engine on lisa_mini (tests/test_torch_engine.py)
FAULT_COUNTERS = {
    "blackout": {"retries": 1, "downshifts": 1, "blackouts": 0,
                 "cloud_errors": 0, "stage_faults": 0},
    "stage": {"retries": 2, "downshifts": 0, "blackouts": 0,
              "cloud_errors": 0, "stage_faults": 1},
}
# timing: engine pumps on four live rows, each timed whole and around the
# bare decoder step it makes, on an executor with enough new tokens to
# keep the rows live through every turn
TIMING_TURNS = 24
TIMING_TOKENS = TIMING_TURNS + 2 * INFLIGHT_SLOTS
# the host cost a step counts as resolved when its quartiles lie within
# this many ms of its median
TIMING_RESOLVE_MS = 0.5
# 12c: a near tie may move a request's tokens off speculative=None's only
# where the two tokens' logits move by at most TIE_ULPS bf16 steps at
# their magnitude between the runs, and at most MAX_TIES requests may
# (2 of 7 measured on the H100: 0 to 2 bf16 steps at the two tokens)
TIE_ULPS = 4
MAX_TIES = 2


def engine_frames(pcfg, seed):
    """Seeded images and queries for ENGINE_FRAMES: [(images, query)]."""
    rng = np.random.RandomState(seed + 12)
    return [(rng.rand(1, pcfg.image_size, pcfg.image_size,
                      3).astype(np.float32),
             rng.randint(0, pcfg.llm.vocab_size,
                         (1, QUERY_LEN)).astype(np.int32))
            for _ in ENGINE_FRAMES]


def submit_frames(engine, frames, which, sessions=None):
    """Submit ENGINE_FRAMES[i] for i in ``which`` through each operator's
    session (made on first use). Returns (futures, sessions)."""
    sessions = {} if sessions is None else sessions
    futs = []
    for i in which:
        op, prompt, t = ENGINE_FRAMES[i]
        sess = sessions.get(op) or sessions.setdefault(op,
                                                       engine.session(op))
        images, query = frames[i]
        futs.append(sess.submit(prompt=prompt, images=images, query=query,
                                time_s=t))
    return futs, sessions


def delivered_packets(transport):
    """{request id: the packet of its last delivered TransmitRecord}."""
    return {r.packet.seq_id: r.packet for r in transport.records
            if r.delivered}


def _engine_sessions(engine):
    """uav-A with the default goal (accuracy), uav-B prioritising
    throughput: the two select different Insight tiers."""
    from repro_torch.core.controller import MissionGoal
    return {"uav-A": engine.session("uav-A"),
            "uav-B": engine.session(
                "uav-B", goal=MissionGoal.PRIORITIZE_THROUGHPUT)}


def fault_counters(stats):
    return {k: stats[k] for k in FAULT_COUNTERS["stage"]}


def fault_blackout_run(eng, executor, frames, trace):
    """12d, blackout: four frames through a FaultInjector over a
    ChannelTransport on ``trace`` whose blackout window covers frame 0's
    send, with a RetryPolicy, in flight on 4 slots. ``eng`` is the engine
    package (the port's here; the CPU tests also pass the reference's).
    Returns (engine, responses)."""
    engine = eng.AveryEngine(
        lut=executor.lut, executor=executor, batching="inflight",
        max_batch=4, transport=eng.FaultInjector(
            eng.ChannelTransport.from_trace(trace),
            blackouts=FAULT_BLACKOUT),
        retry=eng.RetryPolicy(max_attempts=3, backoff_base_s=0.5),
        debug_invariants=True)
    futs, _ = submit_frames(engine, frames, range(4))
    engine.drain()
    return engine, [f.result() for f in futs]


def fault_stage_run(eng, executor, packets, faulty=True):
    """12d, stage fault: two packets through ``submit_packet`` on 4 slots,
    the executor wrapped in a FaultyExecutor that raises CloudStageError
    on decode call FAULT_DECODE_CALL (both rows live), with a RetryPolicy
    (``faulty=False``: the same schedule fault-free). ``packets``:
    [(packet, query, Intent)]. Returns (engine, responses)."""
    if faulty:
        executor = eng.FaultyExecutor(
            executor, fail_at={"cloud_decode_rows": [FAULT_DECODE_CALL]})
    engine = eng.AveryEngine(
        lut=executor.lut, executor=executor, batching="inflight",
        max_batch=4, retry=eng.RetryPolicy(max_attempts=3,
                                           backoff_base_s=0.1),
        debug_invariants=True)
    futs = [engine.submit_packet(p, q, it, time_s=0.5 * i)
            for i, (p, q, it) in enumerate(packets)]
    engine.drain()
    return engine, [f.result() for f in futs]


def _engine_outputs(pcfg, responses, new_tokens=MAX_NEW_TOKENS):
    """Every response served, finite, with the expected shapes."""
    g = pcfg.image_size // pcfg.patch_size \
        * int(round(max(1, pcfg.mask_pixels_per_patch) ** 0.5))
    for r in responses:
        if r.failure is not None or r.tokens is None:
            raise AssertionError(f"request {r.request_id} not served: "
                                 f"{r.failure}")
        arrs = [r.answer_logits, r.tokens]
        if r.tokens.shape != (1, new_tokens) or \
                r.answer_logits.shape != (1, pcfg.llm.vocab_size):
            raise AssertionError(f"request {r.request_id}: bad shapes")
        if r.intent.value == "insight":
            if r.mask_logits is None or r.mask_logits.shape != (1, g, g):
                raise AssertionError(f"request {r.request_id}: bad mask")
            arrs.append(r.mask_logits)
        if not all(np.isfinite(a).all() for a in arrs):
            raise AssertionError(f"request {r.request_id}: non-finite")


def _one_shot(executor, responses, packets, queries, label):
    """Each response's tokens equal those of its own packet through the
    one-shot ``cloud_generate_batch``."""
    for r in responses:
        want = executor.cloud_generate_batch([packets[r.request_id]],
                                             [queries[r.request_id]])[0]
        if not np.array_equal(r.tokens, want[-1]):
            raise AssertionError(f"{label}: request {r.request_id} tokens "
                                 f"{r.tokens} != one-shot {want[-1]}")
    log(f"[engine] {label}: {len(responses)} requests' tokens equal the "
        f"one-shot cloud_generate_batch on the packets their transport "
        f"carried")


def _log_requests(label, responses, transport):
    recs = {}
    for rec in transport.records:
        recs.setdefault(rec.packet.seq_id, []).append(rec)
    for r in responses:
        sends = ", ".join(
            f"[{x.start_s:.3f}, {x.end_s:.3f}] s {x.packet.payload_bytes} B"
            f"{'' if x.delivered else ' lost'}"
            for x in recs.get(r.request_id, []))
        log(f"[engine] {label}: request {r.request_id} ({r.operator_id}) "
            f"{r.intent.value}, tier {r.tier_name}, attempts {r.attempts}, "
            f"sent {sends}; tokens {r.tokens.tolist()[0]}")


def engine_generate(executor, pcfg, frames, trace):
    """12a: ``batching="generate"``, AdaptivePolicy over a ChannelTransport
    on ``trace``, two sessions of different mission goals, six frames
    through ``session.submit``. Counters from 0 just before: contiguous
    decode launches must be steps x layers and no other kernel."""
    from repro_torch import engine as eng
    engine = eng.AveryEngine(
        lut=executor.lut, executor=executor, batching="generate",
        max_batch=4, transport=eng.ChannelTransport.from_trace(trace),
        policy=eng.AdaptivePolicy())
    sessions = _engine_sessions(engine)
    _reset_launch_counts()
    t0 = _sync_s()
    futs, _ = submit_frames(engine, frames, range(len(ENGINE_FRAMES)),
                            sessions)
    engine.drain()
    wall = _sync_s() - t0
    launches = _launch_counts()
    responses = [f.result() for f in futs]
    stats = engine.stats
    steps = stats["n_microbatches"] * MAX_NEW_TOKENS
    expect = _only(decode_attention=steps * pcfg.llm.num_layers)
    log(f"[engine] 12a generate: {len(responses)} requests in "
        f"{stats['n_microbatches']} microbatches ({steps} decode steps), "
        f"wall {wall:.2f} s; launches {launches} (expected {expect})")
    if launches != expect or steps == 0:
        raise AssertionError(f"12a: launches {launches}, expected {expect}")
    kinds = {r.intent.value for r in responses}
    if kinds != {"context", "insight"}:
        raise AssertionError(f"12a: intents {kinds}")
    _engine_outputs(pcfg, responses)
    _log_requests("12a", responses, engine.transport)
    packets = delivered_packets(engine.transport)
    _one_shot(executor, responses, packets,
              [q for _, q in frames], "12a")
    return {"wall_s": wall, "launches": launches, "expected": expect,
            "microbatches": stats["n_microbatches"],
            "intents": [r.intent.value for r in responses],
            "tiers": [r.tier_name for r in responses]}


def engine_inflight(executor, pcfg, frames, trace):
    """12b: ``batching="inflight"`` through a QoSScheduler, the sessions
    and frames of 12a, then uav-A's frame 0 again after a pump. Paged
    launches must be decode steps x layers and no other kernel; tokens
    equal the one-shot path's; a late join and a prefix hit. Then the
    reference's canonical in-flight scenario (three packets through
    ``submit_packet``, two slots) for the ``stats()`` key set. Returns
    (report, the engine, [(packet, query, Intent)] in request order)."""
    from repro_torch import engine as eng
    from repro_torch.core.intent import Intent
    engine = eng.AveryEngine(
        lut=executor.lut, executor=executor, batching="inflight",
        max_batch=INFLIGHT_SLOTS, transport=eng.ChannelTransport.from_trace(
            trace), policy=eng.AdaptivePolicy(),
        scheduler=eng.QoSScheduler(), wallclock=time.perf_counter)
    sessions = _engine_sessions(engine)
    _reset_launch_counts()
    t0 = _sync_s()
    futs, _ = submit_frames(engine, frames, range(len(ENGINE_FRAMES)),
                            sessions)
    engine.pump()
    images, query = frames[0]
    futs.append(sessions["uav-A"].submit(
        prompt=ENGINE_FRAMES[0][1], images=images, query=query,
        time_s=ENGINE_REPEAT_T))
    engine.drain()
    wall = _sync_s() - t0
    launches = _launch_counts()
    responses = [f.result() for f in futs]
    stats = engine.stats
    expect = _only(paged_decode_attention=stats["inflight_steps"]
                   * pcfg.llm.num_layers)
    log(f"[engine] 12b inflight: {len(responses)} requests on "
        f"{INFLIGHT_SLOTS} slots in {stats['inflight_steps']} decode steps "
        f"(mean live slots {stats['mean_live_slots']:.2f}), wall "
        f"{wall:.2f} s; joined at steps "
        f"{[r.joined_step for r in responses]}, prefix hits "
        f"{[int(r.prefix_hit) for r in responses]}, preemptions "
        f"{[r.preemptions for r in responses]}; launches {launches} "
        f"(expected {expect})")
    if launches != expect or stats["inflight_steps"] == 0:
        raise AssertionError(f"12b: launches {launches}, expected {expect}")
    if max(r.joined_step for r in responses) < 1 or \
            not any(r.prefix_hit for r in responses):
        raise AssertionError("12b: no late join or no prefix hit")
    _engine_outputs(pcfg, responses)
    _log_requests("12b", responses, engine.transport)
    packets = delivered_packets(engine.transport)
    queries = [q for _, q in frames] + [query]
    _one_shot(executor, responses, packets, queries, "12b")
    engine.kv_pool.check_invariants()
    # the reference's canonical in-flight scenario, for the key set
    canon = eng.AveryEngine(lut=executor.lut, executor=executor,
                            batching="inflight", max_batch=2)
    order = [(packets[r.request_id], queries[r.request_id],
              Intent(packets[r.request_id].kind)) for r in responses]
    for i, (p, q, it) in enumerate(order[:3]):
        canon.submit_packet(p, q, it, time_s=float(i))
    canon.drain()
    with open(os.path.join(REPO, "tests", "fixtures",
                           "engine_stats_keys.json")) as f:
        want_keys = json.load(f)
    if sorted(canon.stats) != want_keys:
        raise AssertionError(
            f"12b: stats() keys differ from the fixture: "
            f"{sorted(set(canon.stats) ^ set(want_keys))}")
    log(f"[engine] 12b: stats() keys of the canonical in-flight scenario "
        f"equal tests/fixtures/engine_stats_keys.json ({len(want_keys)} "
        f"keys); compiled_stages {canon.stats['compiled_stages']}")
    return ({"wall_s": wall, "launches": launches, "expected": expect,
             "steps": stats["inflight_steps"],
             "joined_steps": [r.joined_step for r in responses],
             "prefix_hits": [bool(r.prefix_hit) for r in responses],
             "preemptions": [r.preemptions for r in responses],
             "stats_keys": len(want_keys)}, engine, order)


def _serve_packets(engine, order):
    futs = [engine.submit_packet(p, q, it, time_s=0.4 * i)
            for i, (p, q, it) in enumerate(order)]
    engine.pump()
    return futs


def _recording(executor, engine, name, calls, logits):
    """Wrap the executor's stage ``name`` (``cloud_decode_rows`` or
    ``cloud_verify_rows``) of ``engine``'s decoder: count its calls and
    record, for every live row, the logits that predict each of the row's
    next tokens, ``logits[(request id, token index)]`` (a verify chunk's
    query i predicts token n + i of a row with n tokens)."""
    stage = getattr(executor, name)

    def run(*args):
        calls[name] += 1
        dec, = engine._inflight.values()
        rows = {s: (st.req.seq_id, len(st.tokens))
                for s, st in dec.active.items()}
        out = stage(*args)
        for s, (rid, n) in rows.items():
            if name == "cloud_decode_rows":
                logits[(rid, n)] = out[0][s]
            else:
                for i in range(int(args[6][s])):
                    logits[(rid, n + i)] = out[0][s, i]
        return out
    return run


def _bf16_steps(x, y):
    """|x - y| in bf16 steps (2^(e - 7) for the larger magnitude in
    [2^e, 2^(e + 1)))."""
    top = max(abs(float(x)), abs(float(y)))
    if top == 0.0:
        return 0.0
    return abs(float(x) - float(y)) / 2.0 ** (math.floor(math.log2(top)) - 7)


def engine_spec(executor, pcfg, order):
    """12c: ``speculative=3`` on phase 9's executor (6 new tokens over
    pages of 4, the serving weights), 12b's packets through
    ``submit_packet``. Verify, paged and contiguous launches must be
    verify steps, plain steps and draft steps, each x layers. Tokens equal
    the same engine's with ``speculative=None``, but for at most MAX_TIES
    near ties of the two leading logits. Where a request's tokens first
    differ, take the logits both runs computed for that token on the same
    prefix (S through the verify kernel, P through the paged decode
    kernel), the speculative token a and the plain one b: a must lead S
    and b lead P (so a kept draft is the verify logits' pick), S[a] and
    P[a], and S[b] and P[b], must differ by at most TIE_ULPS bf16 steps,
    and S and P must agree within PATH_RTOL norm-wise, as a kernel's path
    and its plain version's do. The ``speculative=None`` run's margin
    P[b] - P[a] is printed beside the two differences."""
    from repro_torch import engine as eng
    from repro_torch.core.streams import DualStreamExecutor
    sx = DualStreamExecutor(pcfg=pcfg, params=executor.params,
                            bottlenecks=executor.bottlenecks,
                            lut=executor.lut,
                            max_new_tokens=SPEC_MAX_NEW_TOKENS,
                            flash_decode=True, page_size=SPEC_PAGE,
                            device=executor.device)
    runs = []
    for speculative in (3, None):
        engine = eng.AveryEngine(lut=sx.lut, executor=sx,
                                 batching="inflight",
                                 max_batch=INFLIGHT_SLOTS,
                                 speculative=speculative)
        calls = {"cloud_verify_rows": 0, "cloud_decode_rows": 0}
        logits = {}
        for name in calls:
            setattr(sx, name, _recording(sx, engine, name, calls, logits))
        try:
            _reset_launch_counts()
            t0 = _sync_s()
            futs = _serve_packets(engine, order)
            decoders = list(engine._inflight.values())
            engine.drain()
            wall = _sync_s() - t0
            launches = _launch_counts()
        finally:
            for name in calls:
                delattr(sx, name)
        runs.append((engine, [f.result() for f in futs], calls, logits,
                     decoders, wall, launches))
    engine, responses, calls, spec_logits, decoders, wall, launches = runs[0]
    L = pcfg.llm.num_layers
    draft_steps = sum(d.draft.n_steps for d in decoders
                      if d.draft is not None)
    expect = _only(paged_verify_attention=calls["cloud_verify_rows"] * L,
                   paged_decode_attention=calls["cloud_decode_rows"] * L,
                   decode_attention=draft_steps * L)
    spec = {k: v for k, v in engine.stats.items() if k.startswith("spec_")}
    log(f"[engine] 12c speculative=3: {len(responses)} requests in "
        f"{calls['cloud_verify_rows']} verify and "
        f"{calls['cloud_decode_rows']} plain steps, {draft_steps} draft "
        f"steps, wall {wall:.2f} s; launches {launches} (expected "
        f"{expect})")
    log(f"[engine] 12c SpecStats {json.dumps(spec)}")
    if launches != expect or not calls["cloud_verify_rows"] or \
            not spec["spec_drafted"]:
        raise AssertionError(f"12c: launches {launches}, expected {expect}")
    _engine_outputs(pcfg, responses, SPEC_MAX_NEW_TOKENS)
    _, base, _, plain_logits, _, _, _ = runs[1]
    ties = []
    for r, b in zip(responses, base):
        x, y = r.tokens[0], b.tokens[0]
        if np.array_equal(x, y):
            continue
        d = int(np.argmax(x != y))
        key = (r.request_id, d)
        if key not in spec_logits or key not in plain_logits:
            raise AssertionError(f"12c: request {r.request_id} tokens {x} "
                                 f"!= speculative=None {y} at token {d}, "
                                 f"with no logits recorded for it")
        S, P = (np.asarray(v, np.float64) for v in (spec_logits[key],
                                                    plain_logits[key]))
        a, b = int(x[d]), int(y[d])
        tie = {"request": r.request_id, "token": d, "spec": a, "plain": b,
               "margin": float(P[b] - P[a]),
               "diff_spec_token": float(S[a] - P[a]),
               "diff_plain_token": float(S[b] - P[b]),
               "ulps_spec_token": _bf16_steps(S[a], P[a]),
               "ulps_plain_token": _bf16_steps(S[b], P[b]),
               "spec_leads": bool(S[a] >= S.max()),
               "plain_leads": bool(P[b] >= P.max()),
               "max_diff": float(np.abs(S - P).max()), "rel": _rel(S, P)}
        ties.append(tie)
        log(f"[engine] 12c: request {r.request_id} tokens {x.tolist()} vs "
            f"speculative=None {y.tolist()}, first differing at token {d}: "
            f"speculative=None margin {tie['margin']:.4g} of {b} over {a}; "
            f"the verify path's logits there differ by "
            f"{tie['diff_spec_token']:+.4g} at {a} and "
            f"{tie['diff_plain_token']:+.4g} at {b} "
            f"({tie['ulps_spec_token']:.3g} and {tie['ulps_plain_token']:.3g}"
            f" bf16 steps, limit {TIE_ULPS}); {a} leads the verify logits: "
            f"{tie['spec_leads']}, {b} the decode logits: "
            f"{tie['plain_leads']}; max abs {tie['max_diff']:.4g}, "
            f"norm-wise {tie['rel']:.3g} (limit {PATH_RTOL})")
        if not (tie["spec_leads"] and tie["plain_leads"]
                and tie["ulps_spec_token"] <= TIE_ULPS
                and tie["ulps_plain_token"] <= TIE_ULPS
                and tie["rel"] <= PATH_RTOL):
            raise AssertionError(f"12c: request {r.request_id} differs from "
                                 f"speculative=None beyond a near tie: "
                                 f"{tie}")
    log(f"[engine] 12c: {len(responses) - len(ties)} of {len(responses)} "
        f"requests' tokens equal the speculative=None engine's; "
        f"{len(ties)} differ from a near tie on (at most {MAX_TIES})")
    if len(ties) > MAX_TIES:
        raise AssertionError(f"12c: {len(ties)} requests differ from "
                             f"speculative=None, more than {MAX_TIES}")
    return {"wall_s": wall, "launches": launches, "expected": expect,
            "steps": calls, "draft_steps": draft_steps, "spec_stats": spec,
            "ties": ties}


def engine_faults(executor, pcfg, frames, order, trace):
    """12d: the blackout run and the stage-fault run, each held to
    FAULT_COUNTERS; the blacked-out request retried, downshifted and
    served; the stage fault's victims equal to their fault-free run."""
    from repro_torch import engine as eng
    out = {}
    engine, responses = fault_blackout_run(eng, executor, frames, trace)
    got = fault_counters(engine.stats)
    _engine_outputs(pcfg, responses)
    hit = responses[0]
    kinds = [e.kind for e in hit.events]
    tiers = [e.data.get("tier") for e in hit.events
             if e.kind == "tier_selected"]
    log(f"[engine] 12d blackout: request 0 events {kinds}, tiers {tiers}, "
        f"attempts {hit.attempts}; counters {got}")
    if got != FAULT_COUNTERS["blackout"] or hit.attempts != 2 or \
            "blackout" not in kinds or len(set(tiers)) != 2:
        raise AssertionError(f"12d blackout: counters {got}, expected "
                             f"{FAULT_COUNTERS['blackout']}")
    out["blackout"] = {"counters": got, "tiers": tiers,
                       "attempts": hit.attempts}
    engine, responses = fault_stage_run(eng, executor, order[:2])
    got = fault_counters(engine.stats)
    _, clean = fault_stage_run(eng, executor, order[:2], faulty=False)
    for r, c in zip(responses, clean):
        if r.attempts != 2 or not np.array_equal(r.tokens, c.tokens):
            raise AssertionError(f"12d stage fault: request {r.request_id}"
                                 f" attempts {r.attempts}, tokens "
                                 f"{r.tokens} vs fault-free {c.tokens}")
    log(f"[engine] 12d stage fault: both rows failed at decode call "
        f"{FAULT_DECODE_CALL}, retried and equal their fault-free run's "
        f"tokens; counters {got}")
    if got != FAULT_COUNTERS["stage"]:
        raise AssertionError(f"12d stage fault: counters {got}, expected "
                             f"{FAULT_COUNTERS['stage']}")
    out["stage"] = {"counters": got}
    return out


def engine_timings(executor, order, card):
    """TIMING_TURNS warm engine pumps on four live rows (an executor of
    TIMING_TOKENS new tokens that shares the serving weights), each timed
    whole and around the bare ``InflightDecoder.step`` it makes, both on
    the host clock after a synchronise (a step ends in a copy of its
    logits to the host). The front door's host cost a step is the median
    of the pumps' own differences, pump minus its step: one call holds
    both, so the host's drift between calls cancels. It is printed as
    resolved when its quartiles lie within TIMING_RESOLVE_MS of it."""
    from repro_torch import engine as eng
    from repro_torch.core.streams import DualStreamExecutor
    tx = DualStreamExecutor(pcfg=executor.pcfg, params=executor.params,
                            bottlenecks=executor.bottlenecks,
                            lut=executor.lut, max_new_tokens=TIMING_TOKENS,
                            flash_decode=True, device=executor.device)
    engine = eng.AveryEngine(lut=tx.lut, executor=tx, batching="inflight",
                             max_batch=INFLIGHT_SLOTS)
    rows = [o for o in order if o[0].kind == "context"][:INFLIGHT_SLOTS]
    rows += order[:INFLIGHT_SLOTS - len(rows)]
    for p, q, it in rows:
        engine.submit_packet(p, q, it, time_s=0.0)
    dec, = engine._inflight.values()
    if len(dec.active) != INFLIGHT_SLOTS:
        raise AssertionError("timing decoder has idle slots")
    turns = []
    step = dec.step

    def timed_step():
        t0 = _sync_s()
        out = step()
        turns[-1]["step"] = (_sync_s() - t0) * 1e3
        return out
    dec.step = timed_step
    try:
        for _ in range(TIMING_TURNS):
            turns.append({})
            t0 = _sync_s()
            engine.pump()
            turns[-1]["pump"] = (_sync_s() - t0) * 1e3
    finally:
        del dec.step
    if len(dec.active) != INFLIGHT_SLOTS or \
            any("step" not in t for t in turns):
        raise AssertionError("a timing pump made no step on every row")
    engine.drain()
    diff = [t["pump"] - t["step"] for t in turns]
    pump, step_ms = (float(np.median([t[k] for t in turns]))
                     for k in ("pump", "step"))
    q1, med, q3 = (float(np.percentile(diff, q)) for q in (25, 50, 75))
    resolved = max(med - q1, q3 - med) <= TIMING_RESOLVE_MS
    log(f"[engine] {TIMING_TURNS} warm engine.pump() calls on "
        f"{INFLIGHT_SLOTS} live rows, each timed whole and around its bare "
        f"InflightDecoder.step: pump median {pump:.3f} ms, step "
        f"{step_ms:.3f} ms; front-door host cost a step (pump minus its "
        f"step) median {med:.4f} ms, quartiles {q1:.4f} to {q3:.4f}, "
        f"{'resolved' if resolved else 'unresolved'} (limit "
        f"±{TIMING_RESOLVE_MS} ms) ({card})")
    return {"pump_ms": pump, "step_ms": step_ms, "host_cost_ms": med,
            "host_cost_quartiles_ms": [q1, q3], "resolved": resolved,
            "turns": turns}


def engine_phase(executor, pcfg, seed):
    """Phase 12: the AveryEngine front door at LISA-7B's full width on the
    serving weights: 12a generate, 12b in flight, 12c speculative, 12d
    faults, then timings."""
    from repro_torch.network import paper_trace
    frames = engine_frames(pcfg, seed)
    out = {"generate": engine_generate(executor, pcfg, frames,
                                       paper_trace(seed))}
    out["inflight"], engine, order = engine_inflight(
        executor, pcfg, frames, paper_trace(seed))
    stats = engine.stats
    keys = ("ttft_latency_p50_s", "ttft_throughput_p50_s",
            "transmit_p50_s", "decode_step_p50_s")
    out["stats"] = {k: stats[k] for k in keys}
    card = card_line()
    log(f"[engine] 12b stats(): TTFT p50 latency class "
        f"{stats['ttft_latency_p50_s']:.4f} s, throughput class "
        f"{stats['ttft_throughput_p50_s']:.4f} s, transmit p50 "
        f"{stats['transmit_p50_s']:.4f} s (mission clock: the simulated "
        f"uplink); decode step p50 {stats['decode_step_p50_s'] * 1e3:.2f} "
        f"ms over {stats['inflight_steps']} steps (wall, ending in the copy "
        f"of the step's logits to the host; {card})")
    out["spec"] = engine_spec(executor, pcfg, order)
    out["faults"] = engine_faults(executor, pcfg, frames, order,
                                  paper_trace(seed))
    out["timings"] = engine_timings(executor, order, card)
    return out


# ---------------------------------------------------------------------------
# phase 11: the zoo's Mamba path (falcon-mamba-7b, zamba2-7b)
# ---------------------------------------------------------------------------

# the two zoo configs of the path, each with its count of parameters (the
# reference's count_params) and its split point
ZOO = {"falcon-mamba-7b": 7_272_665_088, "zamba2-7b": 6_751_130_832}
ZOO_SPLIT = {"falcon-mamba-7b": 32}
ZOO_BATCH = 2
ZOO_PROMPT = 1024
ZOO_DECODE_PROMPT = 64
ZOO_NEW_TOKENS = 4
# decode against prefill on the same prompt: the decode step runs the
# causal conv as one contraction and the recurrence one token at a time,
# where the prefill sums tap by tap and scans; bf16 roundings of the
# layers' outputs differ, as between the LISA paths of SDPA_PATH_RTOL
DECODE_PREFILL_RTOL = 2.0 ** -3


def _within(label, value, limit):
    log(f"[zoo] {label}: {value:.3g} (limit {limit:.3g})")
    if not value <= limit:
        raise AssertionError(f"{label}: {value:.3g} beyond {limit:.3g}")
    return value


def _median_wall_ms(fn, n=3):
    walls = []
    for _ in range(n):
        t0 = _sync_s()
        fn()
        walls.append((_sync_s() - t0) * 1e3)
    return float(np.median(walls)), walls


def zoo_prefill_checks(params, cfg, batch, logits):
    """(a) after the counted prefill: a replay with every scan launch held
    against scan_ref on that launch's own inputs (its outputs are the
    kernel's, so the replay is the counted run again); a replay with
    scan_ref in the kernel's place (logits within PATH_RTOL); the plain
    path, ``use_ssm_kernel=False`` (the doubling scan; logits within
    SDPA_PATH_RTOL)."""
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    from repro_torch.models import prefill_step
    kernel = sops.chunked_scan
    seen = {"launches": 0, "max_abs_err": 0.0, "not_bit_equal": 0,
            "elements": 0}

    def held(decay, drive, **kw):
        h = kernel(decay, drive, **kw)
        torch.cuda.synchronize()
        err, off = scan_held_against(f"{cfg.name} scan launch "
                                     f"{seen['launches']}", h,
                                     sref.scan_ref(decay, drive), SCAN_TOL)
        seen["launches"] += 1
        seen["max_abs_err"] = max(seen["max_abs_err"], err)
        seen["not_bit_equal"] += off
        seen["elements"] += h.numel()
        return h

    with mock.patch.object(sops, "chunked_scan", held):
        again, _ = prefill_step(params, cfg, batch)
    if not torch.equal(again, logits):
        raise AssertionError(f"{cfg.name}: the checked replay's logits "
                             f"differ from the counted run's")
    log(f"[zoo] {cfg.name}: {seen['launches']} scan launches held against "
        f"scan_ref on their own inputs: max_abs_err "
        f"{seen['max_abs_err']:.3g} (rtol {SCAN_TOL[0]}, atol "
        f"{SCAN_TOL[1]}), {seen['not_bit_equal']} of {seen['elements']} "
        f"elements not bit-equal")
    with mock.patch.object(sops, "chunked_scan",
                           lambda d, x, **kw: sref.scan_ref(d, x)):
        plain, _ = prefill_step(params, cfg, batch)
    before = sops.scan_launches
    sdpa, _ = prefill_step(params, cfg.replace(use_ssm_kernel=False), batch)
    if sops.scan_launches != before:
        raise AssertionError(f"{cfg.name}: use_ssm_kernel=False launched "
                             f"the scan kernel")
    return {"per_launch": seen,
            "plain_replay_rel": _within(
                f"{cfg.name} last logits vs scan_ref replay (norm-wise)",
                _rel(logits, plain), PATH_RTOL),
            "plain_path_rel": _within(
                f"{cfg.name} last logits vs use_ssm_kernel=False "
                f"(norm-wise)", _rel(logits, sdpa), SDPA_PATH_RTOL)}


def zoo_decode(params, cfg, prompt, dev):
    """(b) the prompt through ``decode_step`` from ``init_cache`` (the
    reference's prefill hands SSM state to nothing), then
    ZOO_NEW_TOKENS greedy tokens fed back; counters from 0. The logits at
    the prompt's last position against ``prefill_step``'s."""
    from repro_torch.models import decode_step, init_cache, prefill_step
    S = prompt.shape[1]
    cache = init_cache(cfg, ZOO_BATCH, S + ZOO_NEW_TOKENS, dev)
    _reset_launch_counts()
    t0 = _sync_s()
    new, last = [], None
    for t in range(S + ZOO_NEW_TOKENS):
        tok = prompt[:, t:t + 1] if t < S else new[t - S]
        lg, cache = decode_step(params, cfg, cache, tok, t)
        if t == S - 1:
            last = lg
        if t >= S - 1 and len(new) < ZOO_NEW_TOKENS:
            new.append(torch.argmax(lg[:, -1], dim=-1)[:, None].int())
    wall = _sync_s() - t0
    counts = _launch_counts()
    if counts != _only():
        raise AssertionError(f"{cfg.name} decode launched port kernels: "
                             f"{counts}")
    tokens = torch.cat(new, dim=1)
    if not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: decoded token out of range")
    if not bool(torch.isfinite(last).all()):
        raise AssertionError(f"{cfg.name}: non-finite decode logits")
    want, _ = prefill_step(params, cfg, {"tokens": prompt})
    log(f"[zoo] {cfg.name} decode: prompt {S} + {ZOO_NEW_TOKENS} greedy "
        f"tokens in {wall:.2f} s, no kernel launches, tokens "
        f"{tokens.tolist()}")
    return {"steps": S + ZOO_NEW_TOKENS, "wall_s": wall,
            "tokens": tokens.tolist(),
            "vs_prefill_rel": _within(
                f"{cfg.name} decode logits at position {S - 1} vs "
                f"prefill_step (norm-wise)", _rel(last, want),
                DECODE_PREFILL_RTOL)}


def zoo_split(params, cfg, batch, k):
    """(c) ``SplitPlan(cfg, k)``: head_apply then tail_apply over the
    embedded prompt, counters from 0: k + (L - k) scan launches, the
    hidden state equal to ``forward``'s, the weights shared."""
    from repro_torch.core import SplitPlan
    from repro_torch.models import forward
    from repro_torch.models.common import causal_mask
    from repro_torch.models.model import _embed_inputs
    plan = SplitPlan(cfg, k)
    edge, cloud = plan.split_params(params)
    w = params["groups"][0]["mixer"]["in_proj"]
    if edge["groups"][0]["mixer"]["in_proj"].data_ptr() != w.data_ptr() \
            or cloud["groups"][0]["mixer"]["in_proj"].data_ptr() \
            != w[k].data_ptr():
        raise AssertionError("SplitPlan copied the weights")
    _, _, _, hidden = forward(params, cfg, batch)
    x, positions = _embed_inputs(params, cfg, batch)
    mask = causal_mask(x.shape[1], device=x.device)[None]
    _reset_launch_counts()
    mid = plan.head_apply(edge, x, positions, mask)
    torch.cuda.synchronize()
    head = _launch_counts()["ssm_scan"]
    out = plan.tail_apply(cloud, mid, positions, mask)
    torch.cuda.synchronize()
    counts = _launch_counts()
    want = _only(ssm_scan=cfg.num_layers)
    if head != k or counts != want:
        raise AssertionError(f"{cfg.name} split@{k}: {head} head launches "
                             f"(expected {k}), counts {counts}")
    log(f"[zoo] {cfg.name} split@{k}: {head} + {counts['ssm_scan'] - head} "
        f"scan launches, weights shared")
    return {"split_layer": k, "launches": {"head": head,
                                           "tail": counts["ssm_scan"] - head},
            "hidden_rel": _within(f"{cfg.name} split@{k} hidden vs "
                                  f"forward (norm-wise)",
                                  _rel(out, hidden), PATH_RTOL)}


def zoo_run(name, seed, dev):
    """Phase 11 for one zoo config: init at full width, the counted
    prefill (a) and its checks, decode (b), split (c) where the config
    has a split point, and timings (e). Frees nothing itself: the
    caller drops its references."""
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill_step, stack)
    cfg = get_config(name).replace(use_ssm_kernel=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = _sync_s()
    params = init_params(cfg, gen, dev)
    init_s = _sync_s() - t0
    n_params = sum(t.numel() for t in stack.leaves(params))
    if n_params != ZOO[name]:
        raise AssertionError(f"{name}: {n_params} parameters, expected "
                             f"{ZOO[name]}")
    nbytes = sum(t.numel() * t.element_size() for t in stack.leaves(params))
    log(f"[zoo] {name}: {n_params:,} parameters ({nbytes / 1e9:.2f} GB "
        f"bf16) initialised in {init_s:.1f} s")
    tokens = torch.randint(0, cfg.vocab_size, (ZOO_BATCH, ZOO_PROMPT),
                           generator=gen, device=dev)
    batch = {"tokens": tokens}
    layers = cfg.num_layers

    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = _sync_s()
    logits, cache = prefill_step(params, cfg, batch)
    wall = _sync_s() - t0
    counts = _launch_counts()
    if counts != _only(ssm_scan=layers):
        raise AssertionError(f"{name} prefill: launches {counts}, expected "
                             f"{layers} ssm_scan and no other")
    if tuple(logits.shape) != (ZOO_BATCH, 1, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: last logits {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    log(f"[zoo] {name} prefill B={ZOO_BATCH} S={ZOO_PROMPT}: {layers} "
        f"ssm_scan launches (expected {layers}), other kernels 0; last "
        f"logits {tuple(logits.shape)} finite; wall {wall:.2f} s (first "
        f"call), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    out = {"params": n_params, "init_s": init_s, "first_prefill_s": wall,
           "launches": counts, "logits_shape": list(logits.shape),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del cache
    out["prefill"] = zoo_prefill_checks(params, cfg, batch, logits)
    out["decode"] = zoo_decode(params, cfg, tokens[:, :ZOO_DECODE_PROMPT],
                               dev)
    if name in ZOO_SPLIT:
        out["split"] = zoo_split(params, cfg, batch, ZOO_SPLIT[name])

    # (e) timings: a warm prefill and one decode step, wall to a
    # synchronise, median of 3; one traced prefill (falcon-mamba-7b)
    out["prefill_wall_ms"], walls = _median_wall_ms(
        lambda: prefill_step(params, cfg, batch))
    cache = init_cache(cfg, ZOO_BATCH, ZOO_DECODE_PROMPT, dev)
    tok = tokens[:, :1]
    decode_step(params, cfg, cache, tok, 0)
    pos = iter(range(1, 6))
    out["decode_step_wall_ms"], dwalls = _median_wall_ms(
        lambda: decode_step(params, cfg, cache, tok, next(pos)))
    log(f"[zoo] {name}: warm prefill wall {out['prefill_wall_ms']:.1f} ms "
        f"(median of {[round(w, 1) for w in walls]}), decode step wall "
        f"{out['decode_step_wall_ms']:.2f} ms (median of "
        f"{[round(w, 2) for w in dwalls]})")
    if name == "falcon-mamba-7b":
        out["profile"] = trace(f"{name} prefill B={ZOO_BATCH} "
                               f"S={ZOO_PROMPT}",
                               lambda: prefill_step(params, cfg, batch))
        out["decode_profile"] = trace(
            f"{name} decode step B={ZOO_BATCH}",
            lambda: decode_step(params, cfg, cache, tok, next(pos)))
    return out


def zoo_phase(seed, dev):
    """Phase 11: each zoo config in turn, freed before the next."""
    report = {}
    for name in ZOO:
        report[name] = zoo_run(name, seed, dev)
        gc.collect()
        torch.cuda.empty_cache()
    return report


def ptxas_lines(log_path):
    """ptxas' report per kernel instantiation, one line each: the template
    arguments of the (mangled) entry name, its stack, spills and
    registers."""
    out, fn, spill = [], "?", ""
    for ln in log_path.read_text().splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for", 1)[1].strip()
            fn = name.split("_kernel", 1)[-1][:40]
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            out.append(f"{fn}: {ln.split(':', 1)[-1].strip()}; {spill}")
    return out


def _write_report(path, report):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1, default=str)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--kernel", action="append", default=None,
                    choices=KERNELS, metavar="NAME",
                    help="build and check only this kernel (phases 1-3; "
                    "repeatable), then stop without a result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.configs import get_config, get_lisa_config
    from repro_torch.core.bottleneck import rank_for_ratio
    from repro_torch.core.lut import paper_lut
    from repro_torch.core.streams import DualStreamExecutor
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "card": card_line(), "device": torch.cuda.get_device_name(0)}
    log(f"[card] {report['card']} (torch {report['torch']}, "
        f"cuda {report['cuda']})")

    t0 = time.perf_counter()
    names = args.kernel or list(_build.SOURCES)
    _build.build(names)     # one nvcc per source, all started together
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {sorted(names)} in {report['build_s']:.1f} s")
    report["ptxas"] = {}
    for name in names:
        lines = ptxas_lines(_build.library_path(name).with_suffix(".log"))
        report["ptxas"][name] = lines
        for ln in lines:
            log(f"[build] {name}: {ln}")

    pcfg = get_lisa_config("lisa-7b")
    rng = np.random.RandomState(args.seed)
    # the main path decodes a Context microbatch of 4 and one Insight
    # request per tier (KINDS, max_batch=4)
    paged_main = f"main_B{INFLIGHT_SLOTS}"     # the in-flight step's shape
    d_sam = pcfg.sam.d_model
    ranks = [rank_for_ratio(d_sam, t.ratio, 4) for t in paper_lut().tiers]
    enc_cases, dec_cases = bottleneck_cases(pcfg, ranks)
    scan_gen = torch.Generator(device=dev)
    scan_gen.manual_seed(args.seed)
    phase3 = {
        "decode_attention": lambda: [
            check_decode_attention(rng, c, dev,
                                   timed=c["name"] in DECODE_TIMED)
            for c in kernel_cases(pcfg, (1, 4))],
        "paged_decode_attention": lambda: [
            check_paged_decode_attention(
                rng, c, dev, timed=c["name"] in (paged_main, "main_B1"))
            for c in paged_cases(pcfg)],
        "paged_verify_attention": lambda: [
            check_paged_verify_attention(
                rng, c, dev, timed=c["name"].startswith("main")
                and c["dtype"] == pcfg.llm.adtype)
            for c in verify_cases(pcfg)],
        "flash_attention": lambda: [
            check_flash_attention(rng, c, dev,
                                  timed=c["name"] in FLASH_TIMED)
            for c in flash_cases(pcfg)],
        "bottleneck_encode": lambda: [
            check_bottleneck_encode(rng, c, dev,
                                    timed=c["name"].startswith("main"))
            for c in enc_cases],
        "bottleneck_decode": lambda: [
            check_bottleneck_decode(rng, c, dev,
                                    timed=c["name"].startswith("main"))
            for c in dec_cases],
        "ssm_scan": lambda: [
            check_ssm_scan(scan_gen, c, dev,
                           timed=c["name"].startswith("main"))
            for c in scan_cases({n: get_config(n) for n in ZOO})]}
    checks, report["check_s"] = {}, {}
    for name in names:
        t0 = time.perf_counter()
        checks[name] = phase3[name]()
        report["check_s"][name] = time.perf_counter() - t0
    log("[kernel] phase 3 seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in report["check_s"].items()))
    gc.collect()
    torch.cuda.empty_cache()
    report.update(checks)
    if not args.kernel:
        report["sdpa"] = [check_sdpa(rng, c, dev) for c in sdpa_cases(pcfg)]
        gc.collect()
        torch.cuda.empty_cache()
    if args.kernel:
        report["total_s"] = time.perf_counter() - t_start
        if args.out:
            _write_report(args.out, report)
        log(f"[done] {report['total_s']:.1f} s, phases 1-3 for {names} "
            f"only")
        return 0
    report["small_input"] = small_input_check(args.seed, dev)

    t0 = time.perf_counter()
    params, bns, lut = make_system(pcfg, args.seed, dev)
    executor = DualStreamExecutor(pcfg=pcfg, params=params, bottlenecks=bns,
                                  lut=lut, max_new_tokens=MAX_NEW_TOKENS,
                                  flash_decode=True, device=dev)
    from repro_torch.models.stack import leaves
    n_params = sum(t.numel() for t in leaves(executor.params))
    report["init_s"] = _sync_s() - t0
    log(f"[serve] lisa-7b: {n_params / 1e9:.3f} B parameters "
        f"({sum(t.numel() * t.element_size() for t in leaves(executor.params)) / 1e9:.2f} GB) "
        f"initialised in {report['init_s']:.1f} s")

    timings = []
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = _sync_s()
    reqs, results, sched = serve(executor, pcfg, args.seed, timings)
    wall = _sync_s() - t0
    counts = _launch_counts()
    launches = counts["decode_attention"]
    if counts != _only(decode_attention=launches):
        raise AssertionError(f"the microbatch path launched another kernel "
                             f"than decode_attention: {counts}")
    n_gen = sched.n_microbatches
    expect = n_gen * MAX_NEW_TOKENS * pcfg.llm.num_layers
    for t in timings:
        log(f"[serve] {t['stage']}: {t['s'] * 1e3:.1f} ms")
    log(f"[serve] {len(results)} requests in {n_gen} microbatches "
        f"(batch sizes {[r.batch_size for r in results]}), wall "
        f"{wall:.2f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB, "
        f"decode_attention launches {launches} (expected {expect})")
    if launches != expect or launches == 0:
        raise AssertionError(f"decode_attention launched {launches} times "
                             f"on the main path, expected {expect}")
    g = pcfg.image_size // pcfg.patch_size
    for req, res in zip(reqs, results):
        arrs = [res.answer_logits, res.tokens]
        if res.tokens.shape != (1, MAX_NEW_TOKENS) or \
                res.answer_logits.shape != (1, pcfg.llm.vocab_size):
            raise AssertionError(f"seq {res.seq_id}: bad output shapes")
        if req.packet.kind == "insight":
            if res.mask_logits is None or res.mask_logits.shape != (1, g, g):
                raise AssertionError(f"seq {res.seq_id}: bad mask")
            arrs.append(res.mask_logits)
        if not all(np.isfinite(a).all() for a in arrs):
            raise AssertionError(f"seq {res.seq_id}: non-finite output")
        if not ((res.tokens >= 0) & (res.tokens < pcfg.llm.vocab_size)).all():
            raise AssertionError(f"seq {res.seq_id}: token out of range")
    log(f"[serve] outputs finite with expected shapes; tokens "
        f"{[r.tokens.tolist()[0] for r in results]}")
    report["serve"] = {"wall_s": wall, "microbatches": n_gen,
                       "batch_sizes": [r.batch_size for r in results],
                       "launches": {"decode_attention": launches},
                       "stages": timings,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "params": n_params}

    report["parity"] = full_width_parity(executor, reqs, results, expect)
    report["profile"] = profile_microbatches(executor, reqs)
    report["inflight"], frames, inflight_results = inflight_phase(
        executor, pcfg, args.seed)
    report["spec"] = spec_phase(executor, pcfg, args.seed, frames)
    report["split"] = split_phase(
        executor, pcfg, args.seed, reqs, results, frames, inflight_results,
        report["inflight"]["launches"]["paged_decode_attention"])

    t0 = time.perf_counter()
    report["engine"] = engine_phase(executor, pcfg, args.seed)
    report["engine_s"] = time.perf_counter() - t0
    log(f"[engine] phase 12 in {report['engine_s']:.1f} s")

    # phase 11: free LISA-7B, then the zoo's Mamba path
    del executor, params, bns, reqs, results, sched, frames, inflight_results
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[zoo] LISA-7B freed: {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
        f" GiB still allocated")
    t0 = time.perf_counter()
    report["zoo"] = zoo_phase(args.seed, dev)
    report["zoo_s"] = time.perf_counter() - t0
    log(f"[zoo] phase 11 in {report['zoo_s']:.1f} s")

    # each kernel's line: its own checks, its own path's launches, and its
    # times at its path's main shape
    main_case = {"decode_attention": "main_B4",
                 "paged_decode_attention": paged_main,
                 "paged_verify_attention": f"main_B{INFLIGHT_SLOTS}_C4_page"
                                           f"{SPEC_PAGE}",
                 "flash_attention": "main_B4",
                 "bottleneck_encode": f"main_r{max(ranks)}",
                 "bottleneck_decode": f"main_r{max(ranks)}",
                 "ssm_scan": "main_falcon-mamba-7b"}
    split = report["split"]
    launched = {"decode_attention": report["serve"]["launches"],
                "paged_decode_attention": report["inflight"]["launches"],
                "paged_verify_attention": report["spec"]["run_a"]["launches"],
                "flash_attention": split["microbatch"]["launches"],
                "bottleneck_encode": split["split_point"]["launches"],
                "bottleneck_decode": split["split_point"]["launches"],
                "ssm_scan": report["zoo"]["falcon-mamba-7b"]["launches"]}
    path_err = {"decode_attention": report["parity"]["max_abs_err"],
                "paged_decode_attention":
                    report["inflight"]["parity"]["max_abs_err"],
                "paged_verify_attention":
                    report["spec"]["parity"]["max_abs_err"],
                **split["split_point"]["max_abs_err"],
                "ssm_scan": max(z["prefill"]["per_launch"]["max_abs_err"]
                                for z in report["zoo"].values())}
    # yardsticks beside library_ms where no one PyTorch call computes the
    # function: page gather + SDPA (two calls) for the paged kernels, the
    # matmul + quantisation chain (ten calls) for encode, the
    # dequantisation + matmul chain (four calls) for decode, one
    # torch.add over the same bytes for the scan
    extra = ("gather_sdpa_ms", "matmul_quant_ms", "dequant_matmul_ms",
             "same_bytes_ms")
    kernels = []
    for name, src in _build.SOURCES.items():
        main_check = next(c for c in checks[name]
                          if c["case"] == main_case[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(src, REPO),
            "replaces": REPLACES[name],
            "launches": launched[name][name],
            "max_abs_err": max([c["max_abs_err"] for c in checks[name]]
                               + [path_err[name]]),
            "ms": main_check["ms"], "plain_ms": main_check["plain_ms"],
            "bound_ms": main_check["bound_ms"],
            "bound_by": main_check["bound_by"],
            "library_ms": main_check.get("library_ms"),
            **{k: main_check[k] for k in extra if k in main_check}})
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    if args.out:
        _write_report(args.out, report)
    log(f"[done] {report['total_s']:.1f} s")
    print(report["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
