#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out PATH]

Phases, each fatal on failure:
  1. report the card (name and power limit from nvidia-smi);
  2. build every CUDA kernel of the serving path from the sources in this
     checkout (nvcc, sm_90a) and report the build time;
  3. hold each kernel against its plain PyTorch version on the card, at
     the serving path's own shapes (once more with lengths spread from 1
     to W across rows) and at a small fp32 shape, and time the
     kernel, the plain version and one PyTorch library call for the same
     function (CUDA graphs of many launches, timed with CUDA events);
  4. check the serving path on a small input: LISA-mini in fp32, the
     scheduler's tokens with the kernel equal those of the plain path;
  5. serve six mixed Context/Insight requests over two bottleneck tiers at
     the full width of LISA-7B (random bf16 weights from ``--seed``)
     through ``MicrobatchScheduler(generate=True)``, with every kernel
     launch counter set to 0 just before and read just after;
  6. serve the same requests again with every kernel launch held against
     the plain version on that launch's own inputs, once with the plain
     version in the kernel's place and once through the plain attention
     path (``flash_decode=False``): tokens equal, logits and masks within
     stated bf16 limits;
  7. replay one Context and one Insight microbatch warm, time each, and
     trace one more run of each with ``torch.profiler``: device time by
     kernel and the device's idle share.

The last lines are the card line, a ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``. Exits non-zero, before printing any
result, when no CUDA device is available or the port is not beside this
script.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

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
# its output (2**-8); eight such roundings are allowed: 2**-5.
PATH_RTOL = 2.0 ** -5
# The same against the flash_decode=False path, whose attention rounds the
# probabilities to bf16 before P.V (as the reference's does) where the
# kernel keeps them in float32: a bf16 rounding of every output element
# in every layer and step. Its measured spread on LISA-7B (PERF.md) set
# this limit, which guards against gross faults, not rounding.
SDPA_PATH_RTOL = 2.0 ** -3
REPLACES = {  # the TPU kernel each CUDA kernel replaces
    "decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:246",
}


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


def held_against(name, out, want):
    """Max abs error of a kernel's output against its plain version's;
    raises if it is not finite or beyond TOL for its dtype."""
    rtol, atol = TOL[want.dtype]
    err = (out.float() - want.float()).abs()
    max_err = float(err.max())
    excess = float((err - rtol * want.float().abs()).max())
    if not (torch.isfinite(out).all() and excess <= atol):
        raise AssertionError(f"{name}: max abs err {max_err:.3g} beyond "
                             f"rtol {rtol} atol {atol}")
    return max_err


def check_decode_attention(rng, case, dev):
    from repro_torch.kernels.decode_attention import ops, ref
    B, H, K, hd, W, dtype, lens = (case[k] for k in
                                   ("B", "H", "K", "hd", "W", "dtype",
                                    "lens"))
    q, k, v, bias = decode_inputs(rng, B, H, K, hd, W, dtype, lens, dev)
    out = ops.decode_attention(q, k, v, bias)
    torch.cuda.synchronize()
    max_err = held_against(f"decode_attention {case['name']}", out,
                           ref.decode_attention_ref(q, k, v, bias))
    rtol, atol = TOL[dtype]
    es = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * H * hd + 2 * B * W * K * hd) * es + B * W * 4
    flops = 4 * B * H * W * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    # rotate through enough copies of the inputs to exceed the L2 cache
    copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
    sets = [(q, k, v, bias)] + [
        decode_inputs(rng, B, H, K, hd, W, dtype, lens, dev)
        for _ in range(copies - 1)]
    lib_sets = [(a.view(B, H, 1, hd), b.permute(0, 2, 1, 3),
                 c.permute(0, 2, 1, 3), m[:, None, None, :].to(dtype))
                for a, b, c, m in sets]
    gqa = {"enable_gqa": True} if K != H else {}

    def library(qq, kk, vv, mm):
        return torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mm, **gqa)

    res = {
        "case": case["name"], "B": B, "H": H, "K": K, "hd": hd, "W": W,
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": max_err, "rtol": rtol, "atol": atol,
        "ms": device_ms(ops.decode_attention, sets),
        "plain_ms": device_ms(ref.decode_attention_ref, sets),
        "library_ms": device_ms(library, lib_sets),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }
    log(f"[kernel] decode_attention {case['name']}: B={B} H={H} K={K} "
        f"hd={hd} W={W} {res['dtype']} max_abs_err={max_err:.3g} "
        f"(rtol {rtol}, atol {atol}) kernel_ms={res['ms']:.4f} "
        f"plain_ms={res['plain_ms']:.4f} library_ms={res['library_ms']:.4f} "
        f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']})")
    return res


def kernel_cases(pcfg, batches):
    """The serving path's decode shapes (every cloud_*_gen call decodes
    at W = clip_tokens + query_len + max_new_tokens), the largest of them
    once more with lengths spread from 1 to W across rows (so that a
    wrong mask shows at full width), and the fp32 shape of the CPU tests
    with a fully masked idle row beside a live row."""
    llm = pcfg.llm
    S = pcfg.clip_tokens + QUERY_LEN
    W = S + MAX_NEW_TOKENS
    cases = [dict(name=f"main_B{B}", B=B, H=llm.num_heads,
                  K=llm.num_kv_heads, hd=llm.resolved_head_dim, W=W,
                  dtype=llm.adtype,
                  lens=np.linspace(S + 1, W, B).astype(int).tolist())
             for B in batches]
    B = max(batches)
    cases.append(dict(cases[-1], name=f"main_B{B}_ragged",
                      lens=np.linspace(1, W, B).astype(int).tolist()))
    cases.append(dict(name="fp32_idle_row", B=2, H=4, K=2, hd=64, W=128,
                      dtype=torch.float32, lens=[0, 128]))
    return cases


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
            y = y.astype(np.float64)
            rel = float(np.linalg.norm(x - y) / np.linalg.norm(y))
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
    version in its place, and (c) through the plain attention path
    (``flash_decode=False``), on the same weights, and hold the main
    path's outputs against each: greedy tokens equal, logits and masks
    within PATH_RTOL and SDPA_PATH_RTOL."""
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

    ops.decode_attention = ref.decode_attention_ref
    try:
        plain_kernel, _ = serve_requests(executor, reqs)
    finally:
        ops.decode_attention = launch
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
            "rel_err_plain_kernel": rel, "rel_limit_plain_kernel": PATH_RTOL,
            "rel_err_sdpa": rel_sdpa, "rel_limit_sdpa": SDPA_PATH_RTOL,
            "min_cosine_answer_logits": min_cos}


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "decode_attention" in low:
        return "decode_attention"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul"
    if "softmax" in low:
        return "softmax"
    return "other"


def profile_microbatches(executor, reqs):
    """Warm replays of one Context and one Insight microbatch: the
    untraced wall time, then a traced run's device time by kernel class
    and the device's idle share (1 - kernel time / traced wall)."""
    from torch.profiler import ProfilerActivity, profile
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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = _sync_s()
            executor.cloud_generate_batch(*args)
            traced = _sync_s() - t0
        by_class, top = {}, []
        for e in prof.key_averages():
            dev_us = e.self_device_time_total
            if dev_us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            cls = _kernel_class(e.key)
            by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
            top.append((dev_us / 1e3, e.count, e.key[:90]))
        busy = sum(by_class.values())
        if busy <= 0:
            raise AssertionError("the profiler recorded no device time")
        top.sort(reverse=True)
        report[f"{label}_B{len(batch)}"] = {
            "warm_wall_ms": warm * 1e3, "traced_wall_ms": traced * 1e3,
            "device_ms": busy, "idle_share": 1.0 - busy / (traced * 1e3),
            "device_ms_by_class": by_class,
            "top_kernels": [{"ms": t, "count": c, "name": n}
                            for t, c, n in top[:10]]}
        log(f"[profile] {label} B={len(batch)}: warm wall {warm * 1e3:.1f} "
            f"ms; traced wall {traced * 1e3:.1f} ms, device {busy:.1f} ms "
            f"(idle share {1.0 - busy / (traced * 1e3):.3f}); by class "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(
                by_class.items(), key=lambda kv: -kv[1])))
        for t, c, n in top[:6]:
            log(f"[profile]   {t:8.2f} ms  x{c:<5d} {n}")
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.configs import get_lisa_config
    from repro_torch.core.streams import DualStreamExecutor
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as decode_ops

    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "card": card_line(), "device": torch.cuda.get_device_name(0)}
    log(f"[card] {report['card']} (torch {report['torch']}, "
        f"cuda {report['cuda']})")

    t0 = time.perf_counter()
    for name in _build.SOURCES:
        _build.build(name)
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {sorted(_build.SOURCES)} in {report['build_s']:.1f} s")
    for name in _build.SOURCES:
        ptxas = [ln.strip() for ln in _build.library_path(name)
                 .with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        for ln in ptxas:
            log(f"[build] {name}: {ln}")

    pcfg = get_lisa_config("lisa-7b")
    rng = np.random.RandomState(args.seed)
    # the main path decodes a Context microbatch of 4 and one Insight
    # request per tier (KINDS, max_batch=4)
    checks = [check_decode_attention(rng, c, dev)
              for c in kernel_cases(pcfg, (1, 4))]
    report["decode_attention"] = checks
    report["small_input"] = small_input_check(args.seed, dev)

    t0 = time.perf_counter()
    params, bns, lut = make_system(pcfg, args.seed, dev)
    executor = DualStreamExecutor(pcfg=pcfg, params=params, bottlenecks=bns,
                                  lut=lut, max_new_tokens=MAX_NEW_TOKENS,
                                  flash_decode=True, device=dev)
    n_params = sum(t.numel() for t in _leaves(executor.params))
    report["init_s"] = _sync_s() - t0
    log(f"[serve] lisa-7b: {n_params / 1e9:.3f} B parameters "
        f"({sum(t.numel() * t.element_size() for t in _leaves(executor.params)) / 1e9:.2f} GB) "
        f"initialised in {report['init_s']:.1f} s")

    timings = []
    torch.cuda.reset_peak_memory_stats()
    decode_ops.launches = 0
    t0 = _sync_s()
    reqs, results, sched = serve(executor, pcfg, args.seed, timings)
    wall = _sync_s() - t0
    launches = decode_ops.launches
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

    main_check = max((c for c in checks if c["case"].startswith("main")),
                     key=lambda c: c["B"])
    kernels = []
    for name, src in _build.SOURCES.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(src, REPO),
            "replaces": REPLACES[name],
            "launches": report["serve"]["launches"][name],
            "max_abs_err": max([c["max_abs_err"] for c in checks]
                               + [report["parity"]["max_abs_err"]]),
            "ms": main_check["ms"], "plain_ms": main_check["plain_ms"],
            "bound_ms": main_check["bound_ms"],
            "bound_by": main_check["bound_by"],
            "library_ms": main_check["library_ms"]})
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    log(f"[done] {report['total_s']:.1f} s")
    print(report["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
