"""The stage profiler, compile observatory and cost ledger: the port's
profiled ``AveryEngine`` against the reference's (``tests/test_profiler.py``
is the reference's own test), on bridged lisa_mini executors.

Both engines are profiled under one deterministic counter wall clock each
(the profiler and the engine's step histograms read it in the same order),
and both cost models are given the reference's TPU v5e constants
explicitly (the port's default is the H100's). Requests go in through
``session.submit`` (each engine edge-encodes the frames on its own
executor, so the edge stages are profiled too) in ``microbatch`` and
``generate`` batching, and through ``submit_packet`` with the reference's
edge-encoded packets in ``inflight`` batching, plain and with
``speculative=2``.

Held exactly: the ``stats()`` key set, every value but the four compile
keys (``compile_events``, ``compile_wall_s``, ``compiled_roots``: the
reference counts its jit caches, the port's census on the CPU is empty;
``compiled_stages``: the eager port compiles nothing) and with
``flight_events`` counted without the flight recorder's compile entries,
each response's
``cloud_flops`` / ``cloud_hbm_bytes`` / ``cloud_energy_j``, and the pid-3
device spans of ``dump_trace`` (name, tid, ts, dur). In flight, tokens are
equal and logits within the bounds of ``tests/test_torch_engine.py``; the
``session.submit`` runs hold every other response field equal (their
packets are each engine's own, as in that file's session test). No wall-clock
overhead test runs here: timing on the shared CPU says nothing about the
card (``chip_smoke.py`` phase 13 measures the overhead there).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import engine as je
from repro.engine.observability import DEVICE_TRACK_PID
from repro.engine.profiler import CompileObservatory as JObservatory
from repro.network import energy as jen
from repro_torch import engine as te
from repro_torch.engine.profiler import CompileObservatory as TObservatory
from repro_torch.engine.profiler import PROFILED_STAGES
from repro_torch.network import energy as ten

from test_torch_engine import (ATOL, _counter, _engines, _held, _packets,
                               _scalars, _serve_packets, _submit_frames,
                               system)  # noqa: F401

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
COMPILE_KEYS = ("compile_events", "compile_wall_s", "compiled_roots",
                "compiled_stages")
TPU = (jen.TPU_V5E_FLOPS, jen.TPU_V5E_HBM_BPS, jen.TPU_V5E_POWER_W)


def _profiled(**kw):
    """Engine keyword factories: a counter clock per engine, shared by its
    profiler and its step histograms, and the reference's cloud device."""
    clocks = {}

    def clock(side):
        return clocks.setdefault(side, _counter())

    def profile(side):
        if side == "j":
            return je.StageProfiler(clock(side),
                                    device=jen.CloudDevice(*TPU))
        return te.StageProfiler(clock(side), device=ten.CloudDevice(*TPU))
    return dict(profile=profile, wallclock=clock, **kw)


def _profiled_stats_equal(jeng, teng):
    """Every value equal but the compile keys; the flight recorder's
    length equal once each side's compile entries (the reference's jit
    compiles, none for the port on the CPU) are taken out."""
    js, ts = dict(jeng.stats), dict(teng.stats)
    assert sorted(ts) == sorted(js)
    for key in COMPILE_KEYS:
        js.pop(key)
        ts.pop(key)
    for st, eng in ((js, jeng), (ts, teng)):
        st["flight_events"] -= sum(e["kind"] == "compile"
                                   for e in eng.flight.snapshot())
    assert ts == js
    return teng.stats


def _device_spans(engine, path):
    doc = json.loads(Path(engine.dump_trace(str(path))).read_text())
    return [(e["name"], e["tid"], e["ts"], e["dur"])
            for e in doc["traceEvents"]
            if e.get("pid") == DEVICE_TRACK_PID and e.get("ph") == "X"]


WAVES = [[(0, "uav-A", 0.0), (1, "uav-B", 0.2)],
         [(0, "uav-A", 0.5), (2, "uav-A", 0.6)],
         [(3, "uav-B", 1.0), (4, "uav-A", 1.1), (5, "uav-B", 1.2)]]


@pytest.mark.parametrize("batching,speculative", [
    ("microbatch", None), ("generate", None), ("inflight", None),
    ("inflight", 2)])
def test_profiled_engines_equal(system, tmp_path, batching, speculative):
    kw = _profiled(batching=batching, max_batch=3, trace=True)
    if speculative is not None:
        kw["speculative"] = speculative
    engines = _engines(system, **kw)
    if batching == "inflight":
        jf, tf = _serve_packets(system, engines, WAVES, pumps=(0, 1))
        for j, t in zip(jf, tf):
            # the ledger fields are among the scalars: exactly equal
            _held(j.result(), t.result(), dict(atol=ATOL))
        tres = [t.result() for t in tf]
    else:
        (jres, _), (tres, _) = [
            _submit_frames(system, eng, side, lambda e: None)
            for side, eng in zip("jt", engines)]
        for j, t in zip(jres, tres):
            assert _scalars(t) == _scalars(j)
    for r in tres:
        assert (r.cloud_flops is None) == (batching != "inflight")
    stats = _profiled_stats_equal(*engines)
    assert stats["profiled_stage_calls"] > 0
    if batching != "inflight":
        assert stats["stage_edge_insight_calls"] > 0
        assert stats["stage_edge_context_calls"] > 0
    else:
        assert stats["stage_cloud_decode_rows_calls"] + \
            stats["stage_cloud_verify_rows_calls"] > 0
        assert stats["ledger_flops_total"] == sum(
            r.cloud_flops for r in tres)
        assert 0.0 < stats["decode_roofline_frac"]
    if speculative:
        assert stats["stage_draft_calls"] > 0
        assert stats["stage_draft_admit_calls"] > 0
        assert stats["stage_cloud_verify_rows_calls"] > 0
    spans = [_device_spans(eng, tmp_path / f"{side}.json")
             for side, eng in zip("jt", engines)]
    assert spans[1] and spans[1] == spans[0]
    assert stats["profiled_stage_calls"] == len(spans[1])
    assert {name for name, *_ in spans[1]} <= set(PROFILED_STAGES)


def test_profiled_stats_keys_match_fixture(system):
    """The reference's canonical scenario (three requests, two slots): the
    port's profiled key set equals the reference's pinned fixture."""
    engines = _engines(system, **_profiled(batching="inflight",
                                           max_batch=2))
    for side, eng in zip("jt", engines):
        for i, (p, q, it) in enumerate(_packets(system, side, range(3))):
            eng.submit_packet(p, q, it, time_s=float(i))
        eng.drain()
    _profiled_stats_equal(*engines)
    want = json.loads((FIXTURES / "engine_stats_keys_profiled.json")
                      .read_text())
    assert sorted(engines[1].stats) == want


def test_ledger_matches_analytic_model_on_the_h100(system):
    """One prefix-miss request on the port's default cost model: the
    closed-form ``network/energy.py`` cost, priced on the H100's
    constants."""
    tex = system["tex"]
    engine = te.AveryEngine(lut=tex.lut, executor=tex, batching="inflight",
                            max_batch=1, profile=True, wallclock=_counter())
    assert engine.cost_model.device == ten.H100_SXM
    (pkt, q, it), = _packets(system, "t", [0])
    fut = engine.submit_packet(pkt, q, it, time_s=0.0)
    engine.drain()
    r = fut.result()
    assert r.failure is None
    pcfg = tex.pcfg
    prefix_len = pcfg.clip_tokens + int(np.asarray(q).shape[-1])
    T = tex.max_new_tokens
    flops = ten.encoder_flops(pcfg.llm, prefix_len) + sum(
        ten.decode_token_flops(pcfg.llm, prefix_len + i)
        for i in range(1, T + 1))
    hbm = sum(ten.decode_token_hbm_bytes(pcfg.llm, prefix_len + i)
              for i in range(1, T + 1))
    assert r.cloud_flops == flops and r.cloud_hbm_bytes == hbm
    assert r.cloud_energy_j == ten.H100_SXM.compute_energy_j(flops)
    st = engine.stats
    assert (st["ledger_flops_total"], st["ledger_hbm_bytes_total"],
            st["ledger_energy_j_total"]) == \
        (r.cloud_flops, r.cloud_hbm_bytes, r.cloud_energy_j)
    assert st["decode_roofline_frac"] > 0.0


def test_ledger_absent_without_profiler(system):
    tex = system["tex"]
    engine = te.AveryEngine(lut=tex.lut, executor=tex, batching="inflight",
                            max_batch=1)
    (pkt, q, it), = _packets(system, "t", [0])
    fut = engine.submit_packet(pkt, q, it, time_s=0.0)
    engine.drain()
    r = fut.result()
    assert r.failure is None
    assert (r.cloud_flops, r.cloud_hbm_bytes, r.cloud_energy_j) == \
        (None, None, None)
    assert "profiled_stage_calls" not in engine.stats


def test_profile_requires_wallclock(system):
    for mod in (je, te):
        with pytest.raises(ValueError, match="wallclock"):
            mod.AveryEngine(lut=system["tex"].lut, profile=True)
        with pytest.raises(ValueError, match="wallclock"):
            mod.StageProfiler(wallclock=None)


class _Root:
    """A census root whose count the test script sets."""

    def __init__(self, counts, label):
        self.counts, self.label = counts, label

    def _cache_size(self):
        return self.counts[self.label]


def test_compile_observatory_events_equal_on_one_census_sequence():
    """Both observatories diff the same scripted census (roots appearing,
    growing, standing still) and record the same events, totals and
    flight-recorder entries."""
    steps = [("cloud_prefix", {"a": 1}), ("pool_write", {"a": 1, "b": 2}),
             ("cloud_decode_rows", {"a": 3, "b": 2}),
             ("cloud_decode_rows", {"a": 3, "b": 2}),
             ("cloud_mask", {"a": 3, "b": 2, "c": 1})]
    out = []
    for obs_cls, flight_cls in ((JObservatory, je.FlightRecorder),
                                (TObservatory, te.FlightRecorder)):
        counts = {"a": 0}
        flight = flight_cls(capacity=16)
        obs = obs_cls(max_events=8)
        obs.bind(lambda: {k: _Root(counts, k) for k in counts}, flight)
        obs.prime()
        for i, (stage, now) in enumerate(steps):
            counts.clear()
            counts.update(now)
            obs.note(stage, 0.25 * (i + 1), float(i))
        out.append((list(obs.events), obs.n_compiles, obs.n_events,
                    obs.compile_wall_s, obs.n_roots,
                    [(e["kind"], e["t"], e["data"])
                     for e in flight.snapshot()]))
    assert out[1] == out[0]
    assert out[1][1] == 6 and out[1][2] == 4
