"""The slice end to end: the port's ``AveryEngine`` against the reference's,
on bridged lisa_mini executors, through all three batching modes, the
speculative knob, the retry and fault paths and the observability exports.

Both engines get the same schedule. Where the schedule submits packets
(``submit_packet``), both cloud sides get the reference's edge-encoded
packets, so they see identical codes. Where it submits frames
(``session.submit``), each engine encodes its own on its own executor, and
the port's tokens are held against the port's own one-shot
``cloud_generate_batch`` on the packet its transport carried.

The reference runs with ``flash_decode=False`` (its plain attention, which
keeps tier-1 time down); the port with ``flash_decode=True`` on CPU
tensors, so its decode and verify attention are the kernels' plain versions
through the kernel wrappers. Engines that take a ``wallclock`` get one
deterministic counter each, so the step histograms compare exactly.

Tolerances: greedy tokens exactly equal; every ``stats()`` value equal
except ``compiled_stages`` (the reference counts its jit cache, the eager
port compiles nothing); response timing, batching and event fields equal;
microbatch logits and masks rtol 1e-4, atol 1e-4 (tests/test_torch_serving.py),
in-flight logits and masks atol 3e-4 (the reference's own in-flight bound,
tests/test_engine.py).
"""
import dataclasses
import importlib.util
import itertools
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as je
from repro.configs.lisa_mini import CONFIG as JP
from repro.core import DualStreamExecutor as JExecutor
from repro.core import vlm as jvlm
from repro.core.controller import MissionGoal as JGoal
from repro.core.intent import Intent as JIntent
from repro.core.profile import random_init_system
from repro.data import floodseg
from repro.network import traces as jtraces
from repro_torch import engine as te
from repro_torch.configs import get_lisa_config
from repro_torch.core import lut as tlut
from repro_torch.core import packets as tpk
from repro_torch.core.controller import MissionGoal as TGoal
from repro_torch.core.intent import Intent as TIntent
from repro_torch.core.streams import DualStreamExecutor as TExecutor
from repro_torch.network import traces as ttraces

torch.set_num_threads(1)

TP = get_lisa_config("lisa-mini")
T = 4                                       # max_new_tokens
PAGE = 4                                    # draft overhangs cross pages
TOL = dict(rtol=1e-4, atol=1e-4)
ATOL = 3e-4
FIXTURE = Path(__file__).resolve().parent / "fixtures" / \
    "engine_stats_keys.json"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ("segment the stranded person", "how many boats are there",
           "outline the flooded road", "describe the area",
           "highlight the roof", "any people visible")


@pytest.fixture(scope="module")
def system():
    """Both executors on one set of reference weights, six frames, and
    their packets edge-encoded by the reference (Context every third)."""
    params, bns, lut = random_init_system(JP, seed=0)
    jex = JExecutor(pcfg=JP, params=params, bottlenecks=bns, lut=lut,
                    max_new_tokens=T, flash_decode=False, page_size=PAGE)
    tex = TExecutor(pcfg=TP, params=jax.tree.map(np.asarray, params),
                    bottlenecks=jax.tree.map(np.asarray, bns),
                    lut=tlut.paper_lut(), max_new_tokens=T,
                    flash_decode=True, page_size=PAGE, device="cpu")
    rng = np.random.RandomState(41)
    frames, reqs = [], []
    for i in range(6):
        kind = "any" if i % 3 == 2 else "segment"
        b = floodseg.make_batch(rng, 1, kind, augment=False)
        frames.append((np.asarray(b["images"]), np.asarray(b["query"])))
        img = jnp.asarray(b["images"])
        if kind == "any":
            pkt, _ = jex.edge_context(img, i, 0.0)
        else:
            pkt = jex.edge_insight(img, jex.lut.tiers[i % 2], i, 0.0)
        reqs.append((pkt, _port_packet(pkt), np.asarray(b["query"]),
                     "context" if kind == "any" else "insight"))
    return {"jex": jex, "tex": tex, "frames": frames, "reqs": reqs}


def _port_packet(p):
    return tpk.Packet(kind=p.kind, tier_name=p.tier_name, seq_id=p.seq_id,
                      created_at=p.created_at, payload_bytes=p.payload_bytes,
                      content={k: np.asarray(v) for k, v in p.content.items()})


def _counter():
    """A deterministic stand-in wall clock: 0, 1e-3, 2e-3, ..."""
    tick = itertools.count()
    return lambda: next(tick) * 1e-3


def _engines(system, **kw):
    """(reference engine, port engine) on their executors, built alike. A
    callable ``kw`` value is a factory, called with the side ("j" for the
    reference, "t" for the port)."""
    out = []
    for side in ("j", "t"):
        mod = je if side == "j" else te
        args = {k: v(side) if callable(v) else v for k, v in kw.items()}
        out.append(mod.AveryEngine(lut=system[f"{side}ex"].lut,
                                   executor=system[f"{side}ex"], **args))
    return out


def _packets(system, side, which):
    """(packet, query, Intent) of the named requests for one side."""
    intent = JIntent if side == "j" else TIntent
    return [(r[0] if side == "j" else r[1], r[2], intent(r[3]))
            for r in (system["reqs"][i] for i in which)]


def _scalars(r):
    """A response's non-array fields as comparable plain data."""
    d = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
         if f.name not in ("answer_logits", "mask_logits", "tokens",
                           "intent", "events")}
    d["intent"] = r.intent.value
    d["events"] = [(e.kind, e.t, e.data) for e in r.events]
    return d


def _held(jres, tres, atol_kw):
    assert _scalars(tres) == _scalars(jres)
    if jres.tokens is None:
        assert tres.tokens is None
    else:
        np.testing.assert_array_equal(tres.tokens, np.asarray(jres.tokens))
    for key in ("answer_logits", "mask_logits"):
        a, b = getattr(tres, key), getattr(jres, key)
        if b is None:
            assert a is None, key
        else:
            np.testing.assert_allclose(a, np.asarray(b), **atol_kw)


def _stats_equal(jeng, teng):
    js, ts = dict(jeng.stats), dict(teng.stats)
    assert ts.pop("compiled_stages") == 0
    js.pop("compiled_stages")
    assert ts == js
    return ts


def _serve_packets(system, engines, schedule, pumps=()):
    """Submit ``schedule`` (waves of (request index, operator, time)) to
    both engines, pumping after the waves named in ``pumps``; drain.
    Returns the futures of each engine."""
    futs = []
    for side, eng in zip(("j", "t"), engines):
        sessions = {}
        mine = []
        for w, wave in enumerate(schedule):
            for i, op, t in wave:
                sess = sessions.get(op) or sessions.setdefault(
                    op, eng.session(op))
                (pkt, q, it), = _packets(system, side, [i])
                mine.append(eng.submit_packet(pkt, q, it, time_s=t,
                                              session=sess))
            if w in pumps:
                eng.pump()
        drained = eng.drain()
        assert [r.request_id for r in drained] == \
            [f.result().request_id for f in mine]
        futs.append(mine)
    return futs


# ---------------------------------------------------------------------------
# the three batching modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batching", ["microbatch", "generate"])
def test_microbatch_and_generate_modes(system, batching):
    engines = _engines(system, batching=batching, max_batch=4)
    schedule = [[(i, "uav-A" if i % 2 else "uav-B", float(i))
                 for i in range(6)]]
    jf, tf = _serve_packets(system, engines, schedule)
    tol = TOL if batching == "microbatch" else dict(atol=ATOL)
    for j, t in zip(jf, tf):
        _held(j.result(), t.result(), tol)
    stats = _stats_equal(*engines)
    assert stats["n_microbatches"] < 6 and stats["completed"] == 6
    if batching == "generate":
        for (_, tpkt, q, _), t in zip(system["reqs"], tf):
            want = system["tex"].cloud_generate_batch([tpkt], [q])[0]
            np.testing.assert_array_equal(t.result().tokens, want[-1])


def test_inflight_mode_joins_and_reuses_prefixes(system, tmp_path):
    """Two operators, a repeated frame (a prefix hit), a request submitted
    after a pump joins the running batch; traced, with a counter wall
    clock: responses, stats and the metrics registry equal; the chrome
    export validates; the flight recorder's dumps agree."""
    engines = _engines(system, batching="inflight", max_batch=3, trace=True,
                       wallclock=lambda side: _counter())
    schedule = [[(0, "uav-A", 0.0), (1, "uav-B", 0.2)],
                [(0, "uav-A", 0.5), (2, "uav-A", 0.6)],
                [(3, "uav-B", 1.0), (4, "uav-A", 1.1), (5, "uav-B", 1.2)]]
    jf, tf = _serve_packets(system, engines, schedule, pumps=(0, 1))
    order = [i for wave in schedule for i, _, _ in wave]
    for i, j, t in zip(order, jf, tf):
        _held(j.result(), t.result(), dict(atol=ATOL))
        _, tpkt, q, _ = system["reqs"][i]
        want = system["tex"].cloud_generate_batch([tpkt], [q])[0]
        np.testing.assert_array_equal(t.result().tokens, want[-1])
    res = [t.result() for t in tf]
    assert max(r.joined_step for r in res) > 0
    assert any(r.prefix_hit for r in res)
    stats = _stats_equal(*engines)
    assert stats["decode_step_p50_s"] > 0 and stats["prefix_hits"] >= 1
    jeng, teng = engines
    assert teng.metrics.as_dict() == jeng.metrics.as_dict()
    doc = teng.tracer.to_chrome()
    assert doc == jeng.tracer.to_chrome()
    assert te.validate_chrome_trace(doc) == []
    assert te.validate_traces(teng.tracer) == []
    dumps = []
    for side, eng in zip("jt", engines):
        path = eng.dump_flight(str(tmp_path / side / "flight.json"))
        dumps.append(json.loads(Path(path).read_text()))
        reread = json.loads(Path(eng.dump_trace(
            str(tmp_path / side / "trace.json"))).read_text())
        assert reread == json.loads(json.dumps(eng.tracer.to_chrome()))
    for d in dumps:
        d["stats"].pop("compiled_stages")
    assert dumps[1]["events"] and dumps[1] == dumps[0]
    for sess in teng.sessions:
        assert sess.close() > 0
    assert teng.stats["kv_pages_in_use"] == 0


def test_stats_keys_match_fixture(system):
    """The reference's canonical in-flight scenario (three requests, two
    slots, ``submit_packet``): the port's key set equals the committed
    fixture, and every value the reference's."""
    engines = _engines(system, batching="inflight", max_batch=2)
    for side, eng in zip("jt", engines):
        for i, (p, q, it) in enumerate(_packets(system, side, range(3))):
            eng.submit_packet(p, q, it, time_s=float(i))
        eng.drain()
    _stats_equal(*engines)
    assert sorted(engines[1].stats) == json.loads(FIXTURE.read_text())
    assert engines[1].arm_sanitizers() is None


# ---------------------------------------------------------------------------
# session.submit: edge compute, Sense/Gate/Select, the uplink
# ---------------------------------------------------------------------------

def _submit_frames(system, eng, side, transport_of, n=6):
    goal = (JGoal if side == "j" else TGoal).PRIORITIZE_THROUGHPUT
    sessions = [eng.session("uav-A"), eng.session("uav-B", goal=goal)]
    futs = []
    for i in range(n):
        img, q = system["frames"][i]
        futs.append(sessions[i % 2].submit(
            prompt=PROMPTS[i], images=jnp.asarray(img) if side == "j"
            else img, query=q, time_s=0.9 * i))
    eng.drain()
    return [f.result() for f in futs], transport_of(eng)


def _records(transport):
    return [(r.packet.seq_id, r.packet.kind, r.packet.tier_name,
             r.packet.payload_bytes, r.start_s, r.end_s, r.delivered)
            for r in transport.records]


def _own_generate(tex, rec, query):
    return tex.cloud_generate_batch([rec.packet], [query])[0]


def test_session_submit_over_paper_trace(system):
    """Images in, through the classifier, AdaptivePolicy on a paper trace,
    the executors' edge stages and a ChannelTransport: equal intents,
    tiers, transmit records and events; each port response equals the
    one-shot generate path on the packet its transport carried."""
    engines = [
        mod.AveryEngine(lut=ex.lut, executor=ex, batching="generate",
                        max_batch=4, transport=mod.ChannelTransport
                        .from_trace(tr.paper_trace(3)),
                        policy=mod.AdaptivePolicy())
        for mod, ex, tr in ((je, system["jex"], jtraces),
                            (te, system["tex"], ttraces))]
    (jres, jtr), (tres, ttr) = [
        _submit_frames(system, eng, side, lambda e: e.transport)
        for side, eng in zip("jt", engines)]
    assert _records(ttr) == _records(jtr)
    intents = [r.intent.value for r in tres]
    assert intents == [r.intent.value for r in jres]
    assert set(intents) == {"context", "insight"}
    for j, t in zip(jres, tres):
        sj, st = _scalars(j), _scalars(t)
        assert st == sj
    for t, rec in zip(tres, ttr.records):
        q = system["frames"][rec.packet.seq_id][1]
        want = _own_generate(system["tex"], rec, q)
        np.testing.assert_array_equal(t.tokens, want[-1])
    _stats_equal(*engines)


# ---------------------------------------------------------------------------
# speculation through the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("speculative", [True, 2, "nano"])
def test_speculative_knob(system, speculative):
    engines = _engines(system, batching="inflight", max_batch=3,
                       speculative=speculative)
    schedule = [[(i, "uav-A" if i < 3 else "uav-B", 0.3 * i)
                 for i in range(5)]]
    jf, tf = _serve_packets(system, engines, schedule, pumps=(0,))
    for j, t in zip(jf, tf):
        _held(j.result(), t.result(), dict(atol=ATOL))
        assert t.result().speculative is True
    stats = _stats_equal(*engines)
    assert stats["spec_drafted"] > 0
    if speculative == "nano":
        from repro_torch.configs import lisa_nano as tnano
        assert engines[1].spec_config.draft_pcfg is tnano.CONFIG


def test_policy_floor_vetoes_a_divergent_draft(system):
    """A divergent draft under AdaptivePolicy's acceptance floor: drafting
    stops after the warm-up samples, and a later burst stays vetoed on the
    engine-lifetime stats; StaticTierPolicy keeps drafting."""
    draft = jvlm.init_lisa(JP, jax.random.PRNGKey(123))
    cfgs = {"j": je.SpeculativeConfig(
        draft_tokens=2, acceptance_floor=0.5, min_draft_samples=4,
        draft_params=draft),
        "t": te.SpeculativeConfig(
            draft_tokens=2, acceptance_floor=0.5, min_draft_samples=4,
            draft_params=jax.tree.map(np.asarray, draft))}
    for policy in ("adaptive", "static"):
        engines = _engines(system, batching="inflight", max_batch=2,
                           speculative=lambda s: cfgs[s],
                           policy=lambda s: (je if s == "j" else te)
                           .AdaptivePolicy() if policy == "adaptive"
                           else (je if s == "j" else te)
                           .StaticTierPolicy("Balanced"))
        jf, tf = _serve_packets(system, engines,
                                [[(i, "uav-A", float(i)) for i in range(4)]],
                                pumps=())
        for j, t in zip(jf, tf):
            _held(j.result(), t.result(), dict(atol=ATOL))
        stats = _stats_equal(*engines)
        if policy == "adaptive":
            assert stats["spec_disabled_steps"] > 0
            jf, tf = _serve_packets(system, engines,
                                    [[(0, "uav-A", 10.0)]])
            _held(jf[0].result(), tf[0].result(), dict(atol=ATOL))
            assert _stats_equal(*engines)["spec_drafted"] == \
                stats["spec_drafted"]
        else:
            assert stats["spec_disabled_steps"] == 0


# ---------------------------------------------------------------------------
# faults: retries, downshifts, stage faults, deadlines
# ---------------------------------------------------------------------------

def test_blackout_retry_downshifts_and_serves(system):
    engines = [
        mod.AveryEngine(
            lut=ex.lut, executor=ex, batching="inflight", max_batch=2,
            transport=mod.FaultInjector(mod.LoopbackTransport(20.0),
                                        blackouts=[(0.0, 5.0)]),
            retry=mod.RetryPolicy(max_attempts=3, backoff_base_s=3.0),
            debug_invariants=True)
        for mod, ex in ((je, system["jex"]), (te, system["tex"]))]
    out = []
    for side, eng in zip("jt", engines):
        img, q = system["frames"][0]
        fut = eng.session("op").submit(
            prompt="segment the stranded person",
            images=jnp.asarray(img) if side == "j" else img, query=q)
        eng.drain()
        out.append(fut.result())
    jres, tres = out
    assert _scalars(tres) == _scalars(jres)
    assert tres.attempts == 2 and tres.tier_name == "Balanced"
    assert tres.failure is None
    rec = engines[1].transport.records[-1]
    np.testing.assert_array_equal(
        tres.tokens, _own_generate(system["tex"], rec,
                                   system["frames"][0][1])[-1])
    stats = _stats_equal(*engines)
    assert (stats["retries"], stats["downshifts"], stats["blackouts"]) == \
        (1, 1, 0)


def _faulty(system, fail_at, attempts):
    return [
        mod.AveryEngine(
            lut=ex.lut, executor=mod.FaultyExecutor(ex, fail_at=fail_at),
            batching="inflight", max_batch=2, debug_invariants=True,
            retry=mod.RetryPolicy(max_attempts=attempts,
                                  backoff_base_s=0.1))
        for mod, ex in ((je, system["jex"]), (te, system["tex"]))]


def test_stage_fault_retries_token_exact(system):
    """A decode-step fault kills the step for both co-active rows; both
    retry (prefix hits) and equal the fault-free run's tokens."""
    engines = _faulty(system, {"cloud_decode_rows": [1]}, 3)
    schedule = [[(0, "op", 0.0), (1, "op", 0.5)]]
    jf, tf = _serve_packets(system, engines, schedule)
    clean = _serve_packets(system, _engines(system, batching="inflight",
                                            max_batch=2), schedule)[1]
    for j, t, c in zip(jf, tf, clean):
        _held(j.result(), t.result(), dict(atol=ATOL))
        assert t.result().attempts == 2
        np.testing.assert_array_equal(t.result().tokens, c.result().tokens)
    stats = _stats_equal(*engines)
    assert (stats["stage_faults"], stats["retries"],
            stats["cloud_errors"]) == (1, 2, 0)
    engines[1].release_prefixes("op")
    assert engines[1].stats["kv_pages_in_use"] == 0


def test_stage_fault_terminal_after_attempts_run_out(system):
    engines = _faulty(system, {"cloud_decode_rows": range(32)}, 2)
    jf, tf = _serve_packets(system, engines, [[(1, "op", 0.0)]])
    _held(jf[0].result(), tf[0].result(), dict(atol=ATOL))
    assert tf[0].result().failure == "cloud_error"
    stats = _stats_equal(*engines)
    assert (stats["cloud_errors"], stats["retries"]) == (1, 1)


def test_deadline_cancels_mid_decode(system):
    """A request with a 2 s deadline is admitted and decoding when a
    later submission moves the mission clock past it: the engine cancels
    it in flight (its slot and pages released) and serves the other."""
    engines = _engines(system, batching="inflight", max_batch=2,
                       debug_invariants=True)
    out = []
    for side, eng in zip("jt", engines):
        mod = je if side == "j" else te
        intent = JIntent if side == "j" else TIntent
        sess = eng.session("op")
        sess.requirements[intent.INSIGHT] = dataclasses.replace(
            sess.requirements[intent.INSIGHT], max_latency_s=2.0)
        (p0, q0, i0), (p1, q1, i1) = _packets(system, side, [0, 2])
        late = eng.submit_packet(p0, q0, i0, time_s=0.0, session=sess)
        eng.pump()
        assert len(next(iter(eng._inflight.values())).active) == 1
        ok = eng.submit_packet(p1, q1, i1, time_s=5.0, session=sess)
        eng.drain()
        out.append((late.result(), ok.result()))
        assert isinstance(eng.transport, mod.LoopbackTransport)
    (jl, jo), (tl, to) = out
    _held(jl, tl, dict(atol=ATOL))
    _held(jo, to, dict(atol=ATOL))
    assert tl.failure == "deadline" and to.failure is None
    stats = _stats_equal(*engines)
    assert (stats["deadline_cancelled"], stats["inflight_cancelled"]) == \
        (1, 1)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_fault_schedules_match_reference(system):
    """``chip_smoke``'s phase-12d schedules (``fault_blackout_run`` over
    its own frames, ``fault_stage_run`` over two packets) on both engines:
    equal responses, and the reference's counters are the
    ``FAULT_COUNTERS`` that phase 12d holds the card's run to. The card
    runs LISA-7B's packets on ``paper_trace(seed)``; the counters are
    structural (the blackout window covers only frame 0's send, the fault
    is at a decode call's index), so lisa_mini's packets on
    ``paper_trace(0)`` give the same."""
    cs = _load_chip_smoke()
    frames = cs.engine_frames(JP, 0)
    out = []
    for side, mod, tr in (("j", je, jtraces), ("t", te, ttraces)):
        ex = system[f"{side}ex"]
        b_eng, b_res = cs.fault_blackout_run(mod, ex, frames,
                                             tr.paper_trace(0))
        s_eng, s_res = cs.fault_stage_run(mod, ex,
                                          _packets(system, side, [0, 2]))
        _, clean = cs.fault_stage_run(mod, ex, _packets(system, side,
                                                        [0, 2]),
                                      faulty=False)
        for r, c in zip(s_res, clean):
            np.testing.assert_array_equal(r.tokens, c.tokens)
        assert cs.fault_counters(b_eng.stats) == \
            cs.FAULT_COUNTERS["blackout"]
        assert cs.fault_counters(s_eng.stats) == cs.FAULT_COUNTERS["stage"]
        out.append((b_res, s_res))
    for j, t in zip(out[0][1], out[1][1]):
        _held(j, t, dict(atol=ATOL))
    for j, t in zip(out[0][0], out[1][0]):
        assert _scalars(t) == _scalars(j)
    assert out[1][0][0].attempts == 2


def test_refused_knobs_name_their_roadmap_item(system):
    lut = system["tex"].lut
    for kw, item in ((dict(mesh=object(), batching="inflight"), "item 5"),
                     (dict(profile=True), "item 4b"),
                     (dict(debug_recompiles=True), "item 7"),
                     (dict(debug_transfers=True), "item 7")):
        with pytest.raises(NotImplementedError, match=item):
            te.AveryEngine(lut=lut, executor=system["tex"], **kw)
