"""The front door's host half held against the reference: bandwidth traces,
the simulated uplink, the analytic energy model, the split controller, the
control and retry policies, the metrics registry, flight recorder and trace
validators, the fault injectors, and ``AveryEngine.submit_frame`` (the
profiled mission path, which needs no executor).

Every module here is host code (numpy and the standard library), so the
two packages must agree exactly: equal floats, equal decisions, equal
records, equal dumps. No executor is built; the file runs in a few
seconds.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.configs.lisa7b import CONFIG as J7B
from repro.configs.lisa_mini import CONFIG as JMINI
from repro.core import controller as jctl
from repro.core import lut as jlut
from repro.core import packets as jpk
from repro.core.intent import DEFAULT_REQUIREMENTS as JREQ
from repro.core.intent import Intent as JIntent
from repro.engine import engine as jengine
from repro.engine import faults as jfaults
from repro.engine import observability as jobs
from repro.engine import policy as jpol
from repro.engine import speculative as jspec
from repro.engine import transport as jtr
from repro.network import channel as jch
from repro.network import energy as jen
from repro.network import traces as jtraces
from repro_torch.configs import lisa7b as t7b
from repro_torch.configs import lisa_mini as tmini
from repro_torch.core import controller as tctl
from repro_torch.core import lut as tlut
from repro_torch.core import packets as tpk
from repro_torch.core.intent import DEFAULT_REQUIREMENTS as TREQ
from repro_torch.core.intent import Intent as TIntent
from repro_torch.engine import engine as tengine
from repro_torch.engine import faults as tfaults
from repro_torch.engine import observability as tobs
from repro_torch.engine import policy as tpol
from repro_torch.engine import speculative as tspec
from repro_torch.engine import transport as ttr
from repro_torch.network import channel as tch
from repro_torch.network import energy as ten
from repro_torch.network import traces as ttraces

J, T = "reference", "port"
MODS = {J: dict(ctl=jctl, lut=jlut, pk=jpk, req=JREQ, intent=JIntent,
                engine=jengine, faults=jfaults, obs=jobs, pol=jpol,
                spec=jspec, tr=jtr, ch=jch, traces=jtraces),
        T: dict(ctl=tctl, lut=tlut, pk=tpk, req=TREQ, intent=TIntent,
                engine=tengine, faults=tfaults, obs=tobs, pol=tpol,
                spec=tspec, tr=ttr, ch=tch, traces=ttraces)}
BANDWIDTHS = (0.0, 2.0, 3.32, 4.0, 6.5, 8.0, 9.5, 11.68, 12.0, 15.0, 20.0,
              40.0)


def both(fn):
    """``fn(m)`` for the reference's modules and the port's."""
    return fn(MODS[J]), fn(MODS[T])


def _decision(d):
    return (d.stream, d.tier.name if d.tier is not None else None,
            d.feasible, d.throughput_pps)


# ---------------------------------------------------------------------------
# network: traces, channel, energy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_traces_equal(seed):
    for make in (lambda m: m["traces"].paper_trace(seed),
                 lambda m: m["traces"].paper_trace(seed, duration_s=97),
                 lambda m: m["traces"].random_trace(seed, duration_s=200),
                 lambda m: m["traces"].random_trace(seed, 50, 2.0, 30.0),
                 lambda m: m["traces"].constant_trace(8.0 + seed, 60)):
        j, t = both(make)
        np.testing.assert_array_equal(t.samples, j.samples)
        assert (t.name, t.duration_s, t.mean()) == \
            (j.name, j.duration_s, j.mean())
        for s in (-3.0, 0.0, 0.5, 17.9, t.duration_s - 0.1, 1e6):
            assert t.at(s) == j.at(s)


def _packets(m, n):
    rng = np.random.RandomState(5)
    return [m["pk"].Packet(kind="insight" if i % 2 else "context",
                           tier_name="Balanced" if i % 2 else None,
                           seq_id=i, created_at=float(i),
                           payload_bytes=int(rng.randint(1, 4_000_000)))
            for i in range(n)]


def test_channel_records_equal_with_blackouts_and_bounded_log():
    """A trace with dead air inside (a blackout shorter and one longer
    than the timeout) and a dead tail: the same records, the same failed
    deliveries, the same bounded log."""
    samples = np.concatenate([np.full(8, 12.0), np.zeros(5),
                              np.full(5, 3.0), np.zeros(40),
                              np.full(10, 18.0), np.zeros(3)])

    def run(m):
        trace = m["traces"].BandwidthTrace(samples, name="dead-air")
        ch = m["ch"].Channel(trace, blackout_timeout_s=30.0, max_log=6)
        out = []
        for i, p in enumerate(_packets(m, 16)):
            rec = ch.transmit(p, now=1.5 * i + 40.0 * (i == 15))
            out.append((rec.packet.seq_id, rec.start_s, rec.end_s,
                        rec.delivered, rec.latency_s))
        assert len(ch.log) == 6
        return out, ch.busy_until, ch.records_dropped, \
            [r.packet.seq_id for r in ch.log]

    j, t = both(run)
    assert t == j
    assert not all(rec[3] for rec in t[0]) and any(rec[3] for rec in t[0])


@pytest.mark.parametrize("config", ["lisa-7b", "lisa-mini"])
def test_energy_model_equal(config):
    jdep, tdep = {"lisa-7b": (J7B, t7b.CONFIG),
                  "lisa-mini": (JMINI, tmini.CONFIG)}[config]
    tiers = tlut.paper_lut().tiers
    for (jc, tc) in ((jdep.sam, tdep.sam), (jdep.clip, tdep.clip),
                     (jdep.llm, tdep.llm)):
        for seq in (1, 17, 256):
            assert ten.encoder_flops(tc, seq) == jen.encoder_flops(jc, seq)
            assert ten.encoder_flops(tc, seq, 1) == \
                jen.encoder_flops(jc, seq, 1)
        for ctx in (1, 64, 300):
            assert ten.decode_token_flops(tc, ctx) == \
                jen.decode_token_flops(jc, ctx)
            assert ten.decode_token_hbm_bytes(tc, ctx) == \
                jen.decode_token_hbm_bytes(jc, ctx)
    for tier in tiers:
        assert ten.edge_insight_flops(tdep, tier.ratio) == \
            jen.edge_insight_flops(jdep, tier.ratio)
    assert ten.full_edge_flops(tdep) == jen.full_edge_flops(jdep)
    assert ten.bottleneck_flops(1280, 320, 4096) == \
        jen.bottleneck_flops(1280, 320, 4096)
    for dev in ((ten.EdgeDevice(), jen.EdgeDevice()),
                (ten.EdgeDevice(2e12, 10.0), jen.EdgeDevice(2e12, 10.0))):
        t, j = dev
        for f in (0.0, 1e9, 3.3e12):
            assert (t.latency_s(f), t.compute_energy_j(f),
                    t.tx_energy_j(f / 1e3)) == \
                (j.latency_s(f), j.compute_energy_j(f), j.tx_energy_j(f / 1e3))
    tc, jc = ten.CloudDevice(), jen.CloudDevice()
    assert (tc.roofline_s(1e12, 3e9), tc.latency_s(5e11),
            tc.compute_energy_j(5e11)) == \
        (jc.roofline_s(1e12, 3e9), jc.latency_s(5e11),
         jc.compute_energy_j(5e11))


# ---------------------------------------------------------------------------
# controller and policies
# ---------------------------------------------------------------------------

def _requirements(m):
    """The default requirements, and a fidelity floor only the best tiers
    meet, so the feasible set also empties by fidelity."""
    out = dict(m["req"])
    ins = m["intent"].INSIGHT
    out["strict"] = dataclasses.replace(m["req"][ins], min_fidelity=0.55,
                                        min_update_pps=0.8)
    return out


def _select(m, bw, intent, req_key, goal, finetuned):
    reqs = _requirements(m)
    req = reqs[req_key if req_key == "strict" else m["intent"][intent]]
    try:
        sel = m["ctl"].select_configuration(
            bw, m["ctl"].PowerConfig(), m["ctl"].MissionGoal[goal],
            m["intent"][intent], req, m["lut"].paper_lut(),
            finetuned=finetuned)
    except m["ctl"].NoFeasibleInsightTier as e:
        return ("infeasible", str(e))
    return (sel.stream, sel.tier.name if sel.tier else None,
            sel.throughput_pps)


GRID = [(bw, intent, req, goal, ft) for bw in BANDWIDTHS
        for intent in ("CONTEXT", "INSIGHT") for req in ("default", "strict")
        for goal in ("PRIORITIZE_ACCURACY", "PRIORITIZE_THROUGHPUT")
        for ft in (False, True)]


def test_select_configuration_equal_over_grid():
    outcomes = set()
    for bw, intent, req, goal, ft in GRID:
        j, t = both(lambda m: _select(m, bw, intent, req, goal, ft))
        assert t == j, (bw, intent, req, goal, ft)
        outcomes.add(t[0] if t[0] == "infeasible" else t[1])
    # the grid reaches every tier, the Context stream and the empty set
    assert outcomes >= {None, "infeasible", "High Accuracy", "Balanced",
                        "High Throughput"}
    for m in (MODS[J], MODS[T]):
        assert m["ctl"].min_bandwidth_for_tier(
            m["lut"].paper_lut().tiers[0], 0.5) == \
            jctl.min_bandwidth_for_tier(jlut.paper_lut().tiers[0], 0.5)


def _policies(m):
    pol = m["pol"]
    return [pol.AdaptivePolicy(), pol.AdaptivePolicy(overload_queue_depth=2),
            pol.StaticTierPolicy("High Accuracy"),
            pol.StaticTierPolicy("High Throughput"),
            pol.BestEffortPolicy(),
            pol.BestEffortPolicy(pol.AdaptivePolicy(overload_queue_depth=1)),
            pol.policy_from_mode("avery"),
            pol.policy_from_mode("avery", fallback=True),
            pol.policy_from_mode("static", static_tier="Balanced")]


def _policy_run(m):
    """Every policy's select, adapt_to_load and allow_speculation over the
    grid, each decision as a plain tuple."""
    out = []
    lut = m["lut"].paper_lut()
    reqs = _requirements(m)
    stats = [m["spec"].SpecStats(), m["spec"].SpecStats(drafted=8,
                                                        accepted=1),
             m["spec"].SpecStats(drafted=40, accepted=10),
             m["spec"].SpecStats(drafted=40, accepted=30)]
    cfgs = [m["spec"].SpeculativeConfig(),
            m["spec"].SpeculativeConfig(acceptance_floor=0.8,
                                        min_draft_samples=4)]
    for p in _policies(m):
        assert isinstance(p, m["pol"].ControlPolicy)
        out.append([p.allow_speculation(s, c) for s in stats for c in cfgs])
        for bw, intent, req, goal, ft in GRID:
            it = m["intent"][intent]
            d = p.select(bw, it, reqs["strict"] if req == "strict"
                         else reqs[it], lut,
                         goal=m["ctl"].MissionGoal[goal], finetuned=ft)
            out.append(_decision(d))
            for depth in (0, 1, 2, 5):
                out.append(_decision(p.adapt_to_load(
                    d, {"queue_depth": depth}, lut, bw)))
    for bad in (("static", None), ("nonsense", None)):
        with pytest.raises(ValueError):
            m["pol"].policy_from_mode(bad[0], static_tier=bad[1])
    return out


def test_policies_decide_the_same():
    j, t = both(_policy_run)
    assert t == j


def test_retry_policy_backoff_and_downshift_equal():
    def run(m):
        lut = m["lut"].paper_lut()
        reqs = m["req"]
        out = []
        for rp in (m["pol"].RetryPolicy(),
                   m["pol"].RetryPolicy(max_attempts=5, backoff_base_s=0.3,
                                        backoff_factor=3.0),
                   m["pol"].RetryPolicy(downshift=False)):
            out.append([rp.backoff_s(a) for a in range(1, 6)])
            for bw in BANDWIDTHS:
                for intent in (m["intent"].CONTEXT, m["intent"].INSIGHT):
                    for p in _policies(m)[:5]:
                        d = p.select(bw, intent, reqs[intent], lut)
                        for prev in [None] + list(lut.tiers):
                            out.append(_decision(
                                rp.downshifted(d, prev, lut, bw)))
        return out

    j, t = both(run)
    assert t == j


# ---------------------------------------------------------------------------
# observability: metrics registry, flight recorder, validators
# ---------------------------------------------------------------------------

def _metrics_run(m, tmp_path, tag):
    obs = m["obs"]
    reg = obs.MetricsRegistry()
    rng = np.random.RandomState(3)
    for v in np.concatenate([rng.lognormal(-3.0, 2.0, 300), [0.0, 1e-4,
                                                             1e4, 5e4]]):
        reg.histogram("lat_s").observe(v)
        reg.histogram("tok_s", hi=1e6, per_decade=4).observe(v * 1e3)
    reg.counter("served").inc()
    reg.counter("served").inc(4)
    reg.gauge("depth").set(3)
    a, b = obs.Histogram("a"), obs.Histogram("b")
    for v in (0.5, 2.0, 9.0):
        a.observe(v)
    b.observe(0.01)
    merged = a.merge(b).as_dict()
    with pytest.raises(ValueError, match="geometry"):
        a.merge(obs.Histogram("c", lo=1e-3))
    with pytest.raises(ValueError):
        obs.Histogram("d", lo=1.0, hi=0.5)
    h = reg.histogram("lat_s")
    pcts = [h.percentile(q) for q in (0, 1, 25, 50, 75, 95, 99, 100)]
    fr = obs.FlightRecorder(capacity=5, autodump_dir=str(tmp_path / tag))
    assert fr.dump("nothing", path=None) is not None
    for i in range(9):
        fr.record("decode_step", 0.1 * i, request_id=i % 3,
                  data={"slot": i % 2})
    no_dir = obs.FlightRecorder(capacity=2)
    assert no_dir.dump("x") is None
    path = fr.dump("cloud_error", stats={"a": 1, "b": np.float32(2.5),
                                         "c": None})
    with open(path) as f:
        dumped = json.load(f)
    return (reg.as_dict(), merged, pcts, fr.snapshot(), len(fr),
            fr.n_recorded, fr.n_dumps, dumped,
            path.replace(str(tmp_path / tag), ""))


def test_metrics_registry_and_flight_recorder_equal(tmp_path):
    j = _metrics_run(MODS[J], tmp_path, "j")
    t = _metrics_run(MODS[T], tmp_path, "t")
    assert t == j


def _traces(m):
    """A tracer with a valid lifecycle and broken ones: overlapping spans,
    an unknown span, a span ending before it starts, a resume without a
    park, a served request with an open park, an event after a cancel."""
    tr = m["obs"].Tracer(enabled=True, max_requests=8, max_events=6)
    tr.begin(0, "uav-A", "INSIGHT", 0.0)
    tr.span(0, "edge_encode", 0.0, 0.2, tier="Balanced")
    tr.span(0, "transmit", 0.2, 1.0)
    tr.span(0, "queue", 1.0, 1.0)
    tr.span(0, "prefill", 1.0, 1.5, slot=1)
    tr.point(0, "decode_step", 1.6, slot=1, step=0)
    tr.span(0, "decode", 1.5, 2.0, slot=1)
    tr.point(0, "served", 2.0)                       # dropped: cap of 6
    tr.begin(1, "uav-B", "CONTEXT", 0.5)
    tr.span(1, "transmit", 0.5, 1.2)
    tr.span(1, "queue", 1.0, 1.4)
    tr.span(1, "warp", 1.4, 1.3)
    tr.point(1, "resume", 1.5)
    tr.begin(2, "uav-B", "INSIGHT", 0.7)
    tr.point(2, "park", 1.0, slot=0)
    tr.point(2, "served", 2.0)
    tr.point(2, "cancelled", 2.1, reason="deadline")
    tr.point(2, "retry", 2.2)
    off = m["obs"].Tracer()
    off.begin(9, "x")
    off.span(9, "queue", 0.0, 1.0)
    assert len(off) == 0
    return tr


def test_tracer_export_and_validators_equal(tmp_path):
    def run(m):
        tr = _traces(m)
        doc = tr.to_chrome()
        path = tr.dump(str(tmp_path / f"{id(m)}" / "trace.json"))
        with open(path) as f:
            reread = json.load(f)
        per = [m["obs"].validate_trace(x) for x in tr.traces()]
        bad_docs = [m["obs"].validate_chrome_trace(d) for d in (
            {}, {"traceEvents": []},
            {"traceEvents": [{"ph": "X", "pid": 1, "name": "queue",
                              "ts": 0.0, "args": {}}]},
            {"traceEvents": [{"ph": "X", "pid": 3, "name": "stage",
                              "ts": "x"}]},
            {"traceEvents": [{"ph": "X", "pid": 3, "name": "stage",
                              "ts": 1.0, "dur": -1.0}]})]
        return (doc, reread, per, m["obs"].validate_traces(tr),
                m["obs"].validate_chrome_trace(doc), bad_docs,
                [(x.request_id, x.dropped) for x in tr.traces()])

    j, t = both(run)
    assert t == j
    assert t[3] and not all(not p for p in t[2])    # findings were made


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

def test_fault_injector_same_seed_same_outcomes():
    def run(m):
        inner = m["tr"].ChannelTransport.from_trace(
            m["traces"].paper_trace(3, duration_s=120))
        rec = m["obs"].FlightRecorder(capacity=64)
        inj = m["faults"].FaultInjector(
            inner, seed=11, blackouts=[(10.0, 20.0), (15.0, 25.0)],
            spikes=[(40.0, 50.0, 2.5), (45.0, 55.0, 1.0)], drop_rate=0.3,
            sense_lies=[(60.0, 70.0, 3.0)], recorder=rec)
        out = []
        for i, p in enumerate(_packets(m, 40)):
            t = 2.0 * i
            r = inj.send(p, t)
            out.append((inj.bandwidth(t), r.start_s, r.end_s, r.delivered))
        assert isinstance(inj, m["tr"].Transport)
        return (out, inj.stats(), rec.snapshot(), len(inj.records),
                inj.records_dropped)

    j, t = both(run)
    assert t == j
    assert t[1]["fault_drops"] and t[1]["fault_blackout_failures"] \
        and t[1]["fault_spiked"] and t[1]["fault_sense_lies"]


class _Stages:
    """Stand-in executor: every faultable stage returns its call's name."""
    max_new_tokens = 2

    def __getattr__(self, name):
        return lambda *a, **kw: name


def test_faulty_executor_same_seed_same_faults():
    def run(m):
        with pytest.raises(ValueError, match="unknown faultable"):
            m["faults"].FaultyExecutor(_Stages(), fail_at={"edge_context":
                                                           [0]})
        fx = m["faults"].FaultyExecutor(
            _Stages(), fail_at={"cloud_decode_rows": [1, 4]}, p_fail=0.25,
            seed=5, stages=("cloud_decode_rows", "cloud_verify_rows",
                            "cloud_prefix"))
        assert fx.max_new_tokens == 2
        out = []
        for i in range(60):
            stage = m["faults"].FAULTABLE_STAGES[i % 6]
            try:
                out.append(getattr(fx, stage)(i))
            except m["faults"].CloudStageError as e:
                out.append(str(e))
        return out, fx.calls, fx.n_faults

    j, t = both(run)
    assert t == j
    assert t[2] > 2


def test_transports_equal_and_logs_bounded():
    def run(m):
        lb = m["tr"].LoopbackTransport(bandwidth_mbps=42.0, max_records=5)
        ct = m["tr"].ChannelTransport.from_trace(
            m["traces"].constant_trace(10.0, 40))
        ct.channel.max_log = 4
        out = []
        for i, p in enumerate(_packets(m, 9)):
            for tr in (lb, ct):
                r = tr.send(p, 0.3 * i)
                out.append((tr.bandwidth(0.3 * i), r.start_s, r.end_s,
                            r.delivered))
        return (out, len(lb.records), lb.records_dropped, len(ct.records),
                ct.records_dropped)

    j, t = both(run)
    assert t == j


# ---------------------------------------------------------------------------
# the profiled mission path: AveryEngine.submit_frame, no executor
# ---------------------------------------------------------------------------

def _response(r):
    """A Response as comparable plain data (enums by value)."""
    d = dataclasses.asdict(r)
    d["intent"] = r.intent.value
    d["events"] = [(e.kind, e.t, e.data) for e in r.events]
    return d


def _mission(m, goal, tmp_path):
    """Two operators over a paper trace with a blackout window, a sense
    lie and drops, a retry policy, a deadline on one session and a rate
    limit: a frame every 0.7 s, Insight with every third frame Context."""
    eng_mod, pol = m["engine"], m["pol"]
    inner = m["tr"].ChannelTransport.from_trace(
        m["traces"].paper_trace(2, duration_s=120))
    transport = m["faults"].FaultInjector(
        inner, seed=4, blackouts=[(6.0, 9.5)], drop_rate=0.15,
        sense_lies=[(20.0, 24.0, 2.0)])
    sched = m["engine"].FifoScheduler()
    engine = eng_mod.AveryEngine(
        lut=m["lut"].paper_lut(), transport=transport,
        policy=pol.BestEffortPolicy() if goal == "best" else
        pol.AdaptivePolicy(), retry=pol.RetryPolicy(max_attempts=3,
                                                    backoff_base_s=0.4),
        scheduler=sched, trace=True, flight_events=32,
        flight_dir=str(tmp_path))
    a = engine.session("uav-A")
    b = engine.session("uav-B",
                       goal=m["ctl"].MissionGoal.PRIORITIZE_THROUGHPUT,
                       finetuned=True)
    b.requirements[m["intent"].INSIGHT] = dataclasses.replace(
        b.requirements[m["intent"].INSIGHT], max_latency_s=3.0)
    out = []
    for i in range(40):
        sess = (a, b)[i % 2]
        intent = m["intent"].CONTEXT if i % 3 == 2 else m["intent"].INSIGHT
        out.append(_response(sess.submit_frame(0.7 * i, intent=intent)))
    doc = engine.tracer.to_chrome()
    return (out, engine.stats, engine.flight.snapshot(),
            engine.metrics.as_dict(), doc,
            m["obs"].validate_chrome_trace(doc), transport.stats())


@pytest.mark.parametrize("policy", ["adaptive", "best"])
def test_submit_frame_mission_equal(policy, tmp_path):
    j = _mission(MODS[J], policy, tmp_path / "j")
    t = _mission(MODS[T], policy, tmp_path / "t")
    assert t == j
    stats = t[1]
    assert stats["retries"] > 0 and stats["downshifts"] > 0
    assert stats["completed"] > 0 and stats["submitted"] == 40
    failures = {r["failure"] for r in t[0]}
    assert None in failures and len(failures) > 1
    assert t[5] == []                        # the trace validates


def test_rate_limited_frames_shed_alike():
    from repro.engine import QoSScheduler as JQoS
    from repro_torch.engine import QoSScheduler as TQoS

    def run(m, qos):
        engine = m["engine"].AveryEngine(
            lut=m["lut"].paper_lut(), scheduler=qos(rate_per_s=1.0,
                                                    burst=2.0))
        s = engine.session("uav-A")
        out = [_response(s.submit_frame(0.1 * i)) for i in range(6)]
        return out, engine.stats

    j, t = run(MODS[J], JQoS), run(MODS[T], TQoS)
    assert t == j
    assert t[1]["rejected"] > 0


def test_engine_without_executor_refuses_real_submissions():
    for m in (MODS[J], MODS[T]):
        engine = m["engine"].AveryEngine(lut=m["lut"].paper_lut())
        with pytest.raises(RuntimeError, match="no executor"):
            engine.session("op").submit(prompt="segment the boat")
        assert engine.stats["submitted"] == 0
        with pytest.raises(ValueError, match="batching"):
            m["engine"].AveryEngine(lut=m["lut"].paper_lut(),
                                    batching="bogus")
        with pytest.raises(ValueError, match="in-flight"):
            m["engine"].AveryEngine(lut=m["lut"].paper_lut(),
                                    speculative=True)
