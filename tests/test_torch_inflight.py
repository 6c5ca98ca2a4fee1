"""The slice end to end: the port's ``InflightDecoder`` over a paged,
shared-prefix ``PagePool`` against the reference's, on bridged lisa_mini
weights and the same packets (edge-encoded by the reference, so both cloud
sides see identical codes).

The reference runs with ``flash_decode=False`` (its plain gather + SDPA
decode attention, which keeps tier-1 time down; the Pallas kernel is held
against the port's plain version in tests/test_torch_kernels.py). The
port runs with ``flash_decode=True`` on CPU tensors, so its decode
attention is the paged kernel's plain version through the kernel wrapper.

Tolerances: greedy tokens exactly equal; logits and masks atol 3e-4 (the
reference's own in-flight bound, tests/test_engine.py). Admission steps,
prefix hits, preemptions, step counts and pages in use must be equal. Each
port result is also held against the port's own one-shot
``cloud_generate_batch``, the in-flight path's oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lisa_mini import CONFIG as JP
from repro.core import DualStreamExecutor as JExecutor
from repro.core.intent import Intent as JIntent
from repro.core.profile import random_init_system
from repro.data import floodseg
from repro.engine import CloudStageError as JStageError
from repro.engine import InflightDecoder as JDecoder
from repro.engine import QoSScheduler as JQoS
from repro.engine import Tracer as JTracer
from repro_torch.configs import get_lisa_config
from repro_torch.core import lut as tlut
from repro_torch.core import packets as tpk
from repro_torch.core.intent import Intent as TIntent
from repro_torch.core.streams import DualStreamExecutor as TExecutor
from repro_torch.engine import CloudStageError as TStageError
from repro_torch.engine import InflightDecoder as TDecoder
from repro_torch.engine import QoSScheduler as TQoS
from repro_torch.engine import Tracer as TTracer

torch.set_num_threads(1)

TP = get_lisa_config("lisa-mini")
T = 3                                       # max_new_tokens
ATOL = 3e-4


@pytest.fixture(scope="module")
def executors():
    params, bns, lut = random_init_system(JP, seed=0)
    jex = JExecutor(pcfg=JP, params=params, bottlenecks=bns, lut=lut,
                    max_new_tokens=T, flash_decode=False)
    tex = TExecutor(pcfg=TP, params=jax.tree.map(np.asarray, params),
                    bottlenecks=jax.tree.map(np.asarray, bns),
                    lut=tlut.paper_lut(), max_new_tokens=T,
                    flash_decode=True, device="cpu")
    return jex, tex


def _port_packet(p):
    return tpk.Packet(kind=p.kind, tier_name=p.tier_name, seq_id=p.seq_id,
                      created_at=p.created_at, payload_bytes=p.payload_bytes,
                      content={k: np.asarray(v) for k, v in p.content.items()})


@pytest.fixture(scope="module")
def requests(executors):
    """Six requests edge-encoded by the reference: Context every third
    frame, Insight frames over two tiers. Each item is (reference packet,
    port packet, query, intent value)."""
    jex, _ = executors
    rng = np.random.RandomState(31)
    out = []
    for i in range(6):
        kind = "any" if i % 3 == 2 else "segment"
        b = floodseg.make_batch(rng, 1, kind, augment=False)
        img = jnp.asarray(b["images"])
        if kind == "any":
            pkt, _ = jex.edge_context(img, i, 0.0)
        else:
            pkt = jex.edge_insight(img, jex.lut.tiers[i % 2], i, 0.0)
        out.append((pkt, _port_packet(pkt), np.asarray(b["query"]),
                    "context" if kind == "any" else "insight"))
    return out


def _serve(port, executor, reqs, schedule, slots, scheduler=None):
    """Submit ``reqs`` in waves (``schedule``: lists of (request index,
    operator)), one decode step between waves, then drain. Returns the
    decoder (tracing enabled) and its results by seq_id."""
    cls, intent, tracer = ((TDecoder, TIntent, TTracer) if port
                           else (JDecoder, JIntent, JTracer))
    dec = cls(executor, slots=slots, scheduler=scheduler,
              tracer=tracer(enabled=True))
    done = {}
    seq = 0
    for wave in schedule:
        for i, operator in wave:
            jpkt, tpkt, query, kind = reqs[i]
            dec.submit(seq, intent(kind), tpkt if port else jpkt, query,
                       lambda r: done.__setitem__(r["seq_id"], r),
                       operator_id=operator)
            seq += 1
        dec.pump(1)
    dec.drain()
    assert len(done) == seq
    return dec, done


def _traced(tracer):
    """Every request's spans and points as comparable tuples."""
    return {tr.request_id: [(sp.name, sp.t0, sp.t1, sp.slot, sp.args)
                            for sp in tr.spans + tr.points]
            for tr in tracer.traces()}


def _held_against_reference(executors, reqs, schedule, slots, qos=None):
    """Serve the schedule on both decoders (FIFO admission, or each
    package's ``QoSScheduler(**qos)``) and hold the port to the
    reference and to its own one-shot generate path."""
    jex, tex = executors
    jdec, jdone = _serve(False, jex, reqs, schedule, slots,
                         None if qos is None else JQoS(**qos))
    tdec, tdone = _serve(True, tex, reqs, schedule, slots,
                         None if qos is None else TQoS(**qos))
    for attr in ("n_steps", "n_slot_steps", "n_served", "n_preempted",
                 "step_idx"):
        assert getattr(tdec, attr) == getattr(jdec, attr), attr
    assert tdec.pool.pages_in_use == jdec.pool.pages_in_use
    assert tdec.pool.stats() == jdec.pool.stats()
    tdec.pool.check_invariants()
    assert _traced(tdec.tracer) == _traced(jdec.tracer)
    order = [i for wave in schedule for i, _ in wave]
    for sid, i in enumerate(order):
        j, t = jdone[sid], tdone[sid]
        assert "failure" not in t
        np.testing.assert_array_equal(t["tokens"], np.asarray(j["tokens"]))
        np.testing.assert_allclose(t["answer_logits"],
                                   np.asarray(j["answer_logits"]), atol=ATOL)
        if j["mask_logits"] is None:
            assert t["mask_logits"] is None
        else:
            np.testing.assert_allclose(t["mask_logits"],
                                       np.asarray(j["mask_logits"]),
                                       atol=ATOL)
        for key in ("joined_step", "prefix_hit", "preemptions",
                    "batch_size", "tier_name"):
            assert t[key] == j[key], key
        assert t["intent"].value == j["intent"].value
        # the port's own oracle: its one-shot generate path
        _, tpkt, query, _ = reqs[i]
        want = tex.cloud_generate_batch([tpkt], [query])[0]
        np.testing.assert_array_equal(t["tokens"], want[-1])
        np.testing.assert_allclose(t["answer_logits"], want[-2], atol=ATOL)
        if t["mask_logits"] is not None:
            np.testing.assert_allclose(t["mask_logits"], want[0], atol=ATOL)
    return tdec, tdone


def test_staggered_joins_across_tiers_and_intents(executors, requests):
    """One request per wave on 3 slots: later requests join a running
    batch mid-stream, mixing Context and Insight rows of two tiers."""
    schedule = [[(i, "uav-A")] for i in range(6)]
    dec, done = _held_against_reference(executors, requests, schedule, 3)
    assert max(r["joined_step"] for r in done.values()) > 0
    assert dec.mean_live_slots > 1.0
    assert {r["tier_name"] for r in done.values()} > {None}


def test_more_requests_than_slots_reuse_slots_and_pages(executors,
                                                        requests):
    """Five requests on two slots: slots and private pages are reused, and
    only the cached prefix pages stay pinned after the drain."""
    schedule = [[(i, "uav-A") for i in range(5)]]
    dec, done = _held_against_reference(executors, requests, schedule, 2)
    assert sorted(r["joined_step"] for r in done.values())[-1] > 0
    per_prefix = dec.n_prefix_pages
    assert dec.pool.pages_in_use == len(dec.pool.prefix) * per_prefix


def test_repeat_prefix_hits_and_qos_preemption_round_trip(executors,
                                                          requests):
    """A repeated frame of one operator hits the prefix store (another
    operator's identical frame does not), and on one slot under a
    QoSScheduler with no latency patience, a Context request parks the
    running Insight decode, which resumes and replays token-exactly."""
    schedule = [[(0, "uav-A")], [(0, "uav-A")], [(0, "uav-B")], [],
                [(2, "uav-B"), (1, "uav-A")]]
    dec, done = _held_against_reference(executors, requests, schedule, 1,
                                        qos={"latency_patience_s": 0.0})
    assert [done[s]["prefix_hit"] for s in range(3)] == [False, True, False]
    parked = [s for s, r in done.items() if r["preemptions"]]
    assert len(parked) == 1 and dec.n_preempted == 1
    assert done[parked[0]]["intent"] is TIntent.INSIGHT
    assert dec.scheduler.telemetry.tokens_replayed >= 1


def test_unported_options_raise(executors):
    """Speculation and the metrics hooks are ported
    (tests/test_torch_speculative.py, tests/test_torch_engine.py); the
    stage profiler and the cost ledger are not."""
    _, tex = executors
    for kw in ({"profiler": object()}, {"cost": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TDecoder(tex, slots=2, **kw)


class _FailingDecode:
    """An executor whose ``cloud_decode_rows`` raises the package's
    ``CloudStageError`` on its ``fail_at``-th call; every other attribute
    is the wrapped executor's."""

    def __init__(self, inner, error, fail_at):
        self.inner, self.error, self.fail_at, self.calls = \
            inner, error, fail_at, 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def cloud_decode_rows(self, *args):
        self.calls += 1
        if self.calls == self.fail_at:
            raise self.error("injected decode fault")
        return self.inner.cloud_decode_rows(*args)


def _fault_and_cancel(port, executor, reqs):
    """On 2 slots: a decode-stage fault fails both live rows (seqs 0, 1)
    and frees their pages; seqs 2 and 3 then take the slots; seq 5 is
    cancelled while queued, seq 3 mid-decode, which lets seq 4 in, whose
    expired deadline resolves it before any prefill; seqs 2 and 6 are
    served."""
    cls, intent, error = ((TDecoder, TIntent, TStageError) if port
                          else (JDecoder, JIntent, JStageError))
    dec = cls(_FailingDecode(executor, error, fail_at=2), slots=2)
    done = {}

    def submit(seq, i, deadline=None):
        jpkt, tpkt, query, kind = reqs[i]
        dec.submit(seq, intent(kind), tpkt if port else jpkt, query,
                   lambda r: done.__setitem__(r["seq_id"], r),
                   operator_id="uav-A", deadline=deadline)

    for seq in range(6):
        submit(seq, seq, deadline=0.0 if seq == 4 else None)
    dec.pump(2)                  # the second step fails seqs 0 and 1
    cancelled = (dec.cancel(5), dec.cancel(3), dec.cancel(99))
    submit(6, 5)
    dec.drain()
    return dec, done, cancelled


def test_stage_fault_cancel_and_deadline_match_reference(executors,
                                                         requests):
    jex, tex = executors
    jdec, jdone, jc = _fault_and_cancel(False, jex, requests)
    tdec, tdone, tc = _fault_and_cancel(True, tex, requests)
    assert tc == jc == (True, True, False)
    assert sorted(tdone) == sorted(jdone) == [0, 1, 2, 4, 6]
    assert [tdone[s]["failure"] for s in (0, 1, 4)] == \
        [jdone[s]["failure"] for s in (0, 1, 4)] == \
        ["cloud_error", "cloud_error", "deadline"]
    for sid in (2, 6):
        assert "failure" not in tdone[sid]
        np.testing.assert_array_equal(tdone[sid]["tokens"],
                                      np.asarray(jdone[sid]["tokens"]))
        assert tdone[sid]["joined_step"] == jdone[sid]["joined_step"]
    for attr in ("n_stage_faults", "n_cancelled", "n_expired", "n_served",
                 "n_steps"):
        assert getattr(tdec, attr) == getattr(jdec, attr), attr
    assert tdec.pool.stats() == jdec.pool.stats()
    tdec.pool.check_invariants()
