"""The slice end to end: the port's speculative ``InflightDecoder`` (a
``DraftModel`` proposing, one paged multi-token verify pass scoring)
against the reference's, on bridged lisa_mini weights and the same packets
(edge-encoded by the reference, so both cloud sides see identical codes).

The executors serve 6 new tokens over pages of 4 slots, as the reference's
own speculative tests do (``tests/test_decode_consistency.py``): draft
overhangs cross page boundaries, so rollback really fires. The reference
runs with ``flash_decode=False`` (its plain attention, which keeps tier-1
time down; the Pallas kernels are held against the port's plain versions
in tests/test_torch_kernels.py). The port runs with ``flash_decode=True``
on CPU tensors, so its draft and verify attention are the kernels' plain
versions through the kernel wrappers.

Tolerances: greedy tokens exactly equal, and every ``SpecStats`` field,
the draft model's step and prefill counts, the decoder's step counts and
the page pool's stats exactly equal; logits and masks atol 3e-4 (the
reference's own in-flight bound, tests/test_engine.py). Each port result
is also held against the port's own one-shot ``cloud_generate_batch``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lisa_nano as jnano
from repro.configs.lisa_mini import CONFIG as JP
from repro.core import DualStreamExecutor as JExecutor
from repro.core import vlm as jvlm
from repro.core.intent import Intent as JIntent
from repro.core.profile import random_init_system
from repro.data import floodseg
from repro.engine import CloudStageError as JStageError
from repro.engine import InflightDecoder as JDecoder
from repro.engine import QoSScheduler as JQoS
from repro.engine import speculative as jspec
from repro_torch.configs import get_lisa_config
from repro_torch.configs import lisa_nano as tnano
from repro_torch.core import lut as tlut
from repro_torch.core import packets as tpk
from repro_torch.core.intent import Intent as TIntent
from repro_torch.core.streams import DualStreamExecutor as TExecutor
from repro_torch.engine import CloudStageError as TStageError
from repro_torch.engine import InflightDecoder as TDecoder
from repro_torch.engine import QoSScheduler as TQoS
from repro_torch.engine import speculative as tspec

torch.set_num_threads(1)

TP = get_lisa_config("lisa-mini")
T = 6                                       # max_new_tokens
PAGE = 4
ATOL = 3e-4
STATS = ("drafted", "accepted", "emitted", "row_steps", "disabled_steps",
         "pages_rolled_back")


@pytest.fixture(scope="module")
def executors():
    params, bns, lut = random_init_system(JP, seed=0)
    jex = JExecutor(pcfg=JP, params=params, bottlenecks=bns, lut=lut,
                    max_new_tokens=T, flash_decode=False, page_size=PAGE)
    tex = TExecutor(pcfg=TP, params=jax.tree.map(np.asarray, params),
                    bottlenecks=jax.tree.map(np.asarray, bns),
                    lut=tlut.paper_lut(), max_new_tokens=T,
                    flash_decode=True, page_size=PAGE, device="cpu")
    return jex, tex


def _port_packet(p):
    return tpk.Packet(kind=p.kind, tier_name=p.tier_name, seq_id=p.seq_id,
                      created_at=p.created_at, payload_bytes=p.payload_bytes,
                      content={k: np.asarray(v) for k, v in p.content.items()})


@pytest.fixture(scope="module")
def requests(executors):
    """Five frames edge-encoded by the reference: Context every third,
    Insight frames over two tiers. Each item is (reference packet, port
    packet, query, intent value)."""
    jex, _ = executors
    rng = np.random.RandomState(13)
    out = []
    for i in range(5):
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


def _serve(port, executor, reqs, schedule, slots, spec, gate=None,
           plain=()):
    """Submit ``reqs`` in waves (``schedule``: lists of (request index,
    operator)), one step between waves, then drain. Submissions whose
    sequence number is in ``plain`` opt out of drafting. Returns the
    decoder and its results by seq_id."""
    cls, intent = (TDecoder, TIntent) if port else (JDecoder, JIntent)
    dec = cls(executor, slots=slots, spec=spec, spec_gate=gate)
    done = {}
    seq = 0
    for wave in schedule:
        for i, operator in wave:
            jpkt, tpkt, query, kind = reqs[i]
            dec.submit(seq, intent(kind), tpkt if port else jpkt, query,
                       lambda r: done.__setitem__(r["seq_id"], r),
                       operator_id=operator,
                       speculative=False if seq in plain else None)
            seq += 1
        dec.pump(1)
    dec.drain()
    assert len(done) == seq
    return dec, done


def _held_against_reference(executors, reqs, schedule, slots, jspec_cfg,
                            tspec_cfg, gate=None, plain=()):
    """Serve the schedule on both decoders and hold the port to the
    reference and to its own one-shot generate path."""
    jex, tex = executors
    jdec, jdone = _serve(False, jex, reqs, schedule, slots, jspec_cfg, gate,
                         plain)
    tdec, tdone = _serve(True, tex, reqs, schedule, slots, tspec_cfg, gate,
                         plain)
    for f in STATS:
        assert getattr(tdec.spec_stats, f) == getattr(jdec.spec_stats, f), f
    assert tdec.spec_stats.as_dict() == jdec.spec_stats.as_dict()
    for attr in ("n_steps", "n_slot_steps", "n_served", "step_idx"):
        assert getattr(tdec, attr) == getattr(jdec, attr), attr
    if jdec.draft is not None:
        assert (tdec.draft.n_steps, tdec.draft.n_prefills) == \
            (jdec.draft.n_steps, jdec.draft.n_prefills)
    assert tdec.pool.stats() == jdec.pool.stats()
    tdec.pool.check_invariants()
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
        for key in ("joined_step", "prefix_hit", "speculative",
                    "batch_size"):
            assert t[key] == j[key], key
        _, tpkt, query, _ = reqs[i]
        want = tex.cloud_generate_batch([tpkt], [query])[0]
        np.testing.assert_array_equal(t["tokens"], want[-1])
        if t["mask_logits"] is not None:
            np.testing.assert_allclose(t["mask_logits"], want[0], atol=ATOL)
    return tdec, tdone


def test_shared_draft_accepts_everything(executors, requests):
    """The serving model's own weights draft: every draft is accepted, and
    rows join a running batch mid-stream."""
    schedule = [[(0, "uav-A"), (1, "uav-A")], [(2, "uav-B")], [(3, "uav-B")]]
    dec, done = _held_against_reference(
        executors, requests, schedule, 3, jspec.SpeculativeConfig(3),
        tspec.SpeculativeConfig(3))
    st = dec.spec_stats
    assert st.acceptance_rate == 1.0 and st.tokens_per_step >= 1.5
    assert max(r["joined_step"] for r in done.values()) > 0


@pytest.fixture(scope="module")
def divergent():
    """A random draft of lisa_mini geometry (other weights than the
    serving model's)."""
    return jvlm.init_lisa(JP, jax.random.PRNGKey(99))


def test_divergent_draft_rolls_back_pages(executors, requests, divergent):
    """A random draft of lisa_mini geometry (other weights), four drafts
    a round, five requests on two slots: rejections, corrections and page
    rollback, with slot and page reuse."""
    draft = divergent
    schedule = [[(i, "uav-A") for i in range(5)]]
    dec, _ = _held_against_reference(
        executors, requests, schedule, 2,
        jspec.SpeculativeConfig(4, draft_params=draft),
        tspec.SpeculativeConfig(4, draft_params=jax.tree.map(np.asarray,
                                                             draft)))
    st = dec.spec_stats
    assert st.acceptance_rate < 1.0 and st.pages_rolled_back > 0
    assert dec.pool.pages_in_use == len(dec.pool.prefix) * dec.n_prefix_pages


def test_mixed_plain_and_speculating_rows_share_verify_batches(executors,
                                                               requests):
    """Every other request opts out of drafting: plain rows ride the
    verify batches as chunks of one."""
    schedule = [[(i, "uav-A") for i in range(4)]]
    dec, done = _held_against_reference(
        executors, requests, schedule, 4, jspec.SpeculativeConfig(3),
        tspec.SpeculativeConfig(3), plain=(1, 3))
    assert [done[i]["speculative"] for i in range(4)] == \
        [True, False, True, False]
    assert dec.spec_stats.tokens_per_step > 1.0


def test_nano_draft(executors, requests):
    """The layer-truncated lisa_nano view of the serving weights drafts."""
    jex, tex = executors
    schedule = [[(0, "uav-A"), (2, "uav-A"), (4, "uav-B")]]
    dec, _ = _held_against_reference(
        executors, requests, schedule, 3,
        jspec.SpeculativeConfig(3, draft_params=jnano.nano_draft_params(
            jex.params), draft_pcfg=jnano.CONFIG),
        tspec.SpeculativeConfig(3, draft_params=tnano.nano_draft_params(
            tex.params), draft_pcfg=tnano.CONFIG))
    assert dec.draft.pcfg.llm.num_layers == tnano.DRAFT_LAYERS
    assert dec.spec_stats.drafted > 0
    # a view of the serving weights: no copy
    assert dec.draft.params["llm"]["embed"] is tex.params["llm"]["embed"]
    assert dec.draft.params["llm"]["groups"][0]["attn"]["wq"] \
        .data_ptr() == tex.params["llm"]["groups"][0]["attn"]["wq"] \
        .data_ptr()


def test_repeat_frames_reuse_the_draft_prefill(executors, requests):
    """One operator's repeated frame hits the serving prefix store and the
    draft's prefix rows alike: one draft prefill for three submissions;
    another operator's identical frame pays its own."""
    schedule = [[(0, "uav-A"), (0, "uav-A")], [(0, "uav-A"), (0, "uav-B")]]
    dec, done = _held_against_reference(
        executors, requests, schedule, 2, jspec.SpeculativeConfig(3),
        tspec.SpeculativeConfig(3))
    assert dec.draft.n_prefills == 2
    assert [done[s]["prefix_hit"] for s in range(4)] == \
        [False, True, True, False]


def test_shared_draft_prefix_rows_survive_decoder_retirement(executors,
                                                             requests):
    """A successor decoder on the same pool, handed its predecessor's draft
    prefix rows, serves a repeated frame with no draft prefill at all, and
    gives the reference's tokens."""
    jex, tex = executors
    tokens = []
    for port, ex in ((False, jex), (True, tex)):
        cls, intent = (TDecoder, TIntent) if port else (JDecoder, JIntent)
        cfg = (tspec if port else jspec).SpeculativeConfig(3)
        jpkt, tpkt, query, kind = requests[1]
        pkt = tpkt if port else jpkt
        done = {}
        first = cls(ex, slots=2, spec=cfg)
        first.submit(0, intent(kind), pkt, query,
                     lambda r: done.__setitem__(r["seq_id"], r),
                     operator_id="uav-A")
        first.drain()
        second = cls(ex, slots=2, pool=first.pool, spec=cfg,
                     spec_prefix_rows=first.draft._prefix_rows)
        second.submit(1, intent(kind), pkt, query,
                      lambda r: done.__setitem__(r["seq_id"], r),
                      operator_id="uav-A")
        second.drain()
        assert (first.draft.n_prefills, second.draft.n_prefills) == (1, 0)
        assert done[1]["prefix_hit"]
        tokens.append([np.asarray(done[i]["tokens"]) for i in (0, 1)])
    for j, t in zip(*tokens):
        np.testing.assert_array_equal(t, j)


def test_policy_gate_vetoes_drafting(executors, requests):
    """A gate that allows two drafting row-steps, then vetoes: later steps
    fall back to the plain path and count ``disabled_steps``."""
    schedule = [[(1, "uav-A"), (3, "uav-A")]]
    dec, _ = _held_against_reference(
        executors, requests, schedule, 2, jspec.SpeculativeConfig(2),
        tspec.SpeculativeConfig(2), gate=lambda st: st.row_steps < 2)
    assert dec.spec_stats.disabled_steps > 0
    assert dec.spec_stats.row_steps == 2


# ---------------------------------------------------------------------------
# host units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drafts,greedy", [
    ([], []), ([4], [4]), ([4], [5]), ([1, 2, 3], [1, 2, 3, 9]),
    ([1, 2, 3], [1, 7, 3, 9]), ([np.int32(5), 6], [5, np.int64(6), 0])])
def test_greedy_accept_matches_reference(drafts, greedy):
    assert tspec.greedy_accept(drafts, greedy) == \
        jspec.greedy_accept(drafts, greedy)


def test_spec_stats_merge_and_as_dict_match_reference():
    chunks = [(3, 3, 4), (3, 1, 2), (4, 0, 1), (2, 2, 3)]
    stats = []
    for mod in (tspec, jspec):
        a, b = mod.SpecStats(), mod.SpecStats(disabled_steps=2,
                                              pages_rolled_back=5)
        for i, (d, acc, e) in enumerate(chunks):
            (a if i % 2 else b).note_chunk(d, acc, e)
        a.merge(b)
        stats.append(a)
    t, j = stats
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.as_dict() == j.as_dict()
    assert (t.acceptance_rate, t.tokens_per_step) == \
        (j.acceptance_rate, j.tokens_per_step)
    empty = tspec.SpecStats()
    assert (empty.acceptance_rate, empty.tokens_per_step) == (0.0, 0.0)


def test_speculative_config_validation_matches_reference():
    for mod in (tspec, jspec):
        with pytest.raises(ValueError, match="draft_tokens"):
            mod.SpeculativeConfig(draft_tokens=0)
    t, j = tspec.SpeculativeConfig(), jspec.SpeculativeConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_sharded_draft_stages_raise(executors):
    """``DraftModel(fns_factory=)`` is ported (ROADMAP.md Queue 1 item 5a):
    the factory is asked once, with the draft's config (its
    ``use_flash_decode`` set), ring width and weights, and the draft's
    prefill, steps and row inserts run through the stages it returns, as
    the reference's do (``ShardedServingContext.draft_fns``); a factory
    that is not callable raises."""
    _, tex = executors
    asked, ran = [], {"prefill": 0, "step": 0, "insert": 0}

    def factory(pcfg, width, params):
        asked.append((pcfg.llm.use_flash_decode, width))
        prefill, step, insert = tspec._draft_fns(pcfg, width, params)

        def counted(name, fn):
            def run(*a):
                ran[name] += 1
                return fn(*a)
            return run
        return (counted("prefill", prefill), counted("step", step),
                counted("insert", insert))

    draft = tspec.DraftModel(tex.params, TP, slots=2, prefix_len=24,
                             max_new_tokens=T, draft_tokens=3,
                             flash_decode=True, fns_factory=factory,
                             device="cpu")
    assert asked == [(True, draft.width)]
    rng = np.random.RandomState(0)
    ctx = rng.randn(1, 16, TP.llm.d_model).astype(np.float32)
    query = rng.randint(0, TP.llm.vocab_size, (1, 8)).astype(np.int32)
    draft.admit(0, ctx, query)
    proposals = draft.draft({0: [int(query[0, -1])]}, 3)
    assert ran == {"prefill": 1, "step": draft.n_steps, "insert": 1}
    assert len(proposals[0]) == 3 and draft.n_steps == 3
    with pytest.raises(TypeError):
        tspec.DraftModel(tex.params, TP, slots=2, prefix_len=24,
                         max_new_tokens=T, draft_tokens=3,
                         fns_factory=object(), device="cpu")


# ---------------------------------------------------------------------------
# speculation under QoS preemption
# ---------------------------------------------------------------------------

class _FailingVerify:
    """An executor whose ``cloud_verify_rows`` raises the package's
    ``CloudStageError`` on its ``fail_at``-th call; every other attribute
    is the wrapped executor's."""

    def __init__(self, inner, error, fail_at):
        self.inner, self.error, self.fail_at, self.calls = \
            inner, error, fail_at, 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def cloud_verify_rows(self, *args):
        self.calls += 1
        if self.calls == self.fail_at:
            raise self.error("injected verify fault")
        return self.inner.cloud_verify_rows(*args)


# Insight frames 0 and 1 start drafting; one step later the Context frame
# 2 arrives and, with no latency patience, parks the lowest-ranked
# speculating row, which later resumes by replaying its tokens; frame 3
# queues behind them.
PREEMPT_WAVES = ([(0, "uav-A"), (1, "uav-B")], [(2, "uav-B")],
                 [(3, "uav-A")])


def _serve_preempted(port, executor, reqs, slots, spec, fail_at):
    cls, intent, qos, error = ((TDecoder, TIntent, TQoS, TStageError)
                               if port else
                               (JDecoder, JIntent, JQoS, JStageError))
    if fail_at is not None:
        executor = _FailingVerify(executor, error, fail_at)
    dec = cls(executor, slots=slots, spec=spec,
              scheduler=qos(latency_patience_s=0.0))
    done = {}
    seq = 0
    for wave in PREEMPT_WAVES:
        for i, operator in wave:
            jpkt, tpkt, query, kind = reqs[i]
            dec.submit(seq, intent(kind), tpkt if port else jpkt, query,
                       lambda r: done.__setitem__(r["seq_id"], r),
                       operator_id=operator)
            seq += 1
        dec.pump(1)
    dec.drain()
    assert sorted(done) == list(range(seq))
    return dec, done


@pytest.mark.parametrize("slots,draft,fail_at", [
    (1, "shared", None), (2, "shared", None), (1, "divergent", None),
    (2, "divergent", None), (2, "shared", 2), (1, "divergent", 3)])
def test_speculation_under_qos_preemption(executors, requests, divergent,
                                          slots, draft, fail_at):
    """Speculating rows parked by QoS preemption resume token-exactly, on
    one and two slots, with a shared and a divergent draft, and with a
    ``CloudStageError`` from ``cloud_verify_rows`` failing every live row
    of that step: tokens, failures, ``SpecStats``, preemptions and the
    pool's stats equal the reference's."""
    jex, tex = executors
    cfg = {"shared": (jspec.SpeculativeConfig(3),
                      tspec.SpeculativeConfig(3)),
           "divergent": (jspec.SpeculativeConfig(4, draft_params=divergent),
                         tspec.SpeculativeConfig(4, draft_params=jax.tree.map(
                             np.asarray, divergent)))}[draft]
    jdec, jdone = _serve_preempted(False, jex, requests, slots, cfg[0],
                                   fail_at)
    tdec, tdone = _serve_preempted(True, tex, requests, slots, cfg[1],
                                   fail_at)
    for f in STATS:
        assert getattr(tdec.spec_stats, f) == getattr(jdec.spec_stats, f), f
    for attr in ("n_steps", "n_slot_steps", "n_served", "n_preempted",
                 "n_stage_faults", "step_idx"):
        assert getattr(tdec, attr) == getattr(jdec, attr), attr
    assert (tdec.draft.n_steps, tdec.draft.n_prefills) == \
        (jdec.draft.n_steps, jdec.draft.n_prefills)
    assert tdec.pool.stats() == jdec.pool.stats()
    tdec.pool.check_invariants()
    assert tdec.scheduler.stats() == jdec.scheduler.stats()
    order = [i for wave in PREEMPT_WAVES for i, _ in wave]
    for sid, i in enumerate(order):
        j, t = jdone[sid], tdone[sid]
        assert t.get("failure") == j.get("failure")
        if "failure" in t:
            continue
        np.testing.assert_array_equal(t["tokens"], np.asarray(j["tokens"]))
        np.testing.assert_allclose(t["answer_logits"],
                                   np.asarray(j["answer_logits"]), atol=ATOL)
        for key in ("joined_step", "prefix_hit", "speculative",
                    "batch_size", "preemptions"):
            assert t[key] == j[key], key
        _, tpkt, query, _ = requests[i]
        want = tex.cloud_generate_batch([tpkt], [query])[0]
        np.testing.assert_array_equal(t["tokens"], want[-1])
    assert tdec.n_preempted >= 1 or fail_at is not None
    if fail_at is not None:
        assert tdec.n_stage_faults == 1
        assert any(r.get("failure") == "cloud_error" for r in tdone.values())
