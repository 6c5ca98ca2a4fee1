"""The slice end to end: ``MicrobatchScheduler(generate=True)`` serving six
mixed Context/Insight requests over two bottleneck tiers, in the reference
(``DualStreamExecutor(flash_decode=True)``, the Pallas decode kernel in
interpret mode) and in the port on ``device="cpu"``, on bridged lisa_mini
weights. Both cloud sides get the reference's packets, so they see
identical codes; the edge stages are compared on their own.

Tolerances: greedy tokens exactly equal; logits and masks rtol 1e-4,
atol 1e-4 (fp32 summation order through the layers); codes +-1 on fewer
than 1e-3 of entries where round() meets a .5 tie.
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
from repro.runtime.scheduler import MicrobatchScheduler as JScheduler
from repro.runtime.scheduler import ServeRequest as JRequest
from repro_torch import bridge
from repro_torch.configs import get_lisa_config
from repro_torch.core import lut as tlut
from repro_torch.core import packets as tpk
from repro_torch.core import vlm as tv
from repro_torch.core.intent import Intent as TIntent
from repro_torch.core.streams import DualStreamExecutor as TExecutor
from repro_torch.runtime.scheduler import MicrobatchScheduler as TScheduler
from repro_torch.runtime.scheduler import ServeRequest as TRequest

torch.set_num_threads(1)

TP = get_lisa_config("lisa-mini")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def executors():
    params, bns, lut = random_init_system(JP, seed=0)
    jex = JExecutor(pcfg=JP, params=params, bottlenecks=bns, lut=lut,
                    flash_decode=True)
    tex = TExecutor(pcfg=TP, params=jax.tree.map(np.asarray, params),
                    bottlenecks=jax.tree.map(np.asarray, bns),
                    lut=tlut.paper_lut(), flash_decode=True, device="cpu")
    return jex, tex


def _frames(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        kind = "any" if i % 3 == 0 else "segment"
        out.append((kind, floodseg.make_batch(rng, 1, kind, augment=False)))
    return out


@pytest.fixture(scope="module")
def requests(executors):
    """Six requests edge-encoded by the reference: Context every third
    frame, Insight frames alternating over two tiers."""
    jex, _ = executors
    reqs = []
    for i, (kind, b) in enumerate(_frames(6, seed=11)):
        img = jnp.asarray(b["images"])
        if kind == "any":
            pkt, _ = jex.edge_context(img, i, 0.0)
            intent = JIntent.CONTEXT
        else:
            pkt = jex.edge_insight(img, jex.lut.tiers[i % 2], i, 0.0)
            intent = JIntent.INSIGHT
        reqs.append(JRequest(seq_id=i, intent=intent, packet=pkt,
                             query=b["query"]))
    return reqs


def _port_request(r):
    p = r.packet
    content = {k: np.asarray(v) for k, v in p.content.items()}
    pkt = tpk.Packet(kind=p.kind, tier_name=p.tier_name, seq_id=p.seq_id,
                     created_at=p.created_at, payload_bytes=p.payload_bytes,
                     content=content)
    return TRequest(seq_id=r.seq_id, intent=TIntent(r.intent.value),
                    packet=pkt, query=np.asarray(r.query))


@pytest.mark.parametrize("generate", [True, False])
def test_scheduler_slice_matches_reference(executors, requests, generate):
    jex, tex = executors
    jres = JScheduler(executor=jex, max_batch=4,
                      generate=generate).serve_all(requests)
    tsched = TScheduler(executor=tex, max_batch=4, generate=generate)
    tres = tsched.serve_all([_port_request(r) for r in requests])
    assert [r.seq_id for r in tres] == [r.seq_id for r in jres]
    assert [r.batch_size for r in tres] == [r.batch_size for r in jres]
    assert len({r.packet.tier_name for r in requests
                if r.intent is JIntent.INSIGHT}) == 2
    for j, t in zip(jres, tres):
        assert t.intent.value == j.intent.value
        assert t.tier_name == j.tier_name
        np.testing.assert_allclose(np.asarray(j.answer_logits),
                                   t.answer_logits, **TOL)
        if generate:
            np.testing.assert_array_equal(np.asarray(j.tokens), t.tokens)
        else:
            assert t.tokens is None and j.tokens is None
        if j.mask_logits is None:
            assert t.mask_logits is None
        else:
            np.testing.assert_allclose(np.asarray(j.mask_logits),
                                       t.mask_logits, **TOL)


def test_edge_stages_match_reference(executors):
    jex, tex = executors
    for i, (kind, b) in enumerate(_frames(3, seed=5)):
        img = b["images"]
        jpkt, jctx = jex.edge_context(jnp.asarray(img), i, 0.0)
        tpkt, tctx = tex.edge_context(img, i, 0.0)
        np.testing.assert_allclose(np.asarray(jctx), tctx, **TOL)
        assert tpkt.payload_bytes == jpkt.payload_bytes
        tier_j, tier_t = jex.lut.tiers[i % 3], tex.lut.tiers[i % 3]
        jins = jex.edge_insight(jnp.asarray(img), tier_j, i, 0.0)
        tins = tex.edge_insight(img, tier_t, i, 0.0)
        assert tins.payload_bytes == jins.payload_bytes
        assert tins.tier_name == jins.tier_name
        np.testing.assert_allclose(np.asarray(jins.content["scales"]),
                                   tins.content["scales"], rtol=1e-5,
                                   atol=1e-7)
        diff = np.abs(np.asarray(jins.content["codes"], np.int32)
                      - tins.content["codes"].astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        np.testing.assert_allclose(np.asarray(jins.content["clip"]),
                                   tins.content["clip"], **TOL)


def test_generate_matches_reference_for_one_token(executors):
    """max_new_tokens=1: no decode loop, seg read by one decode step."""
    from repro.core import vlm as jv
    jex, tex = executors
    rng = np.random.RandomState(3)
    ctx = rng.randn(2, JP.clip_tokens, JP.llm.d_model).astype(np.float32)
    query = rng.randint(0, JP.llm.vocab_size, (2, 8)).astype(np.int32)
    jt, jl, js = jv.llm_generate(jex.params, jex._gen_pcfg, ctx, query, 1)
    tt, tl, ts = tv.llm_generate(tex.params, tex._gen_pcfg,
                                 torch.from_numpy(ctx),
                                 torch.from_numpy(query), 1)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), **TOL)


def test_bucketing_matches_reference(executors):
    jex, tex = executors
    for n in (1, 2, 3, 5, 8, 9, 16, 17, 40):
        assert tex.bucket_for(n) == jex.bucket_for(n)
    _, tex = executors
    with pytest.raises(ValueError, match="mixed tiers"):
        tex._same_tier([tpk.Packet("insight", "a", 0, 0.0, 0),
                        tpk.Packet("insight", "b", 1, 0.0, 0)])


def test_entry_points_default_to_cuda_and_raise_without_it():
    """The port never carries on on the CPU unless asked: device=None means
    cuda, and cuda without a card raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    with pytest.raises(RuntimeError, match="CUDA"):
        TExecutor(pcfg=TP, params={}, bottlenecks={}, lut=tlut.paper_lut())
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.to_torch({"a": np.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        tv.init_lisa(TP, torch.Generator())
