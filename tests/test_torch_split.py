"""The slice end to end: LISA's cloud path with ``llm.use_flash=True`` (every
prefill through the flash-attention kernel) and its Insight split point
with ``use_kernel=True`` (the fused bottleneck kernels), in the reference
(Pallas kernels in interpret mode) and in the port on ``device="cpu"``
(each kernel wrapper takes its plain version), on bridged lisa_mini
weights.

Both cloud sides get the reference's packets, so they see identical codes;
the edge encode is compared on its own. The reference runs its decode
attention plain (``flash_decode=False``), which keeps tier-1 time down;
the port runs ``flash_decode=True`` on CPU tensors.

Tolerances: greedy tokens exactly equal; logits and masks rtol/atol 1e-4
(fp32 summation order through the layers); codes within 1 on fewer than
1e-3 of entries where round() meets a .5 tie, scales rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lisa_mini import CONFIG as JP
from repro.core import DualStreamExecutor as JExecutor
from repro.core import bottleneck as jbn
from repro.core import vlm as jv
from repro.core.intent import Intent as JIntent
from repro.core.profile import random_init_system
from repro.engine import InflightDecoder as JDecoder
from repro.runtime.scheduler import MicrobatchScheduler as JScheduler
from repro.runtime.scheduler import ServeRequest as JRequest
from repro_torch.configs import get_lisa_config
from repro_torch.core import bottleneck as tbn
from repro_torch.core import lut as tlut
from repro_torch.core import packets as tpk
from repro_torch.core import vlm as tv
from repro_torch.core.intent import Intent as TIntent
from repro_torch.core.streams import DualStreamExecutor as TExecutor
from repro_torch.engine import InflightDecoder as TDecoder
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.runtime.scheduler import MicrobatchScheduler as TScheduler
from repro_torch.runtime.scheduler import ServeRequest as TRequest

torch.set_num_threads(1)

T = 3                                       # max_new_tokens
TOL = dict(rtol=1e-4, atol=1e-4)


def _use_flash(pcfg):
    return dataclasses.replace(pcfg, llm=pcfg.llm.replace(use_flash=True))


JPF, TPF = _use_flash(JP), _use_flash(get_lisa_config("lisa-mini"))


@pytest.fixture(scope="module")
def executors():
    params, bns, lut = random_init_system(JP, seed=0)
    jex = JExecutor(pcfg=JPF, params=params, bottlenecks=bns, lut=lut,
                    max_new_tokens=T, flash_decode=False)
    tex = TExecutor(pcfg=TPF, params=jax.tree.map(np.asarray, params),
                    bottlenecks=jax.tree.map(np.asarray, bns),
                    lut=tlut.paper_lut(), max_new_tokens=T,
                    flash_decode=True, device="cpu")
    return jex, tex


def _port_packet(p):
    return tpk.Packet(kind=p.kind, tier_name=p.tier_name, seq_id=p.seq_id,
                      created_at=p.created_at, payload_bytes=p.payload_bytes,
                      content={k: np.array(v) for k, v in p.content.items()})


@pytest.fixture(scope="module")
def requests(executors):
    """Six requests edge-encoded by the reference: Context every third
    frame, Insight frames alternating over two tiers, one frame sent
    twice (a prefix hit in the in-flight decoder)."""
    jex, _ = executors
    rng = np.random.RandomState(21)
    imgs = [rng.rand(1, JP.image_size, JP.image_size, 3).astype(np.float32)
            for _ in range(5)]
    reqs = []
    for i, f in enumerate((0, 1, 2, 0, 3, 4)):
        query = rng.randint(0, JP.llm.vocab_size, (1, 8)).astype(np.int32)
        if f % 3 == 0:
            pkt, _ = jex.edge_context(jnp.asarray(imgs[f]), i, 0.0)
            intent = JIntent.CONTEXT
        else:
            pkt = jex.edge_insight(jnp.asarray(imgs[f]), jex.lut.tiers[f % 2],
                                   i, 0.0)
            intent = JIntent.INSIGHT
        if i == 3:                      # frame 0 again, with its own query
            query = reqs[0].query
        reqs.append(JRequest(seq_id=i, intent=intent, packet=pkt,
                             query=query))
    return reqs


@pytest.fixture
def flash_calls(monkeypatch):
    """Count the port's flash wrapper calls (each takes the plain version
    on these CPU tensors)."""
    calls = []
    launch = fops.flash_attention

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return launch(*args, **kwargs)

    monkeypatch.setattr(fops, "flash_attention", counted)
    return calls


def test_microbatch_generate_with_use_flash_matches_reference(
        executors, requests, flash_calls):
    jex, tex = executors
    jres = JScheduler(executor=jex, max_batch=4,
                      generate=True).serve_all(requests)
    tsched = TScheduler(executor=tex, max_batch=4, generate=True)
    tres = tsched.serve_all([TRequest(
        seq_id=r.seq_id, intent=TIntent(r.intent.value),
        packet=_port_packet(r.packet), query=np.asarray(r.query))
        for r in requests])
    # one flash call per layer and microbatch: each prefill's trunk
    assert len(flash_calls) == tsched.n_microbatches * JP.llm.num_layers
    assert [r.batch_size for r in tres] == [r.batch_size for r in jres]
    for j, t in zip(jres, tres):
        assert t.seq_id == j.seq_id
        np.testing.assert_array_equal(np.asarray(j.tokens), t.tokens)
        np.testing.assert_allclose(np.asarray(j.answer_logits),
                                   t.answer_logits, **TOL)
        if j.mask_logits is None:
            assert t.mask_logits is None
        else:
            np.testing.assert_allclose(np.asarray(j.mask_logits),
                                       t.mask_logits, **TOL)


def _serve_inflight(port, executor, requests):
    """Two waves on three slots, one decode step between them, then
    drain. Returns (decoder, results by seq_id)."""
    cls, intent = (TDecoder, TIntent) if port else (JDecoder, JIntent)
    dec = cls(executor, slots=3)
    done = {}
    for wave in (requests[:4], requests[4:]):
        for r in wave:
            pkt = _port_packet(r.packet) if port else r.packet
            dec.submit(r.seq_id, intent(r.intent.value), pkt,
                       np.asarray(r.query),
                       lambda out: done.__setitem__(out["seq_id"], out),
                       operator_id="uav-A")
        dec.pump(1)
    dec.drain()
    assert len(done) == len(requests)
    return dec, done


def test_inflight_with_use_flash_matches_reference(executors, requests,
                                                   flash_calls):
    jex, tex = executors
    jdec, jdone = _serve_inflight(False, jex, requests)
    tdec, tdone = _serve_inflight(True, tex, requests)
    assert tdec.n_steps == jdec.n_steps
    hits = [tdone[s]["prefix_hit"] for s in sorted(tdone)]
    assert hits == [jdone[s]["prefix_hit"] for s in sorted(jdone)]
    assert sum(hits) == 1
    # one flash call per layer and prefix miss (cloud_prefix)
    assert len(flash_calls) == (len(requests) - 1) * JP.llm.num_layers
    for s, j in jdone.items():
        t = tdone[s]
        assert "failure" not in t
        assert t["joined_step"] == j["joined_step"]
        np.testing.assert_array_equal(t["tokens"], np.asarray(j["tokens"]))
        np.testing.assert_allclose(t["answer_logits"],
                                   np.asarray(j["answer_logits"]), **TOL)
        if j["mask_logits"] is None:
            assert t["mask_logits"] is None
        else:
            np.testing.assert_allclose(t["mask_logits"],
                                       np.asarray(j["mask_logits"]), **TOL)


@pytest.mark.parametrize("tier", [0, 1, 2])
def test_split_point_with_both_switches_matches_reference(executors, tier):
    """One Insight frame through the reference's edge_insight and
    cloud_insight_gen stage bodies with use_kernel=True and the use_flash
    config: SAM head, encode, decode, SAM tail, llm_generate, mask."""
    jex, tex = executors
    rng = np.random.RandomState(30 + tier)
    img = rng.rand(1, JP.image_size, JP.image_size, 3).astype(np.float32)
    query = rng.randint(0, JP.llm.vocab_size, (1, 8)).astype(np.int32)
    name = jex.lut.tiers[tier].name
    jbp, tbp = jex.bottlenecks[name], tex.bottlenecks[name]
    timg = torch.from_numpy(img)
    # edge: the SAM head and the fused encode, compared on their own
    ja = jv.sam_head(jex.params, JPF, jnp.asarray(img))
    jcodes, jscales = jbn.encode(jbp, ja, use_kernel=True)
    with torch.inference_mode():
        tcodes, tscales = tbn.encode(tbp, tv.sam_head(tex.params, TPF, timg),
                                     use_kernel=True)
    np.testing.assert_allclose(np.asarray(jscales), tscales.numpy(),
                               rtol=1e-5, atol=1e-7)
    diff = np.abs(np.asarray(jcodes, np.int32) - tcodes.numpy().astype(
        np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    # cloud: both sides decode the reference's codes
    codes, scales = np.array(jcodes), np.array(jscales)
    ctx = np.array(jv.clip_encode(jex.params, JPF, jnp.asarray(img)))
    ja = jbn.decode(jbp, codes, scales, out_dtype=JP.sam.adtype,
                    use_kernel=True)
    jfeats = jv.sam_tail(jex.params, JPF, ja)
    jtok, jlog, jseg = jv.llm_generate(jex.params, jex._gen_pcfg, ctx, query,
                                       T)
    jmask = jv.mask_decode(jex.params, JPF, jfeats, jseg)
    with torch.inference_mode():
        ta = tbn.decode(tbp, torch.from_numpy(codes),
                        torch.from_numpy(scales), out_dtype=TPF.sam.adtype,
                        use_kernel=True)
        tfeats = tv.sam_tail(tex.params, TPF, ta)
        ttok, tlog, tseg = tv.llm_generate(tex.params, tex._gen_pcfg,
                                           torch.from_numpy(ctx),
                                           torch.from_numpy(query), T)
        tmask = tv.mask_decode(tex.params, TPF, tfeats, tseg)
    np.testing.assert_allclose(np.asarray(ja), ta.numpy(), **TOL)
    np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jmask), tmask.numpy(), **TOL)
