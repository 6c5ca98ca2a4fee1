"""The mission runtime and the serving launcher: the port's
``data/{floodseg,requests}.py``, ``runtime/{mission,fleet}.py``,
``core/profile.py`` and ``launch/serve.py`` against the reference's.

Held exactly: the procedural data (bytes of every array, for three seeds),
every ``FrameResult`` field of the fast-mode missions (AVERY, static High
Accuracy, static Balanced; both mission goals), the fleet logs and the
shared engine's ``stats()`` at 1, 4 and 8 UAVs, and the executor-mode
missions' tiers and delivery times on bridged lisa_mini weights, whose IoUs
are held within 0.01 (the port's mask logits are within rtol 1e-4 of the
reference's, tests/test_torch_serving.py, and a pixel at the 0 threshold
may flip). ``serve_local(smoke=True, device="cpu")`` prints the reference's
lines in both batchings on the same bridged weights; only the count of
compiled cloud stages differs (the reference's jit cache; the eager port
compiles none and prints 0). ``MissionSpec``'s pre-engine forms (``mode``,
``static_tier``, ``fallback``, and a ``policy`` that wins over them) run
both packages' missions to equal frames, and ``ModelConfig.param_count``
/ ``active_param_count`` equal the reference's on the ten full-size
configs.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.lisa_mini import CONFIG as JP
from repro.core import profile as jprof
from repro.core.controller import MissionGoal as JGoal
from repro.core.lut import paper_lut as jpaper_lut
from repro.data import floodseg as jflood
from repro.data import requests as jreq
from repro.engine import policy as jpolicy
from repro.launch import serve as jserve
from repro.network import traces as jtraces
from repro.runtime import fleet as jfleet
from repro.runtime import mission as jmission
from repro_torch import configs as tconfigs
from repro_torch.configs import get_lisa_config
from repro_torch.core import lut as tlut
from repro_torch.core import profile as tprof
from repro_torch.core.controller import MissionGoal as TGoal
from repro_torch.data import floodseg as tflood
from repro_torch.data import requests as treq
from repro_torch.engine import policy as tpolicy
from repro_torch.launch import serve as tserve
from repro_torch.models import stack as tstack
from repro_torch.network import traces as ttraces
from repro_torch.runtime import fleet as tfleet
from repro_torch.runtime import mission as tmission

from test_torch_engine import system  # noqa: F401

torch.set_num_threads(1)

TP = get_lisa_config("lisa-mini")
SEEDS = (0, 1, 7)


def _same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("seed", SEEDS)
def test_floodseg_and_requests_byte_equal(seed):
    for kind, augment, cls in (("segment", True, None),
                               ("segment", False, "person"),
                               ("any", False, None),
                               ("count", True, "vehicle")):
        j = jflood.make_batch(np.random.RandomState(seed), 3, kind,
                              augment=augment, cls=cls)
        t = tflood.make_batch(np.random.RandomState(seed), 3, kind,
                              augment=augment, cls=cls)
        _same_arrays(t, j)
    for (jtr, jva), (ttr, tva) in [(jflood.train_val_streams(seed, 2),
                                    tflood.train_val_streams(seed, 2))]:
        _same_arrays(next(ttr), next(jtr))
        _same_arrays(next(tva), next(jva))
    assert list(treq.mission_requests(seed, 60.0)) == [
        treq.OperatorRequest(**dataclasses.asdict(r))
        for r in jreq.mission_requests(seed, 60.0)]


def _frames(log):
    return [dataclasses.asdict(f) for f in log.frames]


# AVERY, static High Accuracy, static Balanced: (policy class, arguments),
# built on each side from its own package
MODES = [("AdaptivePolicy", ()), ("StaticTierPolicy", ("High Accuracy",)),
         ("StaticTierPolicy", ("Balanced",))]


def _policy(module, mode):
    name, args = mode
    return getattr(module, name)(*args)


@pytest.mark.parametrize("goal", ["PRIORITIZE_ACCURACY",
                                  "PRIORITIZE_THROUGHPUT"])
def test_fast_missions_equal(goal):
    jlut, tlut_ = jpaper_lut(), tlut.paper_lut()
    for seed, mode in zip((0, 3, 5), MODES):
        j = jmission.run_mission(jlut, jtraces.paper_trace(seed),
                                 jmission.MissionSpec(
                                     duration_s=600.0, seed=seed,
                                     goal=getattr(JGoal, goal),
                                     policy=_policy(jpolicy, mode)))
        t = tmission.run_mission(tlut_, ttraces.paper_trace(seed),
                                 tmission.MissionSpec(
                                     duration_s=600.0, seed=seed,
                                     goal=getattr(TGoal, goal),
                                     policy=_policy(tpolicy, mode)))
        assert _frames(t) == _frames(j) and t.frames
        assert (t.infeasible_s, t.mean_pps, t.mean_iou,
                t.total_edge_energy_j) == \
            (j.infeasible_s, j.mean_pps, j.mean_iou, j.total_edge_energy_j)
        assert t.tier_timeline() == j.tier_timeline()
        np.testing.assert_array_equal(t.pps_timeline(), j.pps_timeline())


# the reference's MissionSpec forms (tests/test_mission.py): the
# pre-engine mode / static_tier / fallback knobs, and a policy that wins
# over them; (keyword arguments, policy class and arguments or None)
SPEC_FORMS = [
    (dict(mode="avery"), None),
    (dict(mode="static", static_tier="High Accuracy"), None),
    (dict(mode="static", static_tier="Balanced"), None),
    (dict(mode="static", static_tier="High Throughput"), None),
    (dict(mode="avery", fallback=True), None),
    (dict(mode="static", static_tier="Balanced"),
     ("StaticTierPolicy", ("High Throughput",))),
]


@pytest.mark.parametrize("form", range(len(SPEC_FORMS)))
def test_mission_spec_forms_equal(form):
    """Each form through both packages' ``run_mission``: the resolved
    policy of the same class and every frame, IoU and timeline equal."""
    kw, policy = SPEC_FORMS[form]
    logs = []
    for mission, lut, traces, pol in (
            (jmission, jpaper_lut, jtraces, jpolicy),
            (tmission, tlut.paper_lut, ttraces, tpolicy)):
        spec = mission.MissionSpec(
            duration_s=300.0, seed=form, **kw,
            **({} if policy is None else {"policy": _policy(pol, policy)}))
        logs.append((type(spec.resolve_policy()).__name__,
                     mission.run_mission(lut(), traces.paper_trace(4), spec)))
    (jname, j), (tname, t) = logs
    assert tname == jname
    assert _frames(t) == _frames(j) and t.frames
    assert (t.infeasible_s, t.mean_pps, t.mean_iou) == \
        (j.infeasible_s, j.mean_pps, j.mean_iou)
    assert t.tier_timeline() == j.tier_timeline()


def test_mission_spec_refusals_equal():
    """``mode="static"`` without a tier and an unknown mode raise in both."""
    for kw in (dict(mode="static"), dict(mode="greedy")):
        for mission in (jmission, tmission):
            with pytest.raises(ValueError):
                mission.MissionSpec(**kw).resolve_policy()


@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_param_count_equals_reference(name):
    """``ModelConfig.param_count`` / ``active_param_count`` on the full-size
    configs: the analytic count (the meta device, no weights) against the
    reference's."""
    cfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
    assert (cfg.param_count(), cfg.active_param_count()) == \
        (jcfg.param_count(), jcfg.active_param_count())


def test_executor_mode_missions_on_bridged_weights(system):
    """The fidelity oracle through ``cloud_insight`` on each executor:
    AVERY against static High Accuracy."""
    for mode in MODES[:2]:
        logs = []
        for mission, ex, traces, policy in (
                (jmission, system["jex"], jtraces, jpolicy),
                (tmission, system["tex"], ttraces, tpolicy)):
            logs.append(mission.run_mission(
                ex.lut, traces.paper_trace(2),
                mission.MissionSpec(duration_s=90.0,
                                    policy=_policy(policy, mode)),
                executor=ex))
        j, t = logs
        assert [(f.tier, f.t_capture, f.t_delivered, f.payload_mb,
                 f.edge_energy_j) for f in t.frames] == \
            [(f.tier, f.t_capture, f.t_delivered, f.payload_mb,
              f.edge_energy_j) for f in j.frames]
        assert t.frames and t.infeasible_s == j.infeasible_s
        np.testing.assert_allclose([f.iou for f in t.frames],
                                   [f.iou for f in j.frames], atol=0.01)


@pytest.mark.parametrize("n_uavs", [1, 4, 8])
def test_fleets_equal(n_uavs):
    jlut = jpaper_lut()
    j = jfleet.run_fleet(jlut, jtraces.paper_trace(1), n_uavs,
                         jmission.MissionSpec(duration_s=300.0))
    t = tfleet.run_fleet(tlut.paper_lut(), ttraces.paper_trace(1), n_uavs,
                         tmission.MissionSpec(duration_s=300.0))
    assert t.n_uavs == j.n_uavs == n_uavs
    assert [_frames(x) for x in t.logs] == [_frames(x) for x in j.logs]
    assert [x.infeasible_s for x in t.logs] == \
        [x.infeasible_s for x in j.logs]
    assert t.stats == j.stats and t.stats["submitted"] > 0
    assert (t.aggregate_pps, t.mean_iou, t.infeasible_frac) == \
        (j.aggregate_pps, j.mean_iou, j.infeasible_frac)


def _lines(text):
    return [re.sub(r"\d+ compiled cloud stages", "N compiled cloud stages",
                   ln) for ln in text.splitlines()]


@pytest.mark.parametrize("batching", ["microbatch", "inflight"])
def test_serve_smoke_prints_the_reference_lines(batching, capsys,
                                                monkeypatch):
    seed, duration = 1, 8.0
    jserve.serve_local(duration, seed, 4, smoke=True, batching=batching)
    want = capsys.readouterr().out
    params, bns, _ = jprof.random_init_system(JP, seed=seed)
    bridged = (jax.tree.map(np.asarray, params),
               jax.tree.map(np.asarray, bns), tlut.paper_lut())
    calls = []

    def random_init_system(pcfg, seed=0, lut=None, params=None,
                           device=None):
        calls.append((pcfg, seed, device))
        return bridged
    monkeypatch.setattr(tprof, "random_init_system", random_init_system)
    tserve.serve_local(duration, seed, 4, smoke=True, batching=batching,
                       device="cpu")
    got = capsys.readouterr().out
    assert calls == [(TP, seed, "cpu")]
    assert " 0 compiled cloud stages" in got
    assert _lines(got) == _lines(want) and len(_lines(got)) >= 4


def test_unported_modes_name_their_roadmap_item(monkeypatch, capsys):
    """The modes that raised naming their ROADMAP.md item now run. The
    pod-disaggregated dry-run (item 5b-i) prints the reference's boundary
    payload line, its arithmetic to the digit; the offline phase's entry
    points (item 6b) run: ``build_lut`` on no pairs gives the context row
    alone, ``train_full_system`` trains detached weights, and
    ``serve_local`` without ``smoke`` serves what it trained (here a
    one-step stand-in)."""
    from repro.configs.lisa7b import CONFIG as JDEPLOY
    from repro.core.bottleneck import rank_for_ratio
    tserve.main(["--dryrun"])
    d = JDEPLOY.sam.d_model
    raw_bytes = 32 * JDEPLOY.sam_tokens * d * 2
    comp_bytes = 32 * JDEPLOY.sam_tokens * (rank_for_ratio(d, 0.25, 2) + 4)
    assert (f"[serve-dryrun] boundary payload: uncompressed="
            f"{raw_bytes/1e6:.2f}MB vs bottlenecked={comp_bytes/1e6:.2f}MB "
            f"({raw_bytes/comp_bytes:.1f}x reduction on the pod link)"
            ) in capsys.readouterr().out.splitlines()
    lut = tprof.build_lut(TP, {}, {}, {}, device="cpu")
    assert lut.tiers == [] and lut.context.payload_mb == \
        jprof.deployment_context_mb(JDEPLOY)
    params, params_ft, bns = tprof.train_full_system(
        TP, ratios=(0.05,), steps=1, bn_steps=1, ft_steps=1, batch_size=2,
        log=lambda s: None, device="cpu")
    assert sorted(bns) == [0.05] and sorted(bns[0.05]) == ["dec", "enc"]
    for tree in (params, params_ft, bns):
        assert not any(t.requires_grad for t in tstack.leaves(tree))
    system = tprof.train_full_system
    monkeypatch.setattr(tprof, "train_full_system", lambda pcfg, **kw: system(
        pcfg, **{**kw, "steps": 1, "bn_steps": 1, "ft_steps": 1,
                 "batch_size": 2}))
    tserve.serve_local(5.0, 0, smoke=False, device="cpu")
    assert "[serve] served " in capsys.readouterr().out
    if not torch.cuda.is_available():
        # the launcher's default device is the card; without one it raises
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.serve_local(5.0, 0, smoke=True)


def test_profile_host_math_and_random_system():
    from repro.configs.lisa7b import CONFIG as JDEPLOY
    from repro_torch.configs.lisa7b import CONFIG as TDEPLOY
    assert tprof.TIER_NAMES == jprof.TIER_NAMES
    for ratio in (0.25, 0.10, 0.05):
        assert tprof.deployment_payload_mb(TDEPLOY, ratio) == \
            jprof.deployment_payload_mb(JDEPLOY, ratio)
    assert tprof.deployment_context_mb(TDEPLOY) == \
        jprof.deployment_context_mb(JDEPLOY)
    jparams, jbns, _ = jprof.random_init_system(JP, seed=0)
    tparams, tbns, tl = tprof.random_init_system(TP, seed=0, device="cpu")
    for jt, tt in ((jparams, tparams), (jbns, tbns)):
        jl, tleaves = jax.tree.leaves(jt), jax.tree.leaves(tt)
        assert [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
                for x in tleaves] == \
            [(tuple(x.shape), str(x.dtype)) for x in jl]
        assert all(x.device.type == "cpu" for x in tleaves)
    assert [t.name for t in tl.tiers] == list(tbns) == list(jbns)
