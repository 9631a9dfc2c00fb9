"""The port's ``ReplicaRouter`` on the CPU: the counterparts of
``tests/test_router.py`` (dispatch and merged stats, frozen static
weights, replica loss without loss of a request, parking while every
replica is down, the adaptive weights beating every static split), then
``bench_slo``'s replica lane against the JAX package's.

The lane's runs on the port are ``chip_smoke.run_router``, the function
the card runs; the JAX lane is ``bench_slo._run_router_policy`` itself,
once per module.  Under a virtual clock the two must agree tick for tick:
every merged tick's stats, goodput tokens by tier, reject counts,
preemptions, sensor faults and the weight controllers' audit Decisions.
"""

import os
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from benchmarks import bench_slo as B
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import zoo as jzoo
from repro.serve import ReplicaRouter as JReplicaRouter
from repro_torch.configs import get_config, reduced
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import (Request, ReplicaRouter, ServeEngine,
                               ServeOptions, SLOSpec, TICK_STATS_KEYS,
                               VirtualClock)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as C  # noqa: E402
from test_torch_slo_serving import _stats, assert_decisions_match  # noqa: E402

HORIZON = B.SMOKE_HORIZON_S


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced(jax_get_config("yi-6b"))
    jp, _ = jzoo.init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, reduced(get_config("yi-6b")), tp


@pytest.fixture
def setup(models):
    return models[2], models[3]


def _engine(cfg, params, vc, slo=None):
    return ServeEngine(cfg, params, device="cpu", options=ServeOptions(
        max_batch=2, cache_len=64, enable_smartconf=False,
        prefill_mode="packed", slo=slo), clock=vc)


def _reqs(cfg, n, seed=3, plen=12, max_new=4):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(1, cfg.vocab_size, plen).astype(np.int32),
                    max_new) for i in range(n)]


def _drive(rt, vc, want, max_ticks=300):
    t = 0
    while len(rt.finished) < want and t < max_ticks:
        st = rt.tick()
        rt.charge_tick_cost(0.01, decoded=bool(st["decode_tokens"]))
        vc.advance(0.01)
        t += 1
    return t


# ------------------------------------------ counterparts of test_router

def test_router_dispatch_and_merged_stats(setup):
    cfg, params = setup
    vc = VirtualClock()
    slo = SLOSpec(ttft_s=0.8)
    rt = ReplicaRouter([_engine(cfg, params, vc, slo) for _ in range(2)],
                       clock=vc, slo=slo, adaptive=True)
    reqs = _reqs(cfg, 6)
    for r in reqs:
        rt.note_arrival(r)
        assert rt.submit(r)
    assert all(len(e.queued) + len(e.waiting) > 0 for e in rt.engines)
    st = rt.tick()
    assert tuple(st) == TICK_STATS_KEYS
    _drive(rt, vc, len(reqs))
    assert len(rt.finished) == len(reqs)
    assert {r.req_id for r in rt.finished} == {r.req_id for r in reqs}
    rt.close()
    rt.close()


def test_router_weights_frozen_when_static(setup):
    cfg, params = setup
    vc = VirtualClock()
    rt = ReplicaRouter([_engine(cfg, params, vc) for _ in range(2)],
                       clock=vc, adaptive=False, weights=(3.0, 1.0))
    reqs = _reqs(cfg, 4, seed=5)
    for r in reqs:
        rt.note_arrival(r)
        assert rt.submit(r)
    _drive(rt, vc, len(reqs))
    assert rt.weights == [3.0, 1.0]
    assert rt.sensor_faults == 0
    rt.close()


def test_router_preemption_reroutes_without_loss(setup):
    cfg, params = setup
    vc = VirtualClock()
    rt = ReplicaRouter([_engine(cfg, params, vc) for _ in range(2)],
                       clock=vc, adaptive=False)
    reqs = _reqs(cfg, 6, seed=7)
    for r in reqs:
        rt.note_arrival(r)
        assert rt.submit(r)
    for _ in range(2):
        rt.tick(); vc.advance(0.01)
    rt.engines[0].preemption.trigger()
    for _ in range(3):
        rt.tick(); vc.advance(0.01)
    assert 0 in rt._down
    assert not rt.engines[0].queued and not rt.engines[0].waiting
    assert rt.engines[0].accountant.breakdown().get("queue", 0) == 0
    assert rt.reroutes > 0
    rt.engines[0].preemption.reset()
    _drive(rt, vc, len(reqs))
    assert len(rt.finished) == len(reqs)
    assert {r.req_id for r in rt.finished} == {r.req_id for r in reqs}
    rt.close()


def test_router_parks_when_every_replica_down(setup):
    cfg, params = setup
    vc = VirtualClock()
    rt = ReplicaRouter([_engine(cfg, params, vc) for _ in range(2)],
                       clock=vc, adaptive=False)
    for eng in rt.engines:
        eng.preemption.trigger()
    rt.tick()
    req = _reqs(cfg, 1, seed=9)[0]
    rt.note_arrival(req)
    assert rt.submit(req)
    assert req in rt.waiting
    rt.tick()
    assert len(rt.finished) == 0
    for eng in rt.engines:
        eng.preemption.reset()
    _drive(rt, vc, 1)
    assert len(rt.finished) == 1
    rt.close()


# ------------------------------------------------ bench_slo's replica lane

@pytest.fixture(scope="module")
def jax_lane(models, tmp_path_factory):
    """The reference's adaptive replica run, every merged tick recorded."""
    jcfg, jp, _, _ = models
    ticks = []
    tick = JReplicaRouter.tick

    def recorded(self):
        st = tick(self)
        ticks.append(_stats(st))
        return st

    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setattr(JReplicaRouter, "tick", recorded)
        r = B._run_router_policy(
            jcfg, jp, B._router_trace(HORIZON), HORIZON, adaptive=True,
            telemetry_dir=str(tmp_path_factory.mktemp("jax")))
    r["per_tick"] = ticks
    return r


@pytest.fixture(scope="module")
def port_lane(models, tmp_path_factory):
    """The port's replica lane: adaptive weights (with telemetry) and the
    three static splits."""
    _, _, cfg, tp = models
    trace = C.router_trace(HORIZON)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = {"adaptive": C.run_router(
            cfg, tp, "cpu", trace, adaptive=True,
            telemetry_dir=str(tmp_path_factory.mktemp("port")))}
        for name, w in C.ROUTER_SPLITS.items():
            res[f"static_{name}"] = C.run_router(cfg, tp, "cpu", trace,
                                                 adaptive=False, weights=w)
    return res


def test_adaptive_router_matches_jax_tick_for_tick(jax_lane, port_lane):
    ad = port_lane["adaptive"]
    assert len(ad["per_tick"]) == ad["ticks"] == jax_lane["ticks"]
    for i, (got, want) in enumerate(zip(ad["per_tick"],
                                        jax_lane["per_tick"])):
        assert _stats(got) == want, f"tick {i}"
    for key in ("goodput_tokens_by_tier", "finished_tokens_by_tier",
                "reject_counts", "preemptions", "recompute_tokens",
                "sensor_faults", "chaos_events", "reroutes",
                "stalled_ticks", "slo_good_tokens", "slo_miss_tokens",
                "finished", "elapsed_s", "goodput_tps"):
        assert ad[key] == jax_lane[key], key
    assert [round(w, 2) for w in ad["final_weights"]] == \
        jax_lane["final_weights"]


def test_adaptive_router_decisions_match_jax(jax_lane, port_lane):
    assert_decisions_match(port_lane["adaptive"]["telemetry_paths"]["audit"],
                           jax_lane["telemetry_paths"]["audit"])


def test_router_adaptive_beats_every_static_split(port_lane):
    """``test_router.py``'s acceptance gate on the port: the adaptive
    weights strictly beat every static split on goodput under the SLO,
    with the Decisions (the NaN window's fallback among them) in the
    written audit trail."""
    for name, r in port_lane.items():
        assert r["unhandled"] == [], f"{name}: {r['unhandled']}"
        assert r["chaos_events"] > 0, name
        assert r["stalled_ticks"] > 0, name
    ad = port_lane["adaptive"]
    for name in C.ROUTER_SPLITS:
        r = port_lane[f"static_{name}"]
        assert ad["goodput_tps"] > r["goodput_tps"], name
    assert ad["sensor_faults"] > 0
    assert C.lane_faults(port_lane, "router") == []
    assert C.router_audit_faults(ad) == []
