"""SLO-constrained serving on the port, on the CPU: the counterparts of
``tests/test_slo_serving.py`` (typed rejections, brownout, deadline
shedding, the worker-preemption drain, the livelock guard, chaos-corrupted
sensors), then ``bench_slo``'s admission lane.

The lane's runs on the port are ``chip_smoke.run_admission``, the function
the card runs; the JAX lane is ``bench_slo._run_policy`` itself, once per
module.  Under a virtual clock no controller reading depends on a token's
value (a request stops only at ``max_new_tokens``), so the two packages
must agree tick for tick: every tick's stats, goodput tokens by tier,
reject counts, preemptions, sensor faults, and every audit Decision.  And
on the port, as in the benchmark, the adaptive brownout must beat every
static tier gate on goodput under the SLO.
"""

import json
import math
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
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.models.bridge import params_from_numpy, tree_leaves
from repro_torch.serve import (ChaosMonkey, ChaosSpec, OpenLoopDriver,
                               Request, RejectReason, ServeEngine, SLOSpec,
                               TickCostModel, TierSpec, TraceConfig,
                               VirtualClock, as_requests, synthesize_trace)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as C  # noqa: E402

HORIZON = B.SMOKE_HORIZON_S


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    """reduced() yi-6b in both packages, the port's weights bridged from
    the JAX package's."""
    jcfg = jax_reduced(jax_get_config("yi-6b"))
    jp, _ = jzoo.init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, reduced(get_config("yi-6b")), tp


@pytest.fixture
def small_model(models):
    return models[2], models[3]


def _weight_bytes(params):
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def _req(rng, cfg, rid, plen=16, new=6, **kw):
    return Request(rid, rng.integers(1, cfg.vocab_size, plen)
                   .astype(np.int32), new, **kw)


def _engine(cfg, params, **kw):
    return ServeEngine(cfg, params, device="cpu", **kw)


# ------------------------------------- counterparts of test_slo_serving

def test_submit_rejects_invalid_requests_typed(small_model, rng):
    cfg, params = small_model
    eng = _engine(cfg, params, max_batch=2, cache_len=64,
                  enable_smartconf=False)
    adm = eng.submit(_req(rng, cfg, 0, plen=0))
    assert not adm and adm.reason is RejectReason.EMPTY_PROMPT
    adm = eng.submit(_req(rng, cfg, 1, plen=80, new=8))
    assert not adm and adm.reason is RejectReason.PROMPT_TOO_LONG
    adm = eng.submit(_req(rng, cfg, 2, plen=16, new=6))
    assert adm and adm.reason is None and adm.footprint_blocks > 0
    assert eng.rejected == 2
    assert eng.reject_counts["empty_prompt"] == 1
    assert eng.reject_counts["prompt_too_long"] == 1
    assert all(r.reject_reason is not None for r in eng.shed)
    for _ in range(30):
        eng.tick()
    assert len(eng.finished) == 1
    eng.close()


def test_submit_rejects_footprint_beyond_any_budget(small_model, rng):
    cfg, params = small_model
    eng = _engine(cfg, params, max_batch=2, cache_len=64, block_tokens=16,
                  enable_smartconf=False)
    eng.set_kv_budget(1)
    big = _req(rng, cfg, 0, plen=40, new=8)
    adm = eng.submit(big)
    assert not adm and adm.reason is RejectReason.KV_FOOTPRINT
    assert adm.footprint_blocks == 3
    assert eng.submit(_req(rng, cfg, 1, plen=8, new=4))
    eng.close()


def test_deadline_expired_requests_are_shed(small_model, rng):
    cfg, params = small_model
    vc = VirtualClock()
    eng = _engine(cfg, params, max_batch=1, cache_len=64,
                  enable_smartconf=False, clock=vc)
    eng.submit(_req(rng, cfg, 0, plen=16, new=8))
    eng.tick()
    eng.submit(_req(rng, cfg, 1, plen=16, new=4, deadline_s=0.5))
    vc.advance(1.0)
    eng.tick()
    assert eng.reject_counts["deadline_expired"] == 1
    shed = [r for r in eng.shed
            if r.reject_reason is RejectReason.DEADLINE_EXPIRED]
    assert [r.req_id for r in shed] == [1]
    for _ in range(30):
        eng.tick()
    assert [r.req_id for r in eng.finished] == [0]
    eng.close()


def test_static_tier_gate_sheds_low_tiers_without_hol_blocking(
        small_model, rng):
    cfg, params = small_model
    eng = _engine(cfg, params, max_batch=2, cache_len=64,
                  enable_smartconf=False, num_tiers=3, admit_tier_max=0)
    eng.submit(_req(rng, cfg, 0, new=4, tier=2))
    eng.submit(_req(rng, cfg, 1, new=4, tier=0))
    for _ in range(20):
        eng.tick()
    assert [r.req_id for r in eng.finished] == [1]
    assert [r.req_id for r in eng.waiting] == [0]
    eng.admit_tier_max = 2
    for _ in range(20):
        eng.tick()
    assert sorted(r.req_id for r in eng.finished) == [0, 1]
    eng.close()


def test_adaptive_brownout_engages_under_overload(small_model):
    cfg, params = small_model
    budget = _weight_bytes(params) + 4_000_000
    vc = VirtualClock()
    eng = _engine(cfg, params, max_batch=4, cache_len=64,
                  hbm_budget_bytes=budget, block_tokens=16,
                  slo=SLOSpec(ttft_s=1.0, window=32), num_tiers=3, clock=vc)
    trace = synthesize_trace(TraceConfig(
        process="bursty", rate_rps=35.0, horizon_s=6.0, seed=11,
        burst_factor=8.0, burst_period_s=3.0, burst_duty=0.4,
        prompt_lo=4, prompt_hi=24, new_lo=2, new_hi=8,
        tiers=(TierSpec(0, 0.3, deadline_s=20.0), TierSpec(1, 0.3),
               TierSpec(2, 0.4))))
    arrivals = as_requests(trace, vocab=cfg.vocab_size, seed=1)
    admit_probe = []
    drv = OpenLoopDriver(
        eng, arrivals, clock=vc,
        cost=TickCostModel(base_s=0.02, prefill_token_s=1e-3,
                           decode_token_s=8e-3),
        chaos=lambda d, t: admit_probe.append(d.engine.admit_tier_max) or 0.0)
    out = drv.run()
    assert out["unhandled"] == []
    assert min(admit_probe) < 2, "brownout never engaged under overload"
    assert max(admit_probe) == 2, "brownout never lifted"
    offered: dict[int, int] = {}
    for _, req in arrivals:
        offered[req.tier] = offered.get(req.tier, 0) + req.max_new_tokens
    good = out["goodput_tokens_by_tier"]
    t0 = good.get(0, 0) / max(1, offered.get(0, 0))
    t2 = good.get(2, 0) / max(1, offered.get(2, 0))
    assert t0 >= t2, "premium tier did not get better SLO attainment"
    assert out["slo_good_tokens"] > 0
    eng.close()


def test_preemption_drains_requeues_and_resumes(small_model, rng):
    cfg, params = small_model
    eng = _engine(cfg, params, max_batch=2, cache_len=64,
                  enable_smartconf=False)
    for i in range(4):
        eng.submit(_req(rng, cfg, i, plen=12, new=6))
    eng.tick(); eng.tick()
    assert eng.running or eng.prefilling
    eng.preemption.trigger()
    stats = eng.tick()
    assert stats["draining"] is True
    assert not eng.running and not eng.prefilling
    assert eng.preemptions >= 1
    assert len(eng.drained_requests()) == 4
    seq = [r.req_id for r in eng.drained_requests()]
    assert seq == sorted(seq)
    adm = eng.submit(_req(rng, cfg, 99))
    assert not adm and adm.reason is RejectReason.DRAINING
    assert not eng.accepting
    eng.tick()
    eng.preemption.reset()
    for _ in range(60):
        eng.tick()
    assert eng.accepting
    assert sorted(r.req_id for r in eng.finished) == [0, 1, 2, 3]
    assert all(len(r.generated) == 6 for r in eng.finished)
    assert eng.recompute_tokens > 0
    eng.close()
    eng.close()


def test_budget_cut_below_footprint_parks_not_livelocks(small_model, rng):
    cfg, params = small_model
    eng = _engine(cfg, params, max_batch=2, cache_len=64, block_tokens=16,
                  enable_smartconf=False)
    big = _req(rng, cfg, 0, plen=40, new=12)
    eng.submit(big)
    for _ in range(3):
        eng.tick()
    assert big.gen_count > 0 or big.prefilled > 0
    eng.set_kv_budget(1)
    for _ in range(20):
        eng.tick()
    assert big.reject_reason is RejectReason.KV_FOOTPRINT
    assert big.preempted == 1
    assert eng.recompute_tokens <= len(big.prompt) + big.max_new_tokens
    stats = eng.tick()
    assert stats["running"] == 0 and eng.queued_tokens == 0
    eng.close()


def test_chaos_nan_sensors_do_not_crash_guarded_controllers(small_model):
    cfg, params = small_model
    budget = _weight_bytes(params) + 4_000_000
    vc = VirtualClock()
    eng = _engine(cfg, params, max_batch=2, cache_len=64,
                  hbm_budget_bytes=budget, block_tokens=16,
                  slo=SLOSpec(ttft_s=1.0, decode_s=0.5, window=32), clock=vc)
    trace = synthesize_trace(TraceConfig(rate_rps=8.0, horizon_s=4.0,
                                         seed=3, prompt_hi=24, new_hi=6))
    monkey = ChaosMonkey(ChaosSpec(
        seed=0, sensor_fault_tick=5, sensor_fault_ticks=12,
        sensor_fault_mode="nan",
        sensor_names=("decode_p99_s", "ttft_p99_s", "hbm_bytes"))
    ).install(eng)
    drv = OpenLoopDriver(
        eng, as_requests(trace, vocab=cfg.vocab_size, seed=2), clock=vc,
        cost=TickCostModel(base_s=0.02, prefill_token_s=1e-3,
                           decode_token_s=8e-3),
        chaos=monkey)
    out = drv.run()
    assert out["unhandled"] == []
    faults = sum(sc.sensor_faults for sc in eng.controllers())
    assert faults > 0, "chaos window never corrupted a controller read"
    assert any("sensor_nan" in name for _, name in monkey.events)
    assert out["finished"] > 0
    eng.close()


def test_chaos_preemption_mid_trace_recovers(small_model):
    cfg, params = small_model
    vc = VirtualClock()
    eng = _engine(cfg, params, max_batch=2, cache_len=64,
                  enable_smartconf=False, clock=vc, slo=SLOSpec(ttft_s=5.0))
    trace = synthesize_trace(TraceConfig(rate_rps=5.0, horizon_s=3.0,
                                         seed=4, prompt_hi=16, new_hi=5))
    monkey = ChaosMonkey(ChaosSpec(preempt_tick=5, preempt_resume_ticks=4)
                         ).install(eng)
    drv = OpenLoopDriver(
        eng, as_requests(trace, vocab=cfg.vocab_size, seed=5), clock=vc,
        cost=TickCostModel(base_s=0.02, prefill_token_s=1e-3,
                           decode_token_s=8e-3),
        chaos=monkey)
    out = drv.run()
    assert out["unhandled"] == []
    assert ("preempt" in [n for _, n in monkey.events]
            and "resume" in [n for _, n in monkey.events])
    assert out["preemptions"] >= 1
    assert out["finished"] + out["rejected"] == out["submitted"]
    assert out["finished"] > 0
    eng.close()


# ---------------------------------------------- bench_slo's admission lane

# per-tick stats compared with the JAX engine's: all but ``hbm`` (the
# weight-dependent key, dropped by ``chip_smoke.drive_lane`` too) and
# ``kv_cache_share``, the unported prefix cache's knob (Queue 1 item 6),
# which the port reports as 0.0 and the reference at its option's 0.5
def _stats(st: dict) -> dict:
    return {k: v for k, v in st.items()
            if k not in ("hbm", "kv_cache_share")}


@pytest.fixture(scope="module")
def jax_lane(models, tmp_path_factory):
    """The reference's adaptive admission run, every tick's stats
    recorded."""
    jcfg, jp, _, _ = models
    ticks = []
    tick = JServeEngine.tick

    def recorded(self):
        st = tick(self)
        ticks.append(_stats(st))
        return st

    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setattr(JServeEngine, "tick", recorded)
        r = B._run_policy(jcfg, jp, B._make_trace(HORIZON), HORIZON,
                          adaptive=True,
                          telemetry_dir=str(tmp_path_factory.mktemp("jax")))
    r["per_tick"] = ticks
    return r


@pytest.fixture(scope="module")
def port_lane(models, tmp_path_factory):
    """The port's admission lane on the CPU: the adaptive policy (with
    telemetry) and the three static tier gates."""
    _, _, cfg, tp = models
    trace = C.admission_trace(HORIZON)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = {"adaptive": C.run_admission(
            cfg, tp, "cpu", trace, adaptive=True,
            telemetry_dir=str(tmp_path_factory.mktemp("port")))}
        for name, tier in C.SLO_STATIC.items():
            res[name] = C.run_admission(cfg, tp, "cpu", trace,
                                        adaptive=False, admit_tier_max=tier)
    return res


def test_adaptive_admission_matches_jax_tick_for_tick(jax_lane, port_lane):
    ad = port_lane["adaptive"]
    assert len(ad["per_tick"]) == ad["ticks"] == jax_lane["ticks"]
    for i, (got, want) in enumerate(zip(ad["per_tick"],
                                        jax_lane["per_tick"])):
        assert _stats(got) == want, f"tick {i}"
    for key in ("goodput_tokens_by_tier", "finished_tokens_by_tier",
                "reject_counts", "preemptions", "recompute_tokens",
                "sensor_faults", "chaos_events", "chaos_schedule",
                "slo_good_tokens", "slo_miss_tokens", "submitted",
                "finished", "elapsed_s", "goodput_tps"):
        assert ad[key] == jax_lane[key], key
    # the run exercised what it claims to
    tiers = {st["admit_tier_max"] for st in ad["per_tick"]}
    assert tiers == {0, 1, 2}
    assert ad["reject_counts"].get("brownout_shed", 0) > 0
    assert ad["reject_counts"].get("draining", 0) > 0


def _same_float(a, b) -> bool:
    if isinstance(a, str) or isinstance(b, str):     # "nan" in strict JSON
        return a == b
    if a is None or b is None:
        return a is b
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=0.0) or a == b


def assert_decisions_match(got_path, want_path):
    got = [json.loads(x) for x in open(got_path)]
    want = [json.loads(x) for x in open(want_path)]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("conf", "metric", "tick", "fallback", "sane", "clamped"):
            assert g[k] == w[k], (k, g, w)
        for k in ("goal", "sensor", "deputy", "error", "raw", "applied"):
            assert _same_float(g[k], w[k]), (k, g, w)


def test_adaptive_admission_decisions_match_jax(jax_lane, port_lane):
    assert_decisions_match(port_lane["adaptive"]["telemetry_paths"]["audit"],
                           jax_lane["telemetry_paths"]["audit"])


@pytest.mark.parametrize("artifact", ["trace", "flight"])
def test_admission_trace_and_flight_equal_jax(jax_lane, port_lane,
                                              artifact):
    """Spans, chaos marks, request lifetimes and the flight recorder's
    sensor rings, byte for byte: the engines instrument the same points
    in the same order."""
    got = port_lane["adaptive"]["telemetry_paths"][artifact]
    want = jax_lane["telemetry_paths"][artifact]
    assert open(got, "rb").read() == open(want, "rb").read()


def test_adaptive_beats_every_static_admission_gate(port_lane):
    """``bench_slo.run``'s gates on the port's admission lane."""
    for name, r in port_lane.items():
        assert r["unhandled"] == [], f"{name}: {r['unhandled']}"
        assert r["chaos_events"] > 0, name
    ad = port_lane["adaptive"]
    assert ad["sensor_faults"] > 0
    for name, r in port_lane.items():
        if name != "adaptive":
            assert ad["goodput_tps"] > r["goodput_tps"], name
    assert C.lane_faults(port_lane, "admission") == []


def test_admission_audit_covers_every_chaos_event(port_lane):
    """``bench_slo._assert_telemetry`` on the port's written artifacts:
    a Decision within the reaction window of every chaos fault, a
    fallback of ``serve.admit_tier_max`` in the NaN window."""
    assert C.admission_audit_faults(port_lane["adaptive"]) == []
    cut = port_lane["adaptive"]["store_cuts"][0]
    (blocks, (c0, b0, _), (c1, b1, _)) = cut
    assert blocks == 9 and c1 < c0 and b1 < b0      # the store shrank
