"""The port's open-loop traffic (``repro_torch.serve.traffic``): the
counterparts of ``tests/test_traffic.py``, then the same ``TraceConfig``
through both packages, which must give equal events and equal prompt
tokens, and ``chip_smoke.py``'s copies of ``bench_slo``'s traces and
constants against ``benchmarks/bench_slo.py``."""

import dataclasses
import os
import sys

import numpy as np
import pytest

from repro.serve import traffic as jtraffic
from repro_torch.serve.traffic import (TickCostModel, TierSpec, TraceConfig,
                                       TraceEvent, VirtualClock, as_requests,
                                       concat_traces, synthesize_trace)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


# ------------------------------------------- counterparts of test_traffic

def test_trace_deterministic_from_seed():
    cfg = TraceConfig(rate_rps=40, horizon_s=4.0, seed=3)
    assert synthesize_trace(cfg) == synthesize_trace(cfg)
    other = synthesize_trace(dataclasses.replace(cfg, seed=4))
    assert other != synthesize_trace(cfg)


def test_poisson_rate_matches_config():
    cfg = TraceConfig(process="poisson", rate_rps=50, horizon_s=40.0, seed=0)
    n = len(synthesize_trace(cfg))
    # 2000 expected arrivals; 5 sigma ~ +-224
    assert 1700 <= n <= 2300


def test_bursty_rate_is_modulated():
    cfg = TraceConfig(process="bursty", rate_rps=30, horizon_s=40.0, seed=1,
                      burst_factor=6.0, burst_period_s=4.0, burst_duty=0.25)
    events = synthesize_trace(cfg)
    on = [e for e in events if (e.t % 4.0) < 1.0]
    off = [e for e in events if (e.t % 4.0) >= 1.0]
    on_rate = len(on) / (0.25 * 40.0)
    off_rate = len(off) / (0.75 * 40.0)
    assert on_rate > 3.0 * off_rate          # true ratio is 6x
    assert 0.75 * 30 <= len(events) / 40.0 <= 1.25 * 30


def test_diurnal_rate_follows_the_sinusoid():
    cfg = TraceConfig(process="diurnal", rate_rps=40, horizon_s=40.0, seed=2,
                      diurnal_period_s=10.0, diurnal_amplitude=0.9)
    events = synthesize_trace(cfg)
    high = sum(1 for e in events if (e.t % 10.0) < 5.0)
    low = len(events) - high
    assert high > 1.5 * low


def test_unknown_process_rejected():
    with pytest.raises(ValueError, match="unknown arrival process"):
        synthesize_trace(TraceConfig(process="fractal"))


def test_lengths_are_heavy_tailed_and_bounded():
    cfg = TraceConfig(rate_rps=100, horizon_s=30.0, seed=5,
                      prompt_lo=4, prompt_hi=64, prompt_alpha=1.1)
    plens = np.asarray([e.prompt_len for e in synthesize_trace(cfg)])
    assert plens.min() >= 4 and plens.max() <= 64
    assert np.median(plens) < 12
    assert plens.max() > 48


def test_tier_shares_and_deadlines():
    tiers = (TierSpec(0, 0.5, deadline_s=5.0), TierSpec(1, 0.5))
    cfg = TraceConfig(rate_rps=60, horizon_s=20.0, seed=6, tiers=tiers)
    events = synthesize_trace(cfg)
    n0 = sum(1 for e in events if e.tier == 0)
    assert 0.4 <= n0 / len(events) <= 0.6
    assert all(e.deadline_s == 5.0 for e in events if e.tier == 0)
    assert all(e.deadline_s is None for e in events if e.tier == 1)


def test_as_requests_materialisation():
    events = [TraceEvent(t=0.5, req_id=7, tier=2, deadline_s=9.0,
                         prompt_len=11, max_new_tokens=3)]
    (t, req), = as_requests(events, vocab=64, seed=0, id_base=100)
    assert t == 0.5 and req.req_id == 107
    assert req.prompt.dtype == np.int32 and req.prompt.shape == (11,)
    assert (req.prompt > 0).all() and (req.prompt < 64).all()
    assert req.tier == 2 and req.deadline_s == 9.0 and req.max_new_tokens == 3


def test_virtual_clock():
    vc = VirtualClock(start=2.0)
    assert vc() == 2.0
    assert vc.advance(0.5) == 2.5
    assert vc() == 2.5


def test_tick_cost_model_charges_issued_lanes():
    cost = TickCostModel(base_s=0.01, prefill_token_s=1e-3,
                         decode_token_s=1e-2)
    stats = {"prefill_tokens": 10, "prefill_issued_tokens": 16,
             "decode_tokens": 3}
    assert cost.cost(stats) == pytest.approx(0.01 + 16e-3 + 3e-2)
    assert cost.cost({}) == pytest.approx(0.01)


def test_concat_traces_regime_shift():
    calm = synthesize_trace(TraceConfig(
        process="poisson", rate_rps=10.0, horizon_s=2.0, seed=3))
    storm = synthesize_trace(TraceConfig(
        process="bursty", rate_rps=40.0, horizon_s=2.0, t_start=2.0,
        seed=4, burst_factor=4.0, burst_period_s=1.0, burst_duty=0.5))
    merged = concat_traces(calm, storm)
    assert len(merged) == len(calm) + len(storm)
    ts = [e.t for e in merged]
    assert ts == sorted(ts)
    assert [e.req_id for e in merged] == list(range(len(merged)))
    n_calm = sum(1 for e in merged if e.t < 2.0)
    n_storm = len(merged) - n_calm
    assert n_storm > 2 * n_calm


# ------------------------------------------------- the port against JAX

def _both(cls_name, **kw):
    """The same dataclass instance built in each package."""
    from repro_torch.serve import traffic
    out = []
    for mod in (jtraffic, traffic):
        if "tiers" in kw:
            kw = dict(kw, tiers=tuple(mod.TierSpec(**dataclasses.asdict(t))
                                      for t in kw["tiers"]))
        out.append(getattr(mod, cls_name)(**kw))
    return out


CONFIGS = [
    dict(process="poisson", rate_rps=30.0, horizon_s=5.0, seed=0),
    dict(process="bursty", rate_rps=60.0, horizon_s=3.0, seed=23,
         t_start=3.0, burst_factor=4.0, burst_period_s=0.75,
         burst_duty=0.5, prompt_hi=24, new_hi=8),
    dict(process="diurnal", rate_rps=20.0, horizon_s=8.0, seed=9,
         diurnal_amplitude=0.5),
    dict(process="poisson", rate_rps=40.0, horizon_s=3.0, seed=4,
         prefix_groups=3, prefix_len=12, prefix_share=0.7,
         tiers=(TierSpec(0, 0.5, deadline_s=2.0), TierSpec(1, 0.5))),
]


@pytest.mark.parametrize("kw", CONFIGS,
                         ids=["poisson", "bursty", "diurnal", "prefix"])
def test_same_config_same_events_and_tokens_as_jax(kw):
    jcfg, tcfg = _both("TraceConfig", **kw)
    jev, tev = jtraffic.synthesize_trace(jcfg), synthesize_trace(tcfg)
    assert len(tev) > 10
    assert [dataclasses.asdict(e) for e in tev] == \
        [dataclasses.asdict(e) for e in jev]
    jreq = jtraffic.as_requests(jev, vocab=512, seed=1, id_base=5)
    treq = as_requests(tev, vocab=512, seed=1, id_base=5)
    for (jt, jr), (tt, tr) in zip(jreq, treq, strict=True):
        assert tt == jt and tr.req_id == jr.req_id
        assert (tr.prompt.dtype, tr.prompt.tolist()) == \
            (jr.prompt.dtype, jr.prompt.tolist())
        assert (tr.tier, tr.deadline_s, tr.max_new_tokens) == \
            (jr.tier, jr.deadline_s, jr.max_new_tokens)


def test_concat_and_cost_model_match_jax():
    segs = [dict(process="poisson", rate_rps=10.0, horizon_s=2.0, seed=3),
            dict(process="bursty", rate_rps=40.0, horizon_s=2.0,
                 t_start=2.0, seed=4)]
    jparts, tparts = zip(*(_both("TraceConfig", **kw) for kw in segs))
    jm = jtraffic.concat_traces(*map(jtraffic.synthesize_trace, jparts))
    tm = concat_traces(*map(synthesize_trace, tparts))
    assert [dataclasses.asdict(e) for e in tm] == \
        [dataclasses.asdict(e) for e in jm]
    jc, tc = _both("TickCostModel", base_s=0.02, prefill_token_s=1e-3,
                   decode_token_s=8e-3, spec_lane_s=2e-4)
    for st in ({}, {"prefill_tokens": 9}, {"prefill_issued_tokens": 32,
                                           "decode_slots": 3,
                                           "spec_lanes": 2},
               {"decode_tokens": 4}):
        assert tc.cost(st) == jc.cost(st)


def test_chip_smoke_lanes_are_bench_slos():
    """``chip_smoke.py`` (which runs where JAX is absent) copies
    ``bench_slo``'s constants: they, its traces and its chaos schedule
    equal the benchmark's."""
    import chip_smoke as C
    from benchmarks import bench_slo as B
    pairs = {"SLO_CALM_RPS": "CALM_RPS", "SLO_STORM_RPS": "STORM_RPS",
             "SLO_STORM_FACTOR": "STORM_FACTOR",
             "SLO_STORM_DUTY": "STORM_DUTY", "SLO_TTFT_S": "TTFT_SLO_S",
             "SLO_HORIZON_S": "SMOKE_HORIZON_S", "SLO_MAX_BATCH": "MAX_BATCH",
             "SLO_CACHE_LEN": "CACHE_LEN",
             "ROUTER_CALM_RPS": "ROUTER_CALM_RPS",
             "ROUTER_STORM_RPS": "ROUTER_STORM_RPS",
             "ROUTER_STALL_PERIOD": "ROUTER_STALL_PERIOD",
             "ROUTER_SPLITS": "ROUTER_SPLITS",
             "SLO_REACTION_TICKS": "REACTION_WINDOW_TICKS"}
    for mine, theirs in pairs.items():
        assert getattr(C, mine) == getattr(B, theirs), mine
    assert len(C.SLO_SHARES) == B.NUM_TIERS
    assert [dataclasses.asdict(t) for t in C.slo_tiers()] == \
        [dataclasses.asdict(t) for t in B._tiers()]
    assert C.SLO_STATIC == {"static_open": B.NUM_TIERS - 1,
                            "static_mid": 1, "static_tight": 0}
    horizon = B.SMOKE_HORIZON_S
    for mine, theirs in ((C.admission_trace(horizon), B._make_trace(horizon)),
                         (C.router_trace(horizon), B._router_trace(horizon))):
        assert [dataclasses.asdict(e) for e in mine] == \
            [dataclasses.asdict(e) for e in theirs]
    assert dataclasses.asdict(C.admission_chaos()) == \
        dataclasses.asdict(B._chaos_spec(horizon))
