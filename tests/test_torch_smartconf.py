"""The port's SmartConf core against the JAX package's, trace for trace.

The core is pure Python in both packages; the port keeps its own copy.
Each scenario drives ``repro.core`` and ``repro_torch.core`` with the same
sensor trace (closed loops feed each copy its own actuations back) and
collects every actuation and guard counter: the two lists must be equal.
The scenarios are properties of ``tests/test_controller.py`` and
``tests/test_guardrails.py`` and sensor traces from a numpy seed.
"""

import math

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore


def _mk(core, *, guardrails=None, alpha=2.0, goal=100.0, initial=10.0,
        hard=False, conf_min=0.0, conf_max=1000.0, lam=0.1, delta=1.0):
    return core.SmartConf(
        "test.knob", metric="lat", goal=core.GoalSpec(goal, hard=hard),
        initial=initial, registry=core.ConfRegistry(),
        guardrails=None if guardrails is None else core.Guardrails(
            **guardrails),
        model=core.ControllerModel(alpha=alpha, lam=lam, delta=delta,
                                   conf_min=conf_min, conf_max=conf_max))


def _state(sc):
    return (sc.sensor_failed, sc.sensor_faults, sc.clamped_actuations)


def linear_plant(core):
    """Closed loop on s = 1.8 * conf; converges to the soft goal."""
    sc = _mk(core, alpha=1.8, goal=90.0, initial=0.0, conf_max=1e9)
    out, s = [], 0.0
    for _ in range(60):
        sc.set_perf(s)
        c = sc.get_conf()
        s = 1.8 * c
        out.append(c)
    assert s == pytest.approx(90.0, rel=1e-2)
    return out


def two_pole_hard_goal(core):
    """Hard goal: the aggressive pole above the virtual goal, the
    conservative one below it."""
    sc = _mk(core, alpha=1.0, goal=100.0, hard=True, initial=0.0,
             conf_min=-1e9, conf_max=1e9, delta=4.0)
    out = []
    for perf in (99.0, 50.0, 95.0, 120.0, 10.0, 89.0):
        sc.set_perf(perf)
        out.append(sc.get_conf())
    return out


def indirect_pair_shares_the_error(core):
    """Two indirect confs on one hard metric split the error (N = 2)."""
    reg = core.ConfRegistry()
    goal = core.GoalSpec(1000.0, hard=True, super_hard=True)
    a, b = (core.SmartConfIndirect(
        name, metric="bytes", goal=goal, initial=init, registry=reg,
        model=core.ControllerModel(alpha=alpha, lam=0.05, delta=1.15,
                                   conf_min=0.0, conf_max=1e9))
        for name, init, alpha in (("q", 0.0, 4.0), ("kv", 1.0, 64.0)))
    rng = np.random.default_rng(1)
    out = []
    for _ in range(30):
        perf = float(rng.uniform(200, 1400))
        a.set_perf(perf, float(rng.integers(0, 100)))
        b.set_perf(perf, float(rng.integers(0, 10)))
        out.append((a.get_conf(), b.get_conf()))
    return out


def insane_readings_are_absorbed(core):
    sc = _mk(core, guardrails=dict(perf_lo=0.0, perf_hi=1e6))
    out = []
    for r in (50.0, math.nan, math.inf, -math.inf, -1.0, 1e9, 60.0):
        sc.set_perf(r)
        c = sc.get_conf()
        assert math.isfinite(c)
        out.append((c, _state(sc)))
    return out


def fallback_and_recovery(core):
    """Pinned to last-known-good after three faults, live again after."""
    sc = _mk(core, guardrails=dict(perf_lo=0.0, perf_hi=1e6,
                                   fault_tolerance=3))
    out = []
    for r in (50.0, math.nan, math.nan, math.nan, math.nan, 50.0, 40.0):
        sc.set_perf(r)
        out.append((sc.get_conf(), _state(sc)))
    return out


def explicit_fallback(core):
    sc = _mk(core, guardrails=dict(perf_lo=0.0, perf_hi=1e6,
                                   fault_tolerance=1, fallback=42.0))
    sc.set_perf(50.0)
    out = [sc.get_conf()]
    sc.set_perf(math.nan)
    out.append((sc.get_conf(), _state(sc)))
    assert out[-1][0] == pytest.approx(42.0)
    return out


def slew_clamp_and_anti_windup(core):
    sc = _mk(core, guardrails=dict(max_step=5.0), alpha=1.0, goal=1000.0)
    out = [sc.get_conf()]
    for _ in range(4):
        sc.set_perf(0.0)
        out.append((sc.get_conf(), sc.controller.conf, _state(sc)))
    assert all(abs(b[0] - a) <= 5.0 + 1e-9 for a, b in
               zip([out[0]] + [o[0] for o in out[1:-1]], out[1:]))
    return out


def mid_run_ceiling_cut(core):
    sc = _mk(core, guardrails=dict(perf_lo=0.0, perf_hi=1e6), initial=800.0)
    out = []
    for cap in (None, 100.0, None, 1000.0, None):
        if cap is not None:
            sc.clamp_conf_max(cap)
        sc.set_perf(50.0)
        out.append(sc.get_conf())
    return out


def indirect_non_finite_deputy(core):
    sc = core.SmartConfIndirect(
        "test.indirect", metric="bytes", goal=core.GoalSpec(1000.0, hard=True),
        initial=10.0, registry=core.ConfRegistry(),
        guardrails=core.Guardrails(perf_lo=0.0, perf_hi=1e9,
                                   fault_tolerance=1),
        model=core.ControllerModel(alpha=2.0, conf_min=0.0, conf_max=1e6))
    out = []
    for perf, dep in ((500.0, 5.0), (500.0, math.nan), (700.0, 9.0)):
        sc.set_perf(perf, dep)
        out.append((sc.get_conf(), _state(sc)))
    return out


def random_trace(core):
    """An open-loop noisy trace with a goal change mid-run."""
    sc = _mk(core, guardrails=dict(perf_lo=0.0, perf_hi=1e4, max_step=50.0),
             alpha=0.7, goal=300.0, hard=True, conf_max=5000.0, lam=0.2,
             delta=1.3)
    rng = np.random.default_rng(4)
    out = []
    for i in range(80):
        if i == 40:
            sc.set_goal(150.0)
        sc.set_perf(float(rng.gamma(2.0, 120.0)))
        out.append(sc.get_conf())
    return out


def fitted_model(core):
    """Profiling samples -> the synthesised control model."""
    rng = np.random.default_rng(2)
    confs = [10.0, 20.0, 40.0, 80.0]
    perfs = [(3.0 * c + 7.0 + rng.normal(0, 2.0, 6)).tolist() for c in confs]
    m = core.fit_model(confs, perfs, conf_max=200.0)
    return (m.alpha, m.lam, m.delta, core.compute_pole(m.delta),
            core.compute_virtual_goal(core.GoalSpec(100.0, hard=True),
                                      m.lam))


SCENARIOS = [linear_plant, two_pole_hard_goal, indirect_pair_shares_the_error,
             insane_readings_are_absorbed, fallback_and_recovery,
             explicit_fallback, slew_clamp_and_anti_windup,
             mid_run_ceiling_cut, indirect_non_finite_deputy, random_trace,
             fitted_model]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_same_trace_same_actuations(scenario):
    want = scenario(jcore)
    got = scenario(tcore)
    assert got == want


def test_unguarded_nan_still_crashes_the_actuation():
    """The copy keeps the reference's failure mode where it has no
    guardrails, as the guardrail tests rely on."""
    for core in (jcore, tcore):
        sc = _mk(core)
        sc.set_perf(math.nan)
        with pytest.raises(ValueError):
            int(sc.get_conf())


# ----------------------------------------------------------------- sensors
def sensor_trace(core):
    """The engine's sensors on one trace: the HBM ledger (charges,
    credits, peak, violations), latency quantiles and a windowed rate on
    an injected clock."""
    rng = np.random.default_rng(3)
    acc = core.HBMAccountant(budget_bytes=5000)
    now = [0.0]
    lat = core.LatencySensor(window=16, clock=lambda: now[0])
    thr = core.ThroughputSensor(window_seconds=2.0, clock=lambda: now[0])
    out = []
    for i in range(40):
        name = ("weights", "kv", "queue")[i % 3]
        acc.charge(name, int(rng.integers(0, 400)))
        if i % 4 == 0:
            acc.credit("queue", int(rng.integers(0, 300)))
        with lat.measure():
            now[0] += float(rng.exponential(0.01))
        thr.record(int(rng.integers(0, 9)))
        now[0] += 0.1
        out.append((acc.total(), acc.peak_bytes, acc.violations,
                    acc.headroom(), lat.mean(), lat.p99(), lat.count(),
                    thr.rate(), thr.total))
    return out


def test_sensors_match_jax():
    assert sensor_trace(tcore) == sensor_trace(jcore)


def test_device_live_bytes_counts_cpu_storage_once():
    import torch
    x = torch.zeros(1 << 18)                 # 1 MiB of float32
    view = x[1:]
    with_x = tcore.device_live_bytes("cpu")
    del x, view
    assert with_x - tcore.device_live_bytes("cpu") == 1 << 20
