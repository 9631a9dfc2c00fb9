"""The port's telemetry on the CPU: the pure units of
``tests/test_telemetry.py`` against the port's copy of
``core/telemetry.py`` (and its SmartConf audit hooks), the engine
integration tests, and a driven run whose written artifacts must equal
the JAX engine's byte for byte."""

import ast
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import zoo as jzoo
from repro.serve import OpenLoopDriver as JOpenLoopDriver
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SLOSpec as JSLOSpec
from repro.serve import TickCostModel as JTickCostModel
from repro.serve import TraceConfig as JTraceConfig
from repro.serve import VirtualClock as JVirtualClock
from repro.serve import as_requests as j_as_requests
from repro.serve import synthesize_trace as j_synthesize_trace
from repro_torch.configs import get_config, reduced
from repro_torch.core import ControllerModel, GoalSpec
from repro_torch.core.smartconf import (ConfRegistry, Guardrails, SmartConf,
                                        SmartConfIndirect)
from repro_torch.core.telemetry import (Decision, DecisionLog, FlightRecorder,
                                        Histogram, MetricsRegistry, Telemetry,
                                        Tracer)
from repro_torch.models.bridge import params_from_numpy, tree_leaves
from repro_torch.serve import (OpenLoopDriver, Request, SLOSpec, ServeEngine,
                               TICK_STATS_KEYS, TickCostModel, TraceConfig,
                               VirtualClock, as_requests, synthesize_trace)

ROOT = Path(__file__).resolve().parents[1]


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
def small_model(models):
    return models[2], models[3]


def _req(rng, cfg, rid, plen=12, new=4, **kw):
    return Request(rid, rng.integers(1, cfg.vocab_size, plen)
                   .astype(np.int32), new, **kw)


def _code(path: Path) -> str:
    """The module's AST without docstrings."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", ["telemetry", "smartconf"])
def test_core_copy_is_the_reference_code(name):
    """The port keeps its own copies of these pure-Python modules: they
    must stay the reference's code, docstrings aside."""
    assert _code(ROOT / "src/repro_torch/core" / f"{name}.py") == \
        _code(ROOT / "src/repro/core" / f"{name}.py")


# ------------------------------------------------------------- metrics unit

def test_histogram_quantiles_and_nonfinite_skip():
    h = Histogram("h", buckets=(0.1, 0.2, 0.4, 0.8))
    for v in (0.05, 0.05, 0.15, 0.3, 0.3, 0.3, 0.5, 0.7, 2.0):
        h.record(v)
    h.record(float("nan"))
    h.record(float("inf"))
    assert h.count == 9
    assert h.p50() == 0.4
    assert h.p99() == h._max == 2.0
    assert h.p50() <= h.p90() <= h.p99()
    snap = h.snapshot()
    assert snap["count"] == 9 and snap["min"] == 0.05
    assert sum(snap["counts"]) == 9
    assert Histogram("e", buckets=(1.0,)).p99() == 0.0


def test_metrics_registry_get_or_create_and_write(tmp_path):
    m = MetricsRegistry()
    m.counter("a").inc()
    m.counter("a").inc(2)
    m.gauge("g").set(3.5)
    m.histogram("h").record(0.01)
    assert m.counter("a").value == 3
    path = str(tmp_path / "metrics.json")
    m.write(path)
    snap = json.load(open(path))
    assert snap["counters"]["a"] == 3
    assert snap["gauges"]["g"] == 3.5
    assert snap["histograms"]["h"]["count"] == 1


# -------------------------------------------------------------- tracer unit

def test_tracer_tick_spans_and_schema():
    t = [0.0]
    trc = Tracer(clock=lambda: t[0])
    trc.begin_tick(0)
    for name in ("admit", "pack", "dispatch"):
        trc.phase(name)
    t[0] = 0.03
    trc.end_tick(args={"tokens": 5})
    trc.instant("chaos:slow_tick", tid=Tracer.TID_CHAOS)
    trc.async_begin("request", 7, args={"tier": 0})
    trc.async_end("request", 7)
    evs = trc.events
    spans = [e for e in evs if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["tick 0", "admit", "pack",
                                         "dispatch"]
    tick = spans[0]
    assert tick["dur"] == 30_000
    assert sum(e["dur"] for e in spans[1:]) == tick["dur"]
    assert spans[1]["ts"] == tick["ts"]
    for e in evs:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        if e["ph"] != "M":
            assert isinstance(e["ts"], int)
        if e["ph"] == "X":
            assert isinstance(e["dur"], int) and e["dur"] >= 1
        if e["ph"] in ("b", "e"):
            assert "id" in e and "cat" in e
    doc = trc.to_json()
    assert doc["traceEvents"] and doc["otherData"]["dropped_events"] == 0
    json.dumps(doc)


def test_tracer_bounded_drops_counted():
    trc = Tracer(clock=lambda: 0.0, max_events=5)
    for i in range(10):
        trc.instant(f"e{i}")
    assert len(trc.events) == 5
    assert trc.dropped == 8


# ----------------------------------------------------- flight recorder unit

def test_flight_recorder_ring_and_dedupe():
    fr = FlightRecorder(window=4, max_dumps=2)
    for tick in range(10):
        fr.record(tick, {"s": (float(tick), float(tick))})
    assert [r["tick"] for r in fr._ring] == [6, 7, 8, 9]
    assert fr.dump("storm", 9) is True
    assert fr.dump("storm", 10) is False
    assert fr.dump("storm", 9 + 4) is True
    assert fr.dump("other", 20) is False
    assert fr.dropped_dumps == 1
    snap = fr.snapshot()
    assert len(snap["dumps"]) == 2
    assert snap["dumps"][0]["ring"][-1]["tick"] == 9


def test_flight_recorder_sanitizes_nonfinite(tmp_path):
    fr = FlightRecorder()
    fr.record(0, {"ttft_p99_s": (float("nan"), float("inf"))})
    fr.dump("chaos:sensor_nan", 0)
    path = str(tmp_path / "flight.json")
    fr.write(path)
    snap = json.load(open(path))
    assert snap["dumps"][0]["ring"][0]["ttft_p99_s"] == ["nan", "inf"]


# --------------------------------------------------------------- audit unit

def _decision(**kw):
    base = dict(tick=0, conf="c", metric="m", goal=1.0, sensor=0.5,
                deputy=None, sane=True, error=0.5, raw=2.0, applied=1.5,
                clamped=True, fallback=False)
    base.update(kw)
    return Decision(**base)


def test_decision_log_query_bound_and_jsonl(tmp_path):
    log = DecisionLog(max_records=3)
    for i in range(5):
        log.tick = i
        log.append(_decision(tick=log.tick, fallback=i >= 3))
    assert len(log.records) == 3 and log.dropped == 2
    assert [d.tick for d in log.query(fallback=True)] == [3, 4]
    log.append(_decision(tick=9, sensor=float("nan")))
    path = str(tmp_path / "audit.jsonl")
    log.write_jsonl(path)
    lines = [json.loads(x) for x in open(path)]
    assert len(lines) == 3
    assert lines[-1]["sensor"] == "nan"


def test_smartconf_audit_records_fallback_and_clamp():
    log = DecisionLog()
    sc = SmartConf(
        "t.knob", metric="lat", goal=GoalSpec(1.0, hard=True), initial=4.0,
        model=ControllerModel(alpha=1.0, delta=1.3, lam=0.1, conf_max=100.0),
        guardrails=Guardrails(perf_lo=0.0, perf_hi=10.0, fault_tolerance=2,
                              max_step=0.5),
        registry=ConfRegistry())
    sc.attach_audit(log)
    log.tick = 1
    sc.set_perf(5.0)
    v1 = sc.get_conf()
    d = log.records[-1]
    assert (d.conf, d.metric, d.tick) == ("t.knob", "lat", 1)
    assert d.sane and not d.fallback
    assert d.applied == v1
    if d.clamped:
        assert abs(d.raw - d.applied) > 0.0
    log.tick = 2
    sc.set_perf(float("nan"))
    sc.get_conf()
    assert not log.records[-1].sane
    log.tick = 3
    sc.set_perf(float("nan"))
    pinned = sc.get_conf()
    d = log.records[-1]
    assert d.fallback and not d.sane
    assert d.applied == pinned
    assert log.query(fallback=True, tick=3)


def test_smartconf_indirect_audit_carries_deputy():
    log = DecisionLog()
    sci = SmartConfIndirect(
        "t.ind", metric="hbm", goal=GoalSpec(100.0, hard=True), initial=8.0,
        model=ControllerModel(alpha=1.0, delta=1.3, lam=0.1, conf_max=1e6),
        registry=ConfRegistry())
    sci.attach_audit(log)
    log.tick = 4
    sci.set_perf(50.0, 7.0)
    sci.get_conf()
    d = log.records[-1]
    assert d.deputy == 7.0 and d.sensor == 50.0 and d.tick == 4


def test_unaudited_smartconf_stages_nothing():
    sc = SmartConf(
        "t.knob", metric="lat", goal=GoalSpec(1.0), initial=4.0,
        model=ControllerModel(alpha=1.0), registry=ConfRegistry())
    sc.set_perf(0.5)
    sc.get_conf()
    assert sc.audit is None and sc._audit_pending is None


# -------------------------------------------------------- engine integration

def test_disabled_telemetry_is_absent_from_engine(small_model):
    cfg, params = small_model
    for tel in (None, Telemetry(enabled=False), Telemetry.disabled()):
        eng = ServeEngine(cfg, params, max_batch=2, cache_len=64,
                          enable_smartconf=False, telemetry=tel,
                          device="cpu")
        assert eng._tel is None
        eng.tick()
        eng.close()


def test_repro_telemetry_env_enables_nothing(small_model, monkeypatch):
    """The reference's ``REPRO_TELEMETRY`` has no counterpart: no
    environment variable turns on a path in the port."""
    cfg, params = small_model
    monkeypatch.setenv("REPRO_TELEMETRY", "1")
    eng = ServeEngine(cfg, params, max_batch=2, cache_len=64,
                      enable_smartconf=False, device="cpu")
    assert eng._tel is None
    eng.close()


def test_tick_stats_schema_frozen(small_model):
    cfg, params = small_model
    eng = ServeEngine(cfg, params, max_batch=2, cache_len=64,
                      enable_smartconf=False, device="cpu")
    assert tuple(eng._stats(0)) == TICK_STATS_KEYS
    stats = eng.tick()
    assert tuple(stats) == TICK_STATS_KEYS
    assert stats["tick"] == 0 and eng.ticks_run == 1
    eng.close()


def test_engine_emits_spans_counters_and_readings(small_model, rng):
    cfg, params = small_model
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    tel = Telemetry(enabled=True)
    eng = ServeEngine(cfg, params, max_batch=2, cache_len=64,
                      block_tokens=16, enable_smartconf=True,
                      hbm_budget_bytes=weights + 2_000_000,
                      slo=SLOSpec(ttft_s=5.0, window=8), telemetry=tel,
                      device="cpu")
    assert eng.submit(_req(rng, cfg, 0))
    assert not eng.submit(_req(rng, cfg, 1, plen=0))
    ticks = 0
    while len(eng.finished) < 1 and ticks < 50:
        eng.tick()
        ticks += 1
    assert len(eng.finished) == 1
    names = {e["name"] for e in tel.tracer.events}
    assert "tick 0" in names
    assert {"control", "admit", "schedule", "finish"} <= names
    assert "dispatch" in names
    snap = tel.metrics.snapshot()
    assert snap["counters"]["serve.ticks"] == ticks
    assert snap["counters"]["serve.reject.empty_prompt"] == 1
    assert snap["histograms"]["serve.ttft_s"]["count"] == 1
    assert tel.flight._ring and "ttft_p99_s" in tel.flight._ring[-1]
    confs = {d.conf for d in tel.audit.records}
    assert {"serve.admit_tier_max", "serve.kv_block_budget",
            "serve.max_queue_tokens"} <= confs
    ends = [e for e in tel.tracer.events if e["ph"] == "e"]
    assert {e["id"] for e in ends} == {0, 1}
    eng.close()


def test_chaos_note_marks_trace_and_dumps_flight(small_model):
    cfg, params = small_model
    tel = Telemetry(enabled=True)
    eng = ServeEngine(cfg, params, max_batch=2, cache_len=64,
                      enable_smartconf=False, telemetry=tel, device="cpu")
    eng.note_chaos("sensor_nan:ttft_p99_s")
    eng.note_chaos("sensor_nan:decode_p99_s")
    marks = [e for e in tel.tracer.events
             if e["ph"] == "i" and e["name"].startswith("chaos:")]
    assert len(marks) == 2 and marks[0]["tid"] == Tracer.TID_CHAOS
    assert tel.metrics.counter("chaos.sensor_nan").value == 2
    assert [d["reason"] for d in tel.flight.dumps] == ["chaos:sensor_nan"]
    eng.close()


# ------------------------------------------------------------- determinism

def _driven_run(cfg, params, tmp_dir, *, jax_engine=False):
    if jax_engine:
        (Engine, Slo, Clock, Driver, Cost, Trace, synth, reqs, kw) = (
            JServeEngine, JSLOSpec, JVirtualClock, JOpenLoopDriver,
            JTickCostModel, JTraceConfig, j_synthesize_trace,
            j_as_requests, {})
    else:
        (Engine, Slo, Clock, Driver, Cost, Trace, synth, reqs, kw) = (
            ServeEngine, SLOSpec, VirtualClock, OpenLoopDriver,
            TickCostModel, TraceConfig, synthesize_trace, as_requests,
            {"device": "cpu"})
    vc = Clock()
    tel = Telemetry(enabled=True, clock=vc)
    if jax_engine:
        from repro.core.telemetry import Telemetry as JTelemetry
        tel = JTelemetry(enabled=True, clock=vc)
    eng = Engine(cfg, params, max_batch=2, cache_len=64, block_tokens=16,
                 enable_smartconf=True, slo=Slo(ttft_s=0.5, window=8),
                 num_tiers=2, clock=vc, telemetry=tel, **kw)
    trace = synth(Trace(
        process="poisson", rate_rps=20.0, horizon_s=2.0, seed=11,
        prompt_lo=4, prompt_hi=16, new_lo=2, new_hi=6))
    drv = Driver(eng, reqs(trace, vocab=cfg.vocab_size, seed=3), clock=vc,
                 cost=Cost(base_s=0.02, prefill_token_s=1e-3,
                           decode_token_s=8e-3))
    out = drv.run()
    assert out["unhandled"] == []
    paths = tel.write(tmp_dir)
    eng.close()
    return paths


def test_telemetry_deterministic_under_virtual_clock(small_model, tmp_path):
    cfg, params = small_model
    paths_a = _driven_run(cfg, params, str(tmp_path / "a"))
    paths_b = _driven_run(cfg, params, str(tmp_path / "b"))
    audit_a = open(paths_a["audit"], "rb").read()
    assert audit_a and audit_a == open(paths_b["audit"], "rb").read()
    assert open(paths_a["trace"], "rb").read() == \
        open(paths_b["trace"], "rb").read()
    assert open(paths_a["flight"], "rb").read() == \
        open(paths_b["flight"], "rb").read()
    doc = json.load(open(paths_a["trace"]))
    for e in doc["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert e["dur"] >= 1 and e["ts"] >= 0
    assert doc["otherData"]["dropped_events"] == 0
    ticks = [json.loads(x)["tick"] for x in open(paths_a["audit"])]
    assert ticks == sorted(ticks)


@pytest.mark.parametrize("artifact", ["audit", "trace", "flight"])
def test_driven_run_artifacts_equal_jax(models, tmp_path, artifact):
    """The same weights, trace and virtual clock through both engines:
    the Decisions, the span timeline and the sensor rings are the same
    bytes (metrics.json differs only by the unported speculation's
    counters)."""
    jcfg, jp, cfg, tp = models
    got = _driven_run(cfg, tp, str(tmp_path / "port"))
    want = _driven_run(jcfg, jp, str(tmp_path / "jax"), jax_engine=True)
    assert open(got[artifact], "rb").read() == \
        open(want[artifact], "rb").read()


# ------------------------------------------------------------ profiler ties

def test_write_sysfile_never_leaves_tmp_on_failure(tmp_path):
    from repro_torch.core.profiler import write_sysfile
    sys_dir = str(tmp_path)
    write_sysfile(sys_dir, "ok.conf", {"x": 1})
    with pytest.raises(TypeError):
        write_sysfile(sys_dir, "bad.conf", {"x": object()})
    leftovers = [f for f in os.listdir(sys_dir) if f.startswith(".")]
    assert leftovers == [], f"tmp files leaked: {leftovers}"
    assert sorted(os.listdir(sys_dir)) == ["ok.conf.smartconf.sys"]


def test_profile_buffer_emits_flush_metrics(tmp_path):
    from repro_torch.core.profiler import ProfileBuffer
    m = MetricsRegistry()
    buf = ProfileBuffer(str(tmp_path), "t.knob", flush_every=4, metrics=m)
    for i in range(9):
        buf.record(float(i % 3), float(i))
    buf.flush()
    assert len(buf.samples) == 9
    assert m.counter("profiler.t.knob.samples").value == 9
    assert m.counter("profiler.t.knob.flushes").value == 3
