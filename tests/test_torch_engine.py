"""The port's ServeEngine against the JAX package's, on the CPU.

Greedy decoding is deterministic, so the two engines must emit identical
tokens for the same weights and prompts, with at most one model dispatch
per tick: on paged KV for attention-only archs; on dense rings with
RG-LRU scan state for the hybrid recurrentgemma (its default) and for
yi-6b with ``kv_mode="dense"``; on per-slot WKV state alone for the
all-recurrent rwkv6-7b (its default).  With SmartConf on, an injected
clock and a sensor tap that spikes the ``hbm_bytes`` reading for three
ticks, the three knobs must follow the same trajectories and cause the
same preemptions.  Features the port does not serve yet must raise,
never be ignored.
"""

import io
import sys
import warnings
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import zoo as jzoo
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as launch_serve
from repro_torch.models.bridge import params_from_numpy
from repro_torch.core.telemetry import Telemetry
from repro_torch.serve import (TICK_STATS_KEYS, Request, ServeEngine,
                               ServeOptions, SLOSpec)
from repro_torch.serve.engine import RejectReason

PROMPT_LENS = (5, 19, 33)
MAX_NEW = 4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


class Clock:
    """Advanced only by the test: every span inside one tick reads 0."""

    def __init__(self) -> None:
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def _weights(arch, seed=0, **overrides):
    jcfg = jax_reduced(jax_get_config(arch), **overrides)
    params, _ = jzoo.init(jcfg, jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, reduced(get_config(arch), **overrides), tp


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _drive(eng, req_cls, prompts, max_new, clock=None, max_ticks=400,
           on_tick=None):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(i, p, max_new))
    stats = []
    while (len(eng.finished) + eng.rejected < len(prompts)
           and len(stats) < max_ticks):
        stats.append(eng.tick())
        if on_tick is not None:
            on_tick(eng)
        if clock is not None:
            clock.now += 0.01
    return stats


@pytest.mark.parametrize("arch", ["yi-6b", "h2o-danube-3-4b"])
def test_greedy_tokens_match_jax_engine(arch):
    jcfg, jp, cfg, tp = _weights(arch)
    prompts = _prompts(cfg, PROMPT_LENS)
    outs = []
    for eng, req_cls in (
            (JServeEngine(jcfg, jp, max_batch=2, cache_len=96,
                          enable_smartconf=False, prefill_mode="packed"),
             JRequest),
            (ServeEngine(cfg, tp, max_batch=2, cache_len=96,
                         enable_smartconf=False, device="cpu"), Request)):
        eng.prefill_chunk = 16
        stats = _drive(eng, req_cls, prompts, MAX_NEW)
        assert len(eng.finished) == len(prompts)
        assert max(st["dispatches"] for st in stats) <= 1
        outs.append(({r.req_id: list(r.generated) for r in eng.finished},
                     len(stats), eng.model_dispatches))
        eng.close()
    assert outs[0] == outs[1]


@pytest.mark.parametrize("spike_at", [3, 8])
def test_smartconf_trajectories_match_jax_engine(spike_at):
    """Three live knobs under a tight HBM goal; a spiked ``hbm_bytes``
    reading drives the KV budget below occupancy, which preempts, and a
    spiked decode latency cuts the prefill chunk."""
    jcfg, jp, cfg, tp = _weights("yi-6b")
    weights = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                  for x in jax.tree.leaves(jp))
    prompts = _prompts(cfg, (60, 12, 70, 20, 8, 50, 64, 33))
    runs = []
    for eng_cls, req_cls, cfg_, params in ((JServeEngine, JRequest, jcfg, jp),
                                           (ServeEngine, Request, cfg, tp)):
        clock = Clock()
        tick = [0]

        def tap(name, value):
            # the injected clock makes every latency span 0: the spike also
            # lifts decode p99 over its goal, so the chunk knob moves too
            if not spike_at <= tick[0] < spike_at + 3:
                return value
            return value + {"hbm_bytes": 300_000,
                            "decode_p99_s": 0.05}.get(name, 0)

        kw = {} if eng_cls is JServeEngine else {"device": "cpu"}
        eng = eng_cls(cfg_, params, max_batch=3, cache_len=96,
                      hbm_budget_bytes=weights + 500_000,
                      latency_goal_s=0.01, clock=clock, sensor_tap=tap, **kw)
        knobs = []

        def on_tick(e):
            tick[0] += 1
            knobs.append((e.max_queue_tokens, e.pool.max_blocks,
                          e.pool.capacity, e.prefill_chunk))

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # goal-unreachable notices
            _drive(eng, req_cls, prompts, 8, clock=clock, on_tick=on_tick)
        runs.append(dict(
            knobs=knobs, preemptions=eng.preemptions,
            rejected=dict(eng.reject_counts),
            tokens={r.req_id: list(r.generated) for r in eng.finished},
            violations=eng.accountant.violations))
        eng.close()
    jax_run, port_run = runs
    assert port_run == jax_run
    assert port_run["preemptions"] > 0
    for i in (0, 1, 3):      # every knob moved
        assert len({k[i] for k in port_run["knobs"]}) > 1


def test_kv_budget_cut_shrinks_the_store_like_jax():
    jcfg, jp, cfg, tp = _weights("gemma3-4b")
    prompts = _prompts(cfg, (30, 9, 41))
    runs = []
    for eng, req_cls in (
            (JServeEngine(jcfg, jp, max_batch=3, cache_len=64,
                          enable_smartconf=False), JRequest),
            (ServeEngine(cfg, tp, max_batch=3, cache_len=64,
                         enable_smartconf=False, device="cpu"), Request)):
        for i, p in enumerate(prompts):
            eng.submit(req_cls(i, p, 6))
        for _ in range(3):
            eng.tick()
        before = eng.pool.capacity
        eng.set_kv_budget(eng.blocks_per_seq)
        shapes = [tuple(c["k"].shape) for c in eng.caches["groups"]]
        after = (before, eng.pool.capacity, eng.preemptions, shapes)
        while len(eng.finished) < len(prompts):
            eng.tick()
        runs.append((after, {r.req_id: list(r.generated)
                             for r in eng.finished}))
        eng.close()
    assert runs[0] == runs[1]
    (before, cap, preempted, _), _ = runs[1]
    assert cap < before and preempted > 0


def test_tick_stats_keys_match_jax():
    from repro.serve.engine import TICK_STATS_KEYS as JAX_KEYS
    assert TICK_STATS_KEYS == JAX_KEYS
    _, _, cfg, tp = _weights("yi-6b")
    eng = ServeEngine(cfg, tp, max_batch=2, cache_len=64, device="cpu")
    eng.submit(Request(0, _prompts(cfg, (7,))[0], 2))
    assert tuple(eng.tick()) == TICK_STATS_KEYS


@pytest.mark.parametrize("prompt_len,reason", [
    (0, RejectReason.EMPTY_PROMPT), (90, RejectReason.PROMPT_TOO_LONG)])
def test_typed_rejections(prompt_len, reason):
    _, _, cfg, tp = _weights("yi-6b")
    eng = ServeEngine(cfg, tp, max_batch=2, cache_len=96, device="cpu")
    req = Request(0, np.zeros(prompt_len, np.int32), 8)
    adm = eng.submit(req)
    assert not adm and adm.reason is reason
    assert req.reject_reason is reason and eng.shed == [req]
    assert eng.reject_counts[str(reason)] == 1


@pytest.mark.parametrize("arch,options,error,match", [
    # the one-shot prefill has no paged cache: refused, as the reference
    ("yi-6b", {"prefill_mode": "one_shot", "kv_mode": "paged"}, ValueError,
     "paged KV requires"),
    # a modality frontend serves only through the one-shot path with it
    ("internvl2-1b", {}, NotImplementedError, "ROADMAP Queue 1 item 12"),
    (None, {"prefix_cache": True}, NotImplementedError, "ROADMAP"),
    (None, {"spec_depth": 2}, NotImplementedError, "ROADMAP"),
    (None, {"mesh": "2x4"}, NotImplementedError, "ROADMAP"),
    # one engine is one replica: more go behind the router
    (None, {"replicas": 2}, ValueError, "ReplicaRouter")],
    # the ids the cases had before a legacy case left the list
    ids=["yi-6b-options1-ValueError-paged KV requires",
         "internvl2-1b-options2-NotImplementedError-ROADMAP Queue 1 item 12"]
    + [f"None-options{i}-NotImplementedError-ROADMAP" for i in range(3, 6)]
    + ["None-replicas-ValueError-ReplicaRouter"])
def test_unported_options_raise(arch, options, error, match):
    """Options the port does not serve raise when built (``arch`` None),
    or when an engine for that arch is built with them."""
    if arch is None:
        with pytest.raises(error, match=match):
            ServeOptions(**options)
        return
    _, _, cfg, tp = _weights(arch)
    with pytest.raises(error, match=match):
        ServeEngine(cfg, tp, device="cpu", **options)


@pytest.mark.parametrize("options", [
    {"slo": SLOSpec(ttft_s=1.0)},
    {"telemetry": Telemetry(enabled=True)}],
    ids=["slo", "telemetry"])
def test_slo_options_now_build(options):
    """The SLO and telemetry options (once refused) build, and an engine
    with them serves on the CPU."""
    opts = ServeOptions(max_batch=2, cache_len=64, **options)
    _, _, cfg, tp = _weights("yi-6b")
    eng = ServeEngine(cfg, tp, options=opts, device="cpu")
    stats = _drive(eng, Request, _prompts(cfg, (7, 12)), 3)
    assert len(eng.finished) == 2 and tuple(stats[-1]) == TICK_STATS_KEYS
    assert (eng.sc_admit is not None) == ("slo" in options)
    assert (eng._tel is not None) == ("telemetry" in options)
    eng.close()


def test_slo_stats_match_jax():
    """A short SLO run with deadlines, a brownout gate and a worker
    preemption: every tick's ``slo_good_tokens``, ``slo_miss_tokens``,
    ``draining``, ``admit_tier_max`` and ``rejected`` equal the JAX
    engine's."""
    jcfg, jp, cfg, tp = _weights("yi-6b")
    prompts = _prompts(cfg, (9, 30, 14, 40, 6, 22, 17, 11))
    keys = ("slo_good_tokens", "slo_miss_tokens", "draining",
            "admit_tier_max", "rejected", "preemptions", "finished")
    runs = []
    for eng_cls, req_cls, cfg_, params in ((JServeEngine, JRequest, jcfg, jp),
                                           (ServeEngine, Request, cfg, tp)):
        clock = Clock()
        kw = {} if eng_cls is JServeEngine else {"device": "cpu"}
        eng = eng_cls(cfg_, params, max_batch=2, cache_len=64,
                      slo=SLOSpec(ttft_s=0.05, window=8), num_tiers=3,
                      clock=clock, **kw)
        for i, p in enumerate(prompts):
            eng.submit(req_cls(i, p, 5, tier=i % 3,
                               deadline_s=0.3 if i % 4 == 3 else None))
        stats = []
        for t in range(60):
            if t == 4:
                eng.preemption.trigger()
            elif t == 6:
                eng.preemption.reset()
            stats.append(eng.tick())
            clock.now += 0.01
        runs.append([{k: st[k] for k in keys} for st in stats])
        eng.close()
    assert runs[1] == runs[0]
    last = runs[1][-1]
    assert last["slo_good_tokens"] and last["slo_miss_tokens"]
    assert any(st["draining"] for st in runs[1])
    assert min(st["admit_tier_max"] for st in runs[1]) < 2 and last["rejected"]


def test_launcher_trace_mode_prints_the_summary_line(monkeypatch, tmp_path):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "yi-6b", "--device", "cpu", "--trace", "poisson",
        "--ttft-slo-s", "1", "--chaos", "--replicas", "2", "--horizon-s",
        "4", "--telemetry-dir", str(tmp_path)])
    out = io.StringIO()
    with redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        launch_serve.main()
    summary, tel = out.getvalue().strip().splitlines()[-2:]
    assert summary.startswith("yi-6b-smoke: open-loop poisson trace, ")
    assert "goodput" in summary and "unhandled 0" in summary
    assert "2 replicas: weights" in summary
    assert tel.startswith("telemetry: ")
    assert (tmp_path / "audit.jsonl").read_text()


def test_launcher_trace_mode_fails_on_an_unhandled_tick(monkeypatch):
    """A tick that raises in trace mode is caught by the driver, and the
    launcher still prints its summary, then exits non-zero."""
    real, seen = ServeEngine.tick, []

    def tick(self):
        seen.append(1)
        if len(seen) == 5:
            raise RuntimeError("kernel fault")
        return real(self)
    monkeypatch.setattr(ServeEngine, "tick", tick)
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "yi-6b", "--device", "cpu", "--trace", "poisson",
        "--ttft-slo-s", "1", "--horizon-s", "2"])
    out = io.StringIO()
    with redirect_stdout(out), warnings.catch_warnings(), \
            pytest.raises(SystemExit, match="RuntimeError: kernel fault"):
        warnings.simplefilter("ignore")
        launch_serve.main()
    assert "unhandled 1" in out.getvalue()


def test_launcher_replicas_need_a_trace(monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "yi-6b", "--device", "cpu", "--replicas", "2"])
    with pytest.raises(SystemExit, match="needs --trace"):
        launch_serve.main()


def test_one_shot_is_an_alias_of_legacy():
    assert ServeOptions(prefill_mode="one_shot").prefill_mode == "legacy"
    with pytest.raises(ValueError, match="unknown prefill_mode"):
        ServeOptions(prefill_mode="chunked")


def test_engine_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, _, cfg, tp = _weights("yi-6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, tp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.build_engine(cfg, max_batch=2, cache_len=64,
                                  budget_headroom_bytes=1e6,
                                  latency_goal_s=None)


def test_engine_refuses_params_on_another_device():
    _, _, cfg, tp = _weights("yi-6b")
    tp["embed"] = tp["embed"].to("meta")
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(cfg, tp, device="cpu")


def test_launcher_prints_the_summary_line(monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "yi-6b", "--device", "cpu", "--requests", "3",
        "--max-new-tokens", "3", "--latency-goal-ms", "5"])
    out = io.StringIO()
    with redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        launch_serve.main()
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith("yi-6b-smoke: 3/3 done in ")
    assert "1.00 dispatches/tick" in line and "HBM violations 0" in line


# ---------------------------------------------- dense KV, recurrent archs
DENSE_PROMPTS = (5, 9, 23, 31, 45)
# rwkv6 has d // 64 heads: two at d 128, where plain reduced() gives one
OVERRIDES = {"rwkv6-7b": {"d_model": 128}}


def _greedy(eng, req_cls, prompts, max_new=6):
    eng.prefill_chunk = 16
    stats = _drive(eng, req_cls, prompts, max_new)
    assert len(eng.finished) == len(prompts)
    assert max(st["dispatches"] for st in stats) <= 1
    out = ({r.req_id: list(r.generated) for r in eng.finished}, len(stats),
           eng.model_dispatches, eng.paged)
    eng.close()
    return out


@pytest.mark.parametrize("arch,kv_mode", [("recurrentgemma-9b", "auto"),
                                          ("yi-6b", "dense"),
                                          ("rwkv6-7b", "auto")])
def test_dense_greedy_tokens_match_jax_engine(arch, kv_mode):
    """More requests than slots, so slots are reused (and recurrent state
    restarts): recurrentgemma and rwkv6-7b under default options (packed
    ticks; dense rings and RG-LRU state, WKV state alone), yi-6b with
    dense KV asked for."""
    jcfg, jp, cfg, tp = _weights(arch, **OVERRIDES.get(arch, {}))
    prompts = _prompts(cfg, DENSE_PROMPTS)
    want = _greedy(JServeEngine(jcfg, jp, max_batch=2, cache_len=96,
                                enable_smartconf=False, kv_mode=kv_mode),
                   JRequest, prompts)
    got = _greedy(ServeEngine(cfg, tp, max_batch=2, cache_len=96,
                              enable_smartconf=False, kv_mode=kv_mode,
                              device="cpu"), Request, prompts)
    assert got == want
    assert got[3] is False          # resolved to dense


def test_dense_and_paged_kv_give_the_same_tokens():
    _, _, cfg, tp = _weights("yi-6b")
    prompts = _prompts(cfg, DENSE_PROMPTS)
    outs = [_greedy(ServeEngine(cfg, tp, max_batch=2, cache_len=96,
                                enable_smartconf=False, kv_mode=mode,
                                device="cpu"), Request, prompts)
            for mode in ("dense", "paged")]
    assert outs[0][:3] == outs[1][:3]
    assert [o[3] for o in outs] == [False, True]


def test_paged_kv_refused_for_recurrent_archs():
    _, _, cfg, tp = _weights("recurrentgemma-9b")
    with pytest.raises(ValueError, match="paged KV"):
        ServeEngine(cfg, tp, kv_mode="paged", device="cpu")


def _dense_trajectories(arch):
    """Both engines under a tight HBM goal and a latency goal, with
    ``hbm_bytes`` and decode latency spiked for three ticks: per-tick
    knobs, preemptions, ledger capacity, tokens and violations."""
    jcfg, jp, cfg, tp = _weights(arch, **OVERRIDES.get(arch, {}))
    weights = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                  for x in jax.tree.leaves(jp))
    prompts = _prompts(cfg, (60, 12, 70, 20, 8, 33))
    runs = []
    for eng_cls, req_cls, cfg_, params in ((JServeEngine, JRequest, jcfg, jp),
                                           (ServeEngine, Request, cfg, tp)):
        clock = Clock()
        tick = [0]

        def tap(name, value):
            if not 3 <= tick[0] < 6:
                return value
            return value + {"hbm_bytes": 300_000,
                            "decode_p99_s": 0.05}.get(name, 0)

        kw = {} if eng_cls is JServeEngine else {"device": "cpu"}
        eng = eng_cls(cfg_, params, max_batch=3, cache_len=96,
                      hbm_budget_bytes=weights + 500_000,
                      latency_goal_s=0.01, clock=clock, sensor_tap=tap, **kw)
        knobs = []

        def on_tick(e):
            tick[0] += 1
            knobs.append((e.max_queue_tokens, e.pool.max_blocks,
                          e.prefill_chunk))

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # goal-unreachable notices
            stats = _drive(eng, req_cls, prompts, 8, clock=clock,
                           on_tick=on_tick)
        runs.append(dict(
            knobs=knobs, preemptions=eng.preemptions,
            block_bytes=eng.pool.block_bytes,
            capacity=[st["kv_capacity_blocks"] for st in stats],
            tokens={r.req_id: list(r.generated) for r in eng.finished},
            violations=eng.accountant.violations))
        eng.close()
    jax_run, port_run = runs
    assert port_run == jax_run
    assert len(port_run["tokens"]) == len(prompts)
    for i in range(3):       # every knob moved
        assert len({k[i] for k in port_run["knobs"]}) > 1
    return port_run


def test_dense_smartconf_trajectories_match_jax_engine():
    """recurrentgemma under a tight HBM goal and a latency goal: the three
    knobs follow the JAX engine's trajectories, a spiked ``hbm_bytes``
    reading cuts the dense ledger's budget (no physical resize), and the
    tokens agree."""
    _dense_trajectories("recurrentgemma-9b")


def test_launcher_serves_recurrentgemma_on_cpu(monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "recurrentgemma-9b", "--device", "cpu",
        "--requests", "3", "--max-new-tokens", "3"])
    out = io.StringIO()
    with redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        launch_serve.main()
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith("recurrentgemma-9b-smoke: 3/3 done in ")
    assert "1.00 dispatches/tick" in line and "kv[dense]" in line


@pytest.mark.parametrize("headroom_gb", [1.0, 2.2])
def test_hbm_goal_near_the_weights_admits_like_jax(headroom_gb):
    """recurrentgemma-9b's 20.9 GB of weights with an HBM goal of weights
    plus 1 GB or 2.2 GB, scaled to the reduced model: SmartConf steers to
    0.95 of a hard goal, so at 1 GB both engines pin the queue and KV
    knobs to their floors and admit nothing; at 2.2 GB both serve."""
    jcfg, jp, cfg, tp = _weights("recurrentgemma-9b")
    weights = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                  for x in jax.tree.leaves(jp))
    budget = int(weights * (1 + headroom_gb / 20.89))
    prompts = _prompts(cfg, (20, 20, 20, 20))
    runs = []
    for eng_cls, req_cls, cfg_, params, kw in (
            (JServeEngine, JRequest, jcfg, jp, {}),
            (ServeEngine, Request, cfg, tp, {"device": "cpu"})):
        eng = eng_cls(cfg_, params, max_batch=8, cache_len=96,
                      hbm_budget_bytes=budget, latency_goal_s=0.02,
                      clock=Clock(), **kw)
        for i, p in enumerate(prompts):
            eng.submit(req_cls(i, p, 4))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # goal-unreachable notices
            for _ in range(30):
                eng.tick()
        runs.append((len(eng.finished), eng.max_queue_tokens,
                     eng.pool.max_blocks))
        eng.close()
    assert runs[0] == runs[1]
    if headroom_gb == 1.0:
        assert runs[1] == (0, 0, 1)
    else:
        assert runs[1][0] == len(prompts)


def test_rwkv6_smartconf_trajectories_match_jax_engine():
    """rwkv6-7b under the same goals: no layer holds per-token KV, so the
    dense ledger's blocks weigh 0 bytes and the ``serve.kv_block_budget``
    controller runs with alpha = max(1, 0) = 1, as in the reference; the
    knobs still follow the JAX engine's trajectories."""
    assert _dense_trajectories("rwkv6-7b")["block_bytes"] == 0


def test_launcher_serves_rwkv6_on_cpu(monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "rwkv6-7b", "--device", "cpu", "--requests", "3",
        "--max-new-tokens", "3"])
    out = io.StringIO()
    with redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        launch_serve.main()
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith("rwkv6-7b-smoke: 3/3 done in ")
    assert "1.00 dispatches/tick" in line and "kv[dense]" in line
