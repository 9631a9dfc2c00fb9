"""Deterministic workload simulator for the paper's six case studies (§6):
the port of ``src/repro/core/simenv.py``.

The paper evaluates SmartConf on live Cassandra/HBase/HDFS/MapReduce clusters.
This module reproduces those six PerfConf issues as discrete-event dynamics so
the controller behaviour (constraint satisfaction, trade-off throughput,
ablations, interacting controllers) is measurable deterministically on the
host — the controller code under test is the one driving the port's serve
and train loops (:mod:`repro_torch.core.smartconf`).  It holds no tensor and
runs on no device.

Each case study implements the paper's Table 6 recipe:
  * a *profiling* workload different from evaluation (``phase = -1``),
  * a two-phase evaluation workload (``phase = 0`` then ``1``) where the
    workload or the goal changes at ``phase_boundary``,
  * at least one phase that triggers the user-reported failure under the
    original default configuration.

Time advances in fixed control intervals (1 simulated second).  All noise is
drawn from a seeded ``numpy.random.Generator`` in the reference's order, so
a run draws the reference's numbers and takes its decisions one for one.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Sequence

import numpy as np

from .controller import GoalSpec, fit_model
from .smartconf import ConfRegistry, SmartConf, SmartConfIndirect

__all__ = [
    "Trace",
    "CaseStudy",
    "CA6059",
    "HB2149",
    "HB3813",
    "HB6728",
    "HD4995",
    "MR2820",
    "ALL_CASES",
    "StaticPolicy",
    "SmartConfPolicy",
    "synthesize",
]

PROFILE_PHASE = -1


@dataclasses.dataclass
class Trace:
    """Result of one evaluation run."""

    t: np.ndarray               # interval index
    metric: np.ndarray          # constrained metric per interval
    conf: np.ndarray            # configuration value per interval
    deputy: np.ndarray          # deputy variable (== conf for direct confs)
    tradeoff: np.ndarray        # per-interval trade-off reward (e.g. ops served)
    goal: np.ndarray            # active goal per interval (may change at phase 2)
    first_violation: int | None # first interval where the goal broke
    violations: int
    hard: bool = True

    @property
    def failed(self) -> bool:
        """Hard goals: any violation is a crash (OOM/OOD).  Soft goals: the
        SLA is broken when the metric does not *track* the goal — steady-state
        mean above 1.05x goal or p95 above 1.25x goal (measured per phase,
        skipping a settling window)."""
        if self.hard:
            return self.first_violation is not None
        n = len(self.t)
        settle = max(10, n // 10)
        half = n // 2
        for lo, hi in ((settle, half), (half + settle, n)):
            m, g = self.metric[lo:hi], self.goal[lo:hi]
            if len(m) == 0:
                continue
            if m.mean() > 1.05 * g.mean() or np.quantile(m, 0.95) > 1.25 * g.mean():
                return True
        return False

    @property
    def total_tradeoff(self) -> float:
        return float(self.tradeoff.sum())


class StaticPolicy:
    """Traditional configuration: one launch-time value, never adjusted."""

    def __init__(self, value: float) -> None:
        self.value = float(value)

    def __call__(self, metric: float, deputy: float, t: int) -> float:
        return self.value


class SmartConfPolicy:
    """Adapter: drives a SmartConf object exactly the way application code
    does — setPerf(actual[, deputy]) then getConf() (paper §4.1.2)."""

    def __init__(self, smartconf, indirect: bool) -> None:
        self.smartconf = smartconf
        self.indirect = indirect

    def __call__(self, metric: float, deputy: float, t: int) -> float:
        if self.indirect:
            self.smartconf.set_perf(metric, deputy)
        else:
            self.smartconf.set_perf(metric)
        return float(self.smartconf.get_conf())


class CaseStudy:
    """Base class.  Subclasses define the dynamics via :meth:`_step`."""

    name: str = "base"
    issue: str = ""
    indirect: bool = False
    conditional: bool = False
    goal: GoalSpec = GoalSpec(1.0, hard=True)
    phase2_goal: GoalSpec | None = None   # for runs where the *goal* changes
    horizon: int = 400
    phase_boundary: int = 200
    conf_grid: Sequence[float] = ()
    buggy_default: float = 0.0
    patched_default: float = 0.0
    conf_min: float = 0.0
    conf_max: float = float("inf")
    integer: bool = True
    metric_name: str = "metric"
    tradeoff_name: str = "throughput"

    # ---- dynamics ----------------------------------------------------------
    def _reset(self, rng: np.random.Generator) -> dict:
        raise NotImplementedError

    def _step(self, state: dict, conf: float, t: int, phase: int,
              rng: np.random.Generator) -> tuple[float, float, float]:
        """Advance one interval.  Returns (metric, deputy, tradeoff_reward)."""
        raise NotImplementedError

    def active(self, t: int, state: dict) -> bool:
        """Conditional PerfConfs only engage their controller on the intervals
        where the configuration actually takes effect (paper §4.2)."""
        return True

    def profile_keep(self, state: dict, t: int) -> bool:
        """Whether this interval's sample is informative for model fitting."""
        return True

    # ---- profiling (paper §5.5) ---------------------------------------------
    def profile(self, conf_values: Sequence[float] | None = None, *,
                intervals: int = 60, seed: int = 0
                ) -> list[tuple[float, float]]:
        """Run the *profiling* workload at a sweep of pinned configuration
        values; returns (deputy-or-conf value, metric) samples."""
        if conf_values is None:
            grid = list(getattr(self, "profile_grid", None) or self.conf_grid)
            step = max(1, len(grid) // 8)
            conf_values = grid[::step]  # 8-point sweep
        rng = np.random.default_rng(seed)
        samples: list[tuple[float, float]] = []
        for cv in conf_values:
            state = self._reset(rng)
            for t in range(intervals):
                metric, deputy, _ = self._step(state, cv, t, PROFILE_PHASE, rng)
                if t >= intervals // 3 and self.profile_keep(state, t):
                    key = deputy if self.indirect else cv
                    samples.append((float(key), float(metric)))
        return samples

    # ---- evaluation -----------------------------------------------------------
    def evaluate(self, policy: Callable[[float, float, int], float], *,
                 seed: int = 1, horizon: int | None = None) -> Trace:
        horizon = horizon or self.horizon
        rng = np.random.default_rng(seed)
        state = self._reset(rng)
        metric_v = np.zeros(horizon)
        conf_v = np.zeros(horizon)
        deputy_v = np.zeros(horizon)
        reward_v = np.zeros(horizon)
        goal_v = np.zeros(horizon)
        first_violation = None
        violations = 0
        conf = getattr(policy, "value", None)
        if conf is None:
            conf = self.initial_conf()
        metric, deputy = 0.0, 0.0
        goal = self.goal
        for t in range(horizon):
            phase = 0 if t < self.phase_boundary else 1
            if phase == 1 and self.phase2_goal is not None and goal is not self.phase2_goal:
                goal = self.phase2_goal
                sc = getattr(policy, "smartconf", None)
                if sc is not None:
                    sc.set_goal(goal)  # runtime goal update (paper §4.3)
            if self.active(t, state):
                conf = policy(metric, deputy, t)
                conf = min(max(conf, self.conf_min), self.conf_max)
                if self.integer:
                    conf = float(int(round(conf)))
            metric, deputy, reward = self._step(state, conf, t, phase, rng)
            violated = (metric > goal.value) if goal.direction == "upper" else (metric < goal.value)
            if violated:
                violations += 1
                if first_violation is None:
                    first_violation = t
            metric_v[t], conf_v[t], deputy_v[t] = metric, conf, deputy
            reward_v[t], goal_v[t] = reward, goal.value
        return Trace(np.arange(horizon), metric_v, conf_v, deputy_v, reward_v,
                     goal_v, first_violation, violations, hard=self.goal.hard)

    def initial_conf(self) -> float:
        return self.conf_min

    # ---- static search (paper §6.3: exhaustive best-static) -----------------
    def best_static(self, *, seed: int = 1) -> tuple[float, Trace]:
        """Exhaustive search for the best launch-time setting that satisfies
        the constraint across BOTH phases — the paper's strongest baseline."""
        best = None
        for cv in self.conf_grid:
            tr = self.evaluate(StaticPolicy(cv), seed=seed)
            if tr.failed:
                continue
            if best is None or tr.total_tradeoff > best[1].total_tradeoff:
                best = (cv, tr)
        if best is None:  # nothing satisfies the constraint; least-bad fallback
            cv = self.conf_grid[0]
            best = (cv, self.evaluate(StaticPolicy(cv), seed=seed))
        return best


class _BurstyQueue(CaseStudy):
    """Shared dynamics for the two HBase RPC-queue issues: a bounded FIFO in
    front of a service whose effective rate grows with queue depth (more
    outstanding RPCs keep more handler threads busy), fed by a *bursty*
    source.  A larger queue absorbs bursts and feeds the handlers (the paper:
    "a larger queue makes a system more responsive to bursty requests at the
    cost of increased memory usage"); a smaller one drops requests.

    The queue tracks items AND bytes: when the workload's item size changes
    (phase 2), in-queue items drain at their enqueue-time size, so memory
    shifts gradually — as in the real HBase run of paper Fig. 6.
    Memory = base(t) + queue_bytes.  The deputy is queue *items* (the unit
    ipc.server.max.queue.size is expressed in)."""

    indirect = True
    goal = GoalSpec(495.0, hard=True)            # MB, paper Fig. 6 red line
    metric_name = "memory_mb"

    base_mem = 200.0
    base_noise_mb = 4.0
    service_rate = 60.0
    depth_knee = 250.0      # items at which handlers are fully utilized
    depth_floor = 0.4       # service fraction at zero depth
    calm_rate = 48.0
    burst_rate = 110.0
    burst_len = 10
    burst_prob = 1.0 / 18.0
    profile_rate = 75.0     # sustained load: fills the queue to each cap

    def _item_mb(self, phase):
        raise NotImplementedError

    def _base(self, t, phase, rng):
        wobble = 0.0
        if phase == PROFILE_PHASE:
            # Profiling runs co-located compactions etc. so the synthesized
            # lambda captures realistic environmental disturbance (§5.5:
            # "the larger the range of workloads, the more robust").
            wobble = 0.4 * self.base_mem * np.sin(t / 7.0)
        return self.base_mem + wobble + self.base_noise_mb * rng.standard_normal()

    def _reset(self, rng):
        return {"items": 0.0, "bytes": 0.0, "burst_left": 0}

    def _step(self, state, conf, t, phase, rng):
        if phase == PROFILE_PHASE:
            rate = self.profile_rate
        else:
            if state["burst_left"] > 0:
                state["burst_left"] -= 1
                rate = self.burst_rate
            else:
                if rng.random() < self.burst_prob:
                    state["burst_left"] = self.burst_len
                rate = self.calm_rate
        arrivals = float(rng.poisson(rate))
        room = max(0.0, conf - state["items"])
        admitted = min(arrivals, room)
        state["items"] += admitted
        state["bytes"] += admitted * self._item_mb(phase, t)
        # OOM strikes at the intra-interval PEAK: measure memory (and the
        # deputy the threshold caps) right after admission, before the
        # handlers drain the queue.
        peak_items = state["items"]
        mem = self._base(t, phase, rng) + state["bytes"]
        depth_util = self.depth_floor + (1.0 - self.depth_floor) * min(
            1.0, state["items"] / self.depth_knee)
        served = min(state["items"],
                     self.service_rate * depth_util
                     * (1.0 + 0.06 * rng.standard_normal()))
        served = max(served, 0.0)
        if state["items"] > 0:
            state["bytes"] = max(0.0, state["bytes"] * (1.0 - served / state["items"]))
        state["items"] -= served
        return mem, peak_items, served


# ---------------------------------------------------------------------------
# HB3813 — ipc.server.max.queue.size (indirect, hard memory).  Paper Fig. 6.
# Profiling: YCSB 0.5W 1MB sustained.  Eval: bursty 1MB -> bursty 2MB.
# ---------------------------------------------------------------------------
class HB3813(_BurstyQueue):
    name = "HB3813"
    issue = "RPC-call queue size: too big -> OOM; too small -> throughput hurts"
    conf_grid = tuple(range(10, 1001, 10))
    buggy_default = 1000.0
    patched_default = 100.0
    conf_min, conf_max = 0.0, 5000.0
    tradeoff_name = "rpcs_served"

    def _item_mb(self, phase, t=0):
        if phase == 1:
            frac = min(1.0, max(0.0, (t - self.phase_boundary) / 20.0))
            return 1.0 + 0.8 * frac
        return 1.0


# ---------------------------------------------------------------------------
# HB6728 — ipc.server.response.queue.maxsize (indirect, hard memory).
# Responses are 2MB at evaluation time (reads of large cells), 1.5MB during
# profiling; phase 2 diverts 30% of capacity to writes (slower drain).
# ---------------------------------------------------------------------------
class HB6728(_BurstyQueue):
    name = "HB6728"
    issue = "RPC-response queue size: too big -> OOM; too small -> throughput hurts"
    conf_grid = tuple(range(10, 801, 10))
    buggy_default = 100000.0      # originally unbounded
    patched_default = 500.0       # patch: 1G bytes ~= 500 x 2MB responses
    conf_min, conf_max = 0.0, 5000.0
    tradeoff_name = "responses_sent"

    base_mem = 180.0
    calm_rate = 40.0
    burst_rate = 110.0
    service_rate = 50.0
    profile_rate = 65.0

    def _item_mb(self, phase, t=0):
        return 1.2 if phase == PROFILE_PHASE else 1.8

    def _step(self, state, conf, t, phase, rng):
        if phase == 1:
            # writes steal service capacity from the response path
            old = self.service_rate
            self.service_rate = old * 0.8
            out = super()._step(state, conf, t, phase, rng)
            self.service_rate = old
            return out
        return super()._step(state, conf, t, phase, rng)


# ---------------------------------------------------------------------------
# CA6059 — memtable_total_space_in_mb (indirect, hard memory).
# Bigger memtables flush less often (each flush start costs a compaction
# stall); phase 2 grows the off-memtable heap (C0.5 read cache warming up).
# ---------------------------------------------------------------------------
class CA6059(CaseStudy):
    name = "CA6059"
    issue = "memtable size cap: too big -> OOM; too small -> write latency hurts"
    indirect = True
    goal = GoalSpec(1024.0, hard=True)   # JVM heap MB
    conf_grid = tuple(range(32, 801, 16))
    buggy_default = 768.0
    patched_default = 256.0   # developers' "conservative setting"
    conf_min, conf_max = 16.0, 2048.0
    metric_name = "heap_mb"
    tradeoff_name = "writes_absorbed"

    flush_rate = 300.0            # MB/interval drained by a running flush
    flush_trigger = 1.0           # flush starts when memtable hits the cap
    flush_penalty = 0.8           # throughput hit on a flush-start interval
    cache_ramp = 30               # intervals for phase-2 heap growth

    def _other_heap(self, phase, t, boundary):
        if phase == PROFILE_PHASE:
            # co-located compaction during profiling: lambda learns disturbance
            return 280.0 * (1.0 + 0.12 * np.sin(t / 9.0))
        if phase == 0:
            return 300.0
        ramp = min(1.0, (t - boundary) / self.cache_ramp)
        return 300.0 + 260.0 * ramp

    def _write_rate(self, phase):
        return {PROFILE_PHASE: 70.0, 0: 140.0, 1: 105.0}[phase]

    def _reset(self, rng):
        return {"memtable": 0.0, "flushing": False}

    def _step(self, state, conf, t, phase, rng):
        writes = max(0.0, self._write_rate(phase) * (1.0 + 0.12 * rng.standard_normal()))
        absorbed = writes
        started_flush = False
        if not state["flushing"] and state["memtable"] >= self.flush_trigger * conf:
            state["flushing"] = True
            started_flush = True
        if state["flushing"]:
            state["memtable"] = max(0.0, state["memtable"] - self.flush_rate)
            if state["memtable"] <= 0.25 * max(conf, 1.0):
                state["flushing"] = False
        if started_flush:
            absorbed = writes * (1.0 - self.flush_penalty)  # compaction stall
        if state["memtable"] >= conf:                       # memtable full
            absorbed = min(absorbed, writes * 0.3)
        state["memtable"] = min(state["memtable"] + absorbed, max(conf, 0.0))
        heap = (self._other_heap(phase, t, self.phase_boundary)
                + 5.0 * rng.standard_normal() + state["memtable"])
        return heap, state["memtable"], absorbed


# ---------------------------------------------------------------------------
# HB2149 — global.memstore.lowerLimit (direct, conditional, soft latency).
# Eval phases share the workload; the latency GOAL tightens 10s -> 5s.
# Each flush blocks writes for conf/flush-rate seconds AND costs a fixed
# stall, so flushing too often (small conf) also destroys throughput.
# ---------------------------------------------------------------------------
class HB2149(CaseStudy):
    name = "HB2149"
    issue = "flush amount: too big -> writes blocked too long; too small -> too often"
    indirect = False
    conditional = True
    goal = GoalSpec(10.0, hard=False)            # worst write-block seconds
    phase2_goal = GoalSpec(5.0, hard=False)      # paper: constraint tightens
    conf_grid = tuple(range(8, 257, 8))          # MB flushed per blocking flush
    buggy_default = 248.0
    patched_default = 144.0
    conf_min, conf_max = 4.0, 512.0
    metric_name = "block_seconds"
    tradeoff_name = "writes_committed"

    flush_mb_per_s = 24.0       # flushing drains this fast while blocking
    fixed_stall = 0.55          # fixed fraction of an interval lost per flush

    def _write_rate(self, phase):
        return 50.0 if phase == PROFILE_PHASE else 100.0

    def _reset(self, rng):
        return {"pending": 0.0, "since_flush": 0, "worst": 0.0, "flushed_now": False}

    def active(self, t, state):
        return state["since_flush"] == 0  # controller consulted at flush points

    def profile_keep(self, state, t):
        return state["flushed_now"]

    def _step(self, state, conf, t, phase, rng):
        writes = max(0.0, self._write_rate(phase) * (1.0 + 0.08 * rng.standard_normal()))
        state["pending"] += writes
        block_s = 0.0
        committed = writes
        state["flushed_now"] = False
        if state["pending"] >= conf * 2.0:  # memstore reached the upper limit
            block_s = (conf / self.flush_mb_per_s) * (1.0 + 0.08 * rng.standard_normal())
            block_s = max(block_s, 0.05)
            state["pending"] = max(0.0, state["pending"] - conf)
            loss = min(1.0, self.fixed_stall + block_s / 30.0)
            committed = writes * (1.0 - loss)
            state["since_flush"] = 0
            state["flushed_now"] = True
        else:
            state["since_flush"] += 1
        # metric: worst-case block latency observed recently (decays slowly)
        state["worst"] = max(block_s, state["worst"] * 0.7)
        return state["worst"], conf, committed


# ---------------------------------------------------------------------------
# HD4995 — content-summary.limit (indirect, conditional, soft latency).
# Profiling: single-thread TestDFSIO (contention 2).  Eval: multi-thread
# (contention 3) in both phases; the latency GOAL tightens 20s -> 10s.
# Small chunks churn the namenode lock (5s amortized re-walk per release).
# ---------------------------------------------------------------------------
class HD4995(CaseStudy):
    name = "HD4995"
    issue = "files traversed per namenode lock: too big -> writes blocked; too small -> du slow"
    indirect = True
    conditional = True
    goal = GoalSpec(20.0, hard=False)         # write-block seconds
    phase2_goal = GoalSpec(10.0, hard=False)
    conf_grid = tuple(range(500, 20001, 250))
    buggy_default = 2_000_000.0   # original hard-coded: traverse everything
    patched_default = 500.0
    conf_min, conf_max = 100.0, 2_000_000.0
    metric_name = "write_block_seconds"
    tradeoff_name = "du_progress_kfiles"

    per_file_ms = 1.0
    lock_reacquire_s = 5.0

    def _contention(self, phase):
        return 2.0 if phase == PROFILE_PHASE else 3.0

    def _reset(self, rng):
        return {"remaining": 2_000_000.0}

    def _step(self, state, conf, t, phase, rng):
        traversed = min(conf, state["remaining"])
        block_s = traversed * self.per_file_ms / 1000.0 * self._contention(phase)
        block_s *= (1.0 + 0.06 * rng.standard_normal())
        block_s = max(block_s, 0.0)
        state["remaining"] -= traversed
        if state["remaining"] <= 0:
            state["remaining"] = 2_000_000.0   # next du command begins
        # du progress per wall-second: traversal amortized over lock churn
        seconds = block_s + self.lock_reacquire_s
        progress = traversed / max(seconds, 1e-6)
        return block_s, traversed, progress / 1000.0


# ---------------------------------------------------------------------------
# MR2820 — local.dir.minspacestart (direct, conditional, hard disk).
# A task spills most of its intermediate data right after starting (sort
# buffers), then trickles the rest; the config is the free-space guard the
# scheduler checks before starting a task.  Profiling: 64MB splits.  Eval:
# 64MB -> 128MB splits (phase 2 needs much more headroom).
# ---------------------------------------------------------------------------
class MR2820(CaseStudy):
    name = "MR2820"
    issue = "min free disk to start task: too small -> OOD; too big -> low utilization"
    indirect = False
    conditional = True
    goal = GoalSpec(1000.0, hard=True)        # disk capacity MB (stay below)
    conf_grid = tuple(range(10, 801, 10))
    profile_grid = tuple(range(120, 751, 70))  # sweep the binding region
    buggy_default = 0.0       # original default: no space check at all
    patched_default = 1.0     # patch: 1MB - still fails
    conf_min, conf_max = 0.0, 1000.0
    metric_name = "disk_used_mb"
    tradeoff_name = "tasks_completed"

    capacity = 1000.0
    tau = 8.0                 # task turnover: spool drains as tasks complete

    def _rate(self, phase):
        # aggregate spill inflow of starting tasks (MB/interval)
        return {PROFILE_PHASE: 70.0, 0: 60.0, 1: 75.0}[phase]

    def _need(self, phase):
        # intermediate bytes per task: phase 2 runs much bigger splits
        return {PROFILE_PHASE: 30.0, 0: 20.0, 1: 44.0}[phase]

    def _base(self, t, phase, rng):
        if phase == PROFILE_PHASE:
            # profiling co-locates HDFS block/log churn: teaches lambda
            base = 500.0 * (1.0 + 0.18 * np.sin(t / 6.0))
        elif phase == 0:
            base = 550.0    # phase 1: disk crowded by input/shuffle data
        else:
            frac = min(1.0, (t - self.phase_boundary) / 15.0)
            base = 550.0 - 100.0 * frac   # phase 2: less input, bigger spills
        return base + 8.0 * rng.standard_normal()

    def _reset(self, rng):
        return {"spool": 0.0, "gate": True}

    def active(self, t, state):
        return state["gate"]  # consulted at scheduling points only

    def _step(self, state, conf, t, phase, rng):
        base = self._base(t, phase, rng)
        used = base + state["spool"]
        free = self.capacity - used
        # Scheduler: start tasks this interval iff free space clears the guard.
        state["gate"] = free >= conf
        inflow = self._rate(phase) * (1.0 + 0.06 * rng.standard_normal()) if state["gate"] else 0.0
        drained = state["spool"] / self.tau
        state["spool"] = max(0.0, state["spool"] + inflow - drained)
        used = base + state["spool"]
        completions = drained / self._need(phase)
        return used, conf, float(completions)


ALL_CASES: dict[str, type[CaseStudy]] = {
    c.name: c for c in (CA6059, HB2149, HB3813, HB6728, HD4995, MR2820)
}


def synthesize(env: CaseStudy, controller_cls=None):
    """Profile -> fit Eq. 1 -> a SmartConf policy for ``env`` (paper §5.5),
    the recipe the reference's case-study tests and Figure 7 benchmark
    follow: samples from ``profile(seed=0)``, binned into 16 where more
    than 24 values came up, fitted with ``fit_model``.
    ``controller_cls(model, goal, initial)`` swaps the controller (the
    ablations).  Returns ``(policy, model)``."""
    samples = env.profile(seed=0)
    grouped = collections.defaultdict(list)
    vals = sorted(set(c for c, _ in samples))
    if len(vals) > 24:
        lo, hi = min(vals), max(vals)
        width = (hi - lo) / 16 or 1.0
        for c, p in samples:
            grouped[lo + (int((c - lo) / width) + 0.5) * width].append(p)
    else:
        for c, p in samples:
            grouped[c].append(p)
    confs = sorted(grouped)
    model = fit_model(confs, [grouped[c] for c in confs],
                      conf_min=env.conf_min, conf_max=env.conf_max,
                      integer=env.integer)
    cls = SmartConfIndirect if env.indirect else SmartConf
    sc = cls(f"case.{env.name}", metric=env.metric_name, goal=env.goal,
             initial=env.initial_conf(), model=model,
             registry=ConfRegistry())
    if controller_cls is not None:
        sc._controller = controller_cls(model, env.goal, env.initial_conf())
    return SmartConfPolicy(sc, env.indirect), model
