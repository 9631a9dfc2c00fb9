"""Open-loop multi-tenant traffic for the serving engine.

Closed-loop load generators (N clients, think time) self-throttle under
overload: when the server slows down, the offered load drops with it, and
tail latency looks artificially healthy.  Real serving traffic is
*open-loop* — arrivals keep coming at the trace rate whether or not the
server keeps up — which is exactly the regime where SmartConf's
SLO-actuated admission control (``serve.admit_tier_max``) has to earn its
keep.

This module provides:

* :func:`synthesize_trace` — deterministic arrival traces from a seeded
  RNG: homogeneous Poisson, bursty (on/off modulated Poisson) and diurnal
  (sinusoidal rate) processes, with heavy-tailed (bounded-Pareto) prompt
  and output lengths and multi-tenant priority tiers carrying per-tier
  deadlines.
* :class:`VirtualClock` — the injected clock that makes the whole
  harness deterministic: the driver owns time, the engine just reads it.
* :class:`OpenLoopDriver` — replays a trace against a
  :class:`~repro_torch.serve.engine.ServeEngine` on the virtual clock.  Because
  the clock is frozen *within* a tick, the driver charges each tick with
  a simple cost model (base + per-prefill-lane + per-decode-token
  seconds) and records that cost into the engine's latency sensors so the
  SmartConf controllers observe the same virtual time the requests do.

Everything is seeded; two runs with the same config produce bit-identical
traces and tick sequences.  The port's copy draws from the same numpy
generators in the same order as the reference's, so one ``TraceConfig``
gives the same events and prompt tokens in both packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

from .engine import Request, ServeEngine

__all__ = [
    "TierSpec",
    "TraceConfig",
    "TraceEvent",
    "VirtualClock",
    "synthesize_trace",
    "concat_traces",
    "as_requests",
    "OpenLoopDriver",
]


# --------------------------------------------------------------------------
# trace synthesis
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One tenant class.  ``share`` is the fraction of arrivals; tiers are
    shed highest-``tier``-number first under brownout (0 = most important).
    ``deadline_s`` is the end-to-end completion deadline stamped on each
    request of this tier (``None`` = no deadline)."""

    tier: int
    share: float
    deadline_s: float | None = None


DEFAULT_TIERS = (
    TierSpec(0, 0.25, deadline_s=30.0),   # interactive / paid
    TierSpec(1, 0.35, deadline_s=60.0),   # standard
    TierSpec(2, 0.40, deadline_s=None),   # batch / best-effort
)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Arrival-process + workload-shape parameters for one trace."""

    process: str = "poisson"        # "poisson" | "bursty" | "diurnal"
    rate_rps: float = 20.0          # mean arrival rate (requests/s)
    horizon_s: float = 10.0
    seed: int = 0
    t_start: float = 0.0
    # bursty: on/off modulated Poisson.  During the "on" fraction of each
    # period the rate is ``burst_factor`` x the off rate; the mean over a
    # full period equals ``rate_rps``.
    burst_factor: float = 6.0
    burst_period_s: float = 4.0
    burst_duty: float = 0.25
    # diurnal: rate(t) = rate_rps * (1 + amplitude * sin(2 pi t / period))
    diurnal_period_s: float = 10.0
    diurnal_amplitude: float = 0.8
    # heavy-tailed lengths: bounded Pareto on [lo, hi], tail index `alpha`
    # (smaller alpha = heavier tail).
    prompt_lo: int = 4
    prompt_hi: int = 48
    prompt_alpha: float = 1.3
    new_lo: int = 2
    new_hi: int = 16
    new_alpha: float = 1.6
    tiers: tuple[TierSpec, ...] = DEFAULT_TIERS
    # shared-prefix tenancy (system prompts / few-shot preambles): a
    # ``prefix_share`` fraction of arrivals is assigned to one of
    # ``prefix_groups`` groups; every request in a group opens with the
    # same ``prefix_len`` tokens (materialised deterministically per
    # (seed, group) in :func:`as_requests`) — the workload the engine's
    # radix prefix cache exists for.  0 groups (default) disables it.
    prefix_groups: int = 0
    prefix_len: int = 0
    prefix_share: float = 1.0


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One arrival: absolute virtual time + the workload shape."""

    t: float
    req_id: int
    tier: int
    deadline_s: float | None
    prompt_len: int
    max_new_tokens: int
    # shared-prefix group this arrival belongs to (-1 = none); its prompt's
    # first ``prefix_len`` tokens are the group's common preamble
    prefix_group: int = -1
    prefix_len: int = 0


def _rate_at(cfg: TraceConfig, t: float) -> float:
    if cfg.process == "poisson":
        return cfg.rate_rps
    if cfg.process == "bursty":
        duty = min(max(cfg.burst_duty, 1e-6), 1.0)
        # mean = duty * on + (1 - duty) * off = rate_rps, on = factor * off
        off = cfg.rate_rps / (duty * cfg.burst_factor + (1.0 - duty))
        phase = (t % cfg.burst_period_s) / cfg.burst_period_s
        return cfg.burst_factor * off if phase < duty else off
    if cfg.process == "diurnal":
        amp = min(max(cfg.diurnal_amplitude, 0.0), 1.0)
        return cfg.rate_rps * (
            1.0 + amp * math.sin(2.0 * math.pi * t / cfg.diurnal_period_s))
    raise ValueError(f"unknown arrival process: {cfg.process!r}")


def _peak_rate(cfg: TraceConfig) -> float:
    if cfg.process == "bursty":
        duty = min(max(cfg.burst_duty, 1e-6), 1.0)
        off = cfg.rate_rps / (duty * cfg.burst_factor + (1.0 - duty))
        return cfg.burst_factor * off
    if cfg.process == "diurnal":
        return cfg.rate_rps * (1.0 + min(max(cfg.diurnal_amplitude, 0.0), 1.0))
    return cfg.rate_rps


def _bounded_pareto(rng: np.random.Generator, lo: int, hi: int,
                    alpha: float, n: int) -> np.ndarray:
    """Inverse-CDF sampling of a Pareto truncated to [lo, hi]."""
    lo_f, hi_f = float(lo), float(max(hi, lo + 1))
    u = rng.uniform(size=n)
    ratio = (lo_f / hi_f) ** alpha
    x = lo_f / (1.0 - u * (1.0 - ratio)) ** (1.0 / alpha)
    return np.clip(x.astype(np.int64), lo, hi)


def synthesize_trace(cfg: TraceConfig) -> list[TraceEvent]:
    """Deterministic non-homogeneous Poisson trace via thinning."""
    rng = np.random.default_rng(cfg.seed)
    peak = max(_peak_rate(cfg), 1e-9)
    shares = np.asarray([t.share for t in cfg.tiers], dtype=np.float64)
    shares = shares / shares.sum()

    times: list[float] = []
    t = cfg.t_start
    end = cfg.t_start + cfg.horizon_s
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= end:
            break
        if rng.uniform() * peak <= _rate_at(cfg, t - cfg.t_start):
            times.append(t)

    n = len(times)
    tier_idx = rng.choice(len(cfg.tiers), size=n, p=shares) if n else []
    plens = _bounded_pareto(rng, cfg.prompt_lo, cfg.prompt_hi,
                            cfg.prompt_alpha, n)
    nlens = _bounded_pareto(rng, cfg.new_lo, cfg.new_hi, cfg.new_alpha, n)
    groups = np.full(n, -1, np.int64)
    if cfg.prefix_groups > 0 and cfg.prefix_len > 0 and n:
        mask = rng.uniform(size=n) < cfg.prefix_share
        groups[mask] = rng.choice(cfg.prefix_groups, size=int(mask.sum()))
        # a grouped prompt must extend past its preamble by at least one
        # token (the engine always prefills >= 1 token to sample from)
        plens = np.where(groups >= 0,
                         np.maximum(plens, cfg.prefix_len + 1), plens)

    events = []
    for i, ti in enumerate(times):
        spec = cfg.tiers[int(tier_idx[i])]
        grp = int(groups[i])
        events.append(TraceEvent(
            t=ti, req_id=i, tier=spec.tier, deadline_s=spec.deadline_s,
            prompt_len=int(plens[i]), max_new_tokens=int(nlens[i]),
            prefix_group=grp, prefix_len=cfg.prefix_len if grp >= 0 else 0))
    return events


def concat_traces(*segments: Sequence[TraceEvent]) -> list[TraceEvent]:
    """Merge trace segments into one time-sorted trace with globally unique
    request ids.  Build each segment with its own :class:`TraceConfig`
    (offset via ``t_start``) to model a *regime shift* — e.g. a calm
    morning phase followed by a sustained storm — which is the workload a
    static configuration provably cannot match on both sides."""
    events = sorted((e for seg in segments for e in seg), key=lambda e: e.t)
    return [dataclasses.replace(e, req_id=i) for i, e in enumerate(events)]


def as_requests(events: Sequence[TraceEvent], *, vocab: int,
                seed: int = 0, id_base: int = 0,
                ) -> list[tuple[float, Request]]:
    """Materialise trace events into (arrival_time, Request) pairs with
    random token ids.  Token 0 (EOS in the toy tokenizer) is excluded so
    generation length is governed by ``max_new_tokens``, not luck.
    Shared-prefix events (``prefix_group >= 0``) open with their group's
    preamble, generated once per (seed, group) — every member of a group
    carries bit-identical leading tokens across the whole trace."""
    rng = np.random.default_rng(seed)
    prefixes: dict[int, np.ndarray] = {}
    out = []
    for ev in events:
        if ev.prefix_group >= 0 and 0 < ev.prefix_len < ev.prompt_len:
            pre = prefixes.get(ev.prefix_group)
            if pre is None:
                grng = np.random.default_rng((seed, ev.prefix_group))
                pre = grng.integers(1, vocab, size=ev.prefix_len,
                                    dtype=np.int32)
                prefixes[ev.prefix_group] = pre
            tail = rng.integers(1, vocab, size=ev.prompt_len - ev.prefix_len,
                                dtype=np.int32)
            toks = np.concatenate([pre, tail])
        else:
            toks = rng.integers(1, vocab, size=ev.prompt_len, dtype=np.int32)
        out.append((ev.t, Request(
            req_id=id_base + ev.req_id, prompt=toks,
            max_new_tokens=ev.max_new_tokens, tier=ev.tier,
            deadline_s=ev.deadline_s)))
    return out


# --------------------------------------------------------------------------
# virtual time
# --------------------------------------------------------------------------

class VirtualClock:
    """A clock the driver advances explicitly.  Inject as
    ``ServeEngine(..., clock=vc)`` — within one ``tick()`` the reading is
    constant, so all intra-tick latency spans the engine measures are 0;
    the driver charges tick cost afterwards (see :class:`OpenLoopDriver`)."""

    def __init__(self, start: float = 0.0) -> None:
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += float(dt)
        return self.now


@dataclasses.dataclass(frozen=True)
class TickCostModel:
    """Virtual seconds charged per engine tick.  Prefill is charged per
    *issued* lane slot (padding costs compute too); decode per decoding
    SLOT (the KV-read unit: with speculation one slot can emit several
    tokens per dispatch, but reads its history once), plus a cheap
    per-draft-lane verify charge — this is what makes speculation's
    economics real in virtual time: accepted drafts amortize the slot
    cost, rejected ones still pay their verify lanes."""

    base_s: float = 2e-3
    prefill_token_s: float = 5e-5
    decode_token_s: float = 8e-4
    spec_lane_s: float = 1e-4

    def cost(self, stats: dict) -> float:
        issued = stats.get("prefill_issued_tokens", stats.get(
            "prefill_tokens", 0))
        # decode_slots fell out of the frozen stats schema only with the
        # speculation PR; older dicts fall back to decode_tokens (equal
        # whenever speculation is off)
        slots = stats.get("decode_slots", stats.get("decode_tokens", 0))
        return (self.base_s
                + self.prefill_token_s * float(issued)
                + self.decode_token_s * float(slots)
                + self.spec_lane_s * float(stats.get("spec_lanes", 0)))


# --------------------------------------------------------------------------
# open-loop driver
# --------------------------------------------------------------------------

class OpenLoopDriver:
    """Replays an arrival list against a ServeEngine on a VirtualClock.

    Per tick: submit every arrival whose time is due, fire the chaos hook
    (if any), run ``engine.tick()``, advance the clock by the tick cost
    model (+ any chaos slow-tick penalty), and feed the cost into the
    engine's ``tick_latency`` / ``decode_latency`` sensors so SmartConf's
    ``decode_p99_s`` goal reads virtual — not wall-clock — time.

    Exceptions escaping ``engine.tick()`` are caught, counted in
    ``unhandled`` and abort the run; the SLO bench gates on this count
    being zero.
    """

    def __init__(self, engine: ServeEngine,
                 arrivals: Sequence[tuple[float, Request]], *,
                 clock: VirtualClock,
                 cost: TickCostModel | None = None,
                 chaos: "Callable[[OpenLoopDriver, int], float] | None" = None,
                 drain_s: float = 120.0,
                 max_ticks: int = 200_000) -> None:
        self.engine = engine
        self.arrivals = sorted(arrivals, key=lambda p: p[0])
        self.clock = clock
        self.cost = cost or TickCostModel()
        self.chaos = chaos
        self.drain_s = float(drain_s)
        self.max_ticks = int(max_ticks)
        self.ticks = 0
        self.submitted = 0
        self.unhandled: list[str] = []

    # -- helpers -----------------------------------------------------------

    def _engine_busy(self) -> bool:
        eng = self.engine
        return bool(eng.waiting or eng.queued or eng.prefilling or eng.running)

    def _submit_due(self) -> None:
        while (self.submitted < len(self.arrivals)
               and self.arrivals[self.submitted][0] <= self.clock.now):
            req = self.arrivals[self.submitted][1]
            # stamp the arrival on the trace timeline (and open the
            # request's lifetime span) BEFORE submit, so a door rejection's
            # span-close has its matching open
            self.engine.note_arrival(req)
            self.engine.submit(req)
            self.submitted += 1

    # -- main loop ---------------------------------------------------------

    def run(self) -> dict:
        eng = self.engine
        t0 = self.clock.now
        last_t = self.arrivals[-1][0] if self.arrivals else t0
        t_stop = last_t + self.drain_s

        while self.ticks < self.max_ticks:
            if self.submitted < len(self.arrivals):
                # jump idle gaps between arrivals
                nxt = self.arrivals[self.submitted][0]
                if not self._engine_busy() and nxt > self.clock.now:
                    self.clock.advance(nxt - self.clock.now)
                self._submit_due()
            elif not self._engine_busy():
                break   # trace exhausted and engine idle: done
            if self.clock.now > t_stop:
                break   # bounded drain (livelock / stuck-preemption guard)

            extra_s = 0.0
            if self.chaos is not None:
                extra_s = float(self.chaos(self, self.ticks) or 0.0)
            try:
                stats = eng.tick()
            except Exception as exc:  # noqa: BLE001 - the whole point
                self.unhandled.append(f"{type(exc).__name__}: {exc}")
                break
            dt = self.cost.cost(stats) + extra_s
            self.clock.advance(dt)
            # intra-tick spans were 0 on the frozen clock; charge them now
            # so the controllers' decode_p99_s sensor (and the telemetry
            # latency histograms) see virtual time.
            eng.charge_tick_cost(dt,
                                 decoded=bool(stats.get("decode_tokens", 0)))
            self.ticks += 1

        return self.summary(elapsed_s=self.clock.now - t0)

    # -- reporting ---------------------------------------------------------

    def summary(self, *, elapsed_s: float) -> dict:
        eng = self.engine
        elapsed = max(elapsed_s, 1e-9)
        by_tier_good: dict[int, int] = {}
        by_tier_fin: dict[int, int] = {}
        for req in eng.finished:
            toks = len(req.generated)
            by_tier_fin[req.tier] = by_tier_fin.get(req.tier, 0) + toks
            if req.slo_ok:
                by_tier_good[req.tier] = by_tier_good.get(req.tier, 0) + toks
        total_tokens = eng.slo_good_tokens + eng.slo_miss_tokens
        return {
            "ticks": self.ticks,
            "elapsed_s": elapsed,
            "submitted": self.submitted,
            "finished": len(eng.finished),
            "rejected": eng.rejected,
            "reject_counts": {str(k): v for k, v in eng.reject_counts.items()},
            "preemptions": eng.preemptions,
            "recompute_tokens": eng.recompute_tokens,
            "slo_good_requests": eng.slo_good_requests,
            "slo_miss_requests": eng.slo_miss_requests,
            "slo_good_tokens": eng.slo_good_tokens,
            "slo_miss_tokens": eng.slo_miss_tokens,
            "goodput_tps": eng.slo_good_tokens / elapsed,
            "throughput_tps": total_tokens / elapsed,
            "goodput_tokens_by_tier": by_tier_good,
            "finished_tokens_by_tier": by_tier_fin,
            "admit_tier_max": eng.admit_tier_max,
            "unhandled": list(self.unhandled),
        }
