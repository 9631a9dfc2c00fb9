"""Fault injection for the serving engine (chaos harness).

Four fault families, all deterministic from a seed and a tick schedule:

* **slow ticks** — random ticks cost extra virtual seconds (a straggler
  device, a GC pause).  Latency sensors see the spike; controllers must
  react without oscillating.
* **budget cuts** — ``serve.kv_block_budget`` is slashed mid-run (a
  co-tenant claimed the HBM).  On SmartConf engines the cut shrinks the
  controller's actuation ceiling (:meth:`SmartConf.clamp_conf_max`), so
  the knob cannot bounce back above physical capacity; on static engines
  it is applied directly via :meth:`ServeEngine.set_kv_budget`.
* **sensor faults** — controller-facing sensor reads return NaN, a
  physically impossible spike, or zero for a window of ticks
  (installed as ``engine.sensor_tap``).  The SmartConf guardrails must
  absorb these: an unguarded controller crashes on ``int(nan)``.
* **worker preemption** — :class:`PreemptionHandler` is triggered, the
  engine must drain (requeue in-flight work, refuse new submissions with
  a typed reason), and resume cleanly when the flag clears.

A :class:`ChaosMonkey` is both the driver tick-hook (``__call__`` returns
extra virtual seconds) and the sensor tap; ``install(engine)`` wires both.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .engine import ServeEngine

__all__ = ["ChaosSpec", "ChaosMonkey"]


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Tick-indexed fault schedule.  ``None`` disables a fault family."""

    seed: int = 0
    # slow ticks: each tick independently pays +slow_tick_s with this prob
    slow_tick_prob: float = 0.0
    slow_tick_s: float = 0.05
    # mid-run KV budget cut (fraction of the budget at cut time), with
    # optional restore later
    budget_cut_tick: int | None = None
    budget_cut_frac: float = 0.5
    budget_restore_tick: int | None = None
    # sensor fault window [tick, tick + ticks): taps named sensors
    sensor_fault_tick: int | None = None
    sensor_fault_ticks: int = 8
    sensor_fault_mode: str = "nan"          # "nan" | "spike" | "dropout"
    sensor_names: tuple[str, ...] = ("decode_p99_s", "ttft_p99_s")
    # worker preemption: trigger at tick, clear `resume_ticks` later
    preempt_tick: int | None = None
    preempt_resume_ticks: int = 3


class ChaosMonkey:
    """Executes a :class:`ChaosSpec` against one engine.

    Use as the :class:`~repro_torch.serve.traffic.OpenLoopDriver` chaos hook::

        monkey = ChaosMonkey(spec).install(engine)
        driver = OpenLoopDriver(engine, arrivals, clock=vc, chaos=monkey)

    ``events`` records every injected fault as ``(tick, name)`` so tests
    and the bench can assert the schedule actually fired.
    """

    def __init__(self, spec: ChaosSpec) -> None:
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed)
        self.engine: ServeEngine | None = None
        self.events: list[tuple[int, str]] = []
        self._tick = -1
        self._orig_budget: int | None = None
        self._orig_cap: float | None = None

    # -- wiring ------------------------------------------------------------

    def install(self, engine: ServeEngine) -> "ChaosMonkey":
        self.engine = engine
        engine.sensor_tap = self._tap
        return self

    def _note(self, name: str) -> None:
        """Record an injected fault — in ``events`` for the benches, and
        on the engine's telemetry trace (instant marker + flight-recorder
        dump) so fault <-> controller-response causality is visible in
        one timeline."""
        self.events.append((self._tick, name))
        if self.engine is not None:
            self.engine.note_chaos(name)

    # -- sensor corruption -------------------------------------------------

    def _fault_window_active(self) -> bool:
        s = self.spec
        return (s.sensor_fault_tick is not None
                and s.sensor_fault_tick <= self._tick
                < s.sensor_fault_tick + s.sensor_fault_ticks)

    def _tap(self, name: str, value: float) -> float:
        if not self._fault_window_active() or name not in self.spec.sensor_names:
            return value
        self._note(f"sensor_{self.spec.sensor_fault_mode}:{name}")
        if self.spec.sensor_fault_mode == "nan":
            return math.nan
        if self.spec.sensor_fault_mode == "spike":
            return 1e12                      # physically impossible reading
        if self.spec.sensor_fault_mode == "dropout":
            return 0.0
        raise ValueError(
            f"unknown sensor_fault_mode: {self.spec.sensor_fault_mode!r}")

    # -- budget cuts -------------------------------------------------------

    def _cut_budget(self, eng: ServeEngine) -> None:
        blocks = max(1, int(eng.pool.max_blocks * self.spec.budget_cut_frac))
        self._orig_budget = eng.pool.max_blocks
        if eng.sc_kv is not None:
            self._orig_cap = float(eng.sc_kv.controller.model.conf_max)
            eng.sc_kv.clamp_conf_max(float(blocks))
        eng.set_kv_budget(blocks)
        self._note(f"budget_cut:{blocks}")

    def _restore_budget(self, eng: ServeEngine) -> None:
        if self._orig_budget is None:
            return
        if eng.sc_kv is not None and self._orig_cap is not None:
            eng.sc_kv.clamp_conf_max(self._orig_cap)
        else:
            eng.set_kv_budget(self._orig_budget)
        self._note("budget_restore")

    # -- driver hook -------------------------------------------------------

    def __call__(self, driver, tick: int) -> float:
        eng = self.engine if self.engine is not None else driver.engine
        if self.engine is None:
            self.install(eng)
        self._tick = tick
        s = self.spec

        if s.budget_cut_tick is not None and tick == s.budget_cut_tick:
            self._cut_budget(eng)
        if s.budget_restore_tick is not None and tick == s.budget_restore_tick:
            self._restore_budget(eng)

        if s.preempt_tick is not None:
            if tick == s.preempt_tick:
                eng.preemption.trigger()
                self._note("preempt")
            elif tick == s.preempt_tick + s.preempt_resume_ticks:
                eng.preemption.reset()
                self._note("resume")

        extra = 0.0
        if s.slow_tick_prob > 0.0 and self.rng.uniform() < s.slow_tick_prob:
            extra = s.slow_tick_s
            self._note("slow_tick")
        return extra
