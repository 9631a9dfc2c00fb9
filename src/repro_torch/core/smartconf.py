"""The SmartConf developer API (paper §4, Figs. 2–4).

Developers declare the PerfConf -> metric mapping in a *system file* that is
invisible to users; users state only ``<metric>.goal`` / ``<metric>.goal.hard``
(paper Table 1).  The classes below mirror the paper's Java API:

    SmartConf(conf_name)             # Fig. 3 — direct configurations
        .set_perf(actual)            #   setPerf
        .get_conf()                  #   getConf
        .set_goal(goal)              #   setGoal
    SmartConfIndirect(conf_name, t)  # Fig. 4 — threshold/deputy configurations
        .set_perf(actual, deputy)

camelCase aliases (``setPerf`` etc.) are provided for paper fidelity.

File formats
------------
``SmartConf.sys`` (developer-owned, one line per mapping + initial value):

    serve.max_queue_tokens @ hbm_bytes
    serve.max_queue_tokens = 4096

``<app>.conf`` (user-owned goals):

    hbm_bytes = 15032385536
    hbm_bytes.hard = 1
    hbm_bytes.super_hard = 0

Synthesized model parameters live in ``<ConfName>.smartconf.sys`` (JSON,
written by ``core.profiler``).
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import warnings
from typing import Callable

from .controller import ControllerModel, GoalSpec, SmartController
from . import profiler

__all__ = [
    "Transducer",
    "Guardrails",
    "SmartConf",
    "SmartConfIndirect",
    "ConfRegistry",
    "parse_sys_file",
    "parse_goals_file",
]


@dataclasses.dataclass
class Guardrails:
    """Deployment guardrails wrapped around one PerfConf's control loop.

    The paper's controller assumes honest sensors and a plant that tolerates
    any actuation inside ``[conf_min, conf_max]``.  Production serving breaks
    both assumptions: sensors drop out or return NaN under faults, and a
    controller stepping a knob by 10x in one interval can destabilize the
    system it is meant to protect.  Three guards, all off by default:

    * **Sensor sanity** (``perf_lo`` / ``perf_hi``) — a reading that is
      non-finite or outside the plausible range is *rejected*: it never
      reaches Eq. 2, so one NaN cannot poison the integrator.  Each
      rejection counts in :attr:`SmartConf.sensor_faults`.
    * **Fallback to last-known-good** (``fault_tolerance``) — after this
      many *consecutive* insane readings the sensor is declared failed and
      the configuration pins to the last value computed from a sane reading
      (or the explicit ``fallback`` static setting).  Control resumes, from
      that value, on the first sane reading.
    * **Actuation slew clamp + anti-windup** (``max_step``) — one actuation
      may move the configuration by at most ``max_step`` (absolute, in conf
      units).  The clamped value is written back into the controller state,
      so the error integral never winds up beyond what was actually applied
      (the same back-calculation the actuator bounds already get via
      ``_emit``).  Clamped actuations count in
      :attr:`SmartConf.clamped_actuations`.
    """

    max_step: float | None = None
    perf_lo: float = float("-inf")
    perf_hi: float = float("inf")
    fault_tolerance: int = 3
    fallback: float | None = None

    def sane(self, value: float) -> bool:
        return math.isfinite(value) and self.perf_lo <= value <= self.perf_hi


class Transducer:
    """Maps the controller-desired deputy value to the configuration value
    (paper Fig. 4).  The default is the identity: if we want ``queue.size`` to
    drop to K we drop ``max.queue.size`` to K."""

    def transduce(self, value: float) -> float:
        return value


def parse_sys_file(path: str) -> dict:
    """Parse the developer-owned ``SmartConf.sys`` mapping file."""
    mapping: dict[str, dict] = {}
    with open(path, "r", encoding="utf-8") as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if "@" in line:
                conf, metric = (x.strip() for x in line.split("@", 1))
                mapping.setdefault(conf, {})["metric"] = metric
            elif "=" in line:
                conf, value = (x.strip() for x in line.split("=", 1))
                mapping.setdefault(conf, {})["initial"] = float(value)
    return mapping


def parse_goals_file(path: str) -> dict[str, GoalSpec]:
    """Parse the user-owned goals file into {metric: GoalSpec}."""
    raw: dict[str, dict] = {}
    with open(path, "r", encoding="utf-8") as fh:
        for line_raw in fh:
            line = line_raw.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, value = (x.strip() for x in line.split("=", 1))
            if key.endswith(".hard"):
                raw.setdefault(key[: -len(".hard")], {})["hard"] = value not in ("0", "false", "False")
            elif key.endswith(".super_hard"):
                raw.setdefault(key[: -len(".super_hard")], {})["super_hard"] = value not in ("0", "false", "False")
            elif key.endswith(".direction"):
                raw.setdefault(key[: -len(".direction")], {})["direction"] = value
            else:
                raw.setdefault(key, {})["value"] = float(value)
    goals = {}
    for metric, fields in raw.items():
        if "value" not in fields:
            continue
        goals[metric] = GoalSpec(**fields)
    return goals


class ConfRegistry:
    """Process-wide registry: metric name -> SmartConf objects on that metric.

    Implements §5.4's coordination bookkeeping: when a goal is *super-hard*,
    every controller attached to the metric uses the interaction factor
    N = |configs on metric|, splitting the error evenly."""

    def __init__(self) -> None:
        self._by_metric: dict[str, list["SmartConf"]] = {}
        self._lock = threading.Lock()

    def register(self, conf: "SmartConf") -> None:
        with self._lock:
            peers = self._by_metric.setdefault(conf.metric, [])
            if conf not in peers:
                peers.append(conf)
            self._rebalance(conf.metric)

    def unregister(self, conf: "SmartConf") -> None:
        with self._lock:
            peers = self._by_metric.get(conf.metric, [])
            if conf in peers:
                peers.remove(conf)
            self._rebalance(conf.metric)

    def peers(self, metric: str) -> list["SmartConf"]:
        return list(self._by_metric.get(metric, []))

    def _rebalance(self, metric: str) -> None:
        peers = self._by_metric.get(metric, [])
        n = len(peers)
        for c in peers:
            c._controller.set_interacting(n if c.goal.super_hard else 1)

    def clear(self) -> None:
        with self._lock:
            self._by_metric.clear()


GLOBAL_REGISTRY = ConfRegistry()


class SmartConf:
    """A direct PerfConf under automatic control (paper Fig. 3).

    Parameters
    ----------
    conf_name : str
        The configuration's string name; keys the system file entries.
    sys_dir : str
        Directory holding ``SmartConf.sys`` + per-conf synthesized files.
    metric / goal / initial / model :
        Normally read from the system/goals files; may be passed directly for
        programmatic construction (the framework's own PerfConfs do this).
    profiling : bool
        When True, ``set_perf`` records (conf, perf) samples for synthesis
        instead of assuming a trained model exists (paper §5.5).
    """

    def __init__(
        self,
        conf_name: str,
        sys_dir: str | None = None,
        *,
        metric: str | None = None,
        goal: GoalSpec | None = None,
        initial: float | None = None,
        model: ControllerModel | None = None,
        profiling: bool = False,
        registry: ConfRegistry | None = None,
        guardrails: Guardrails | None = None,
    ) -> None:
        self.conf_name = conf_name
        self.sys_dir = sys_dir
        self.registry = registry if registry is not None else GLOBAL_REGISTRY
        self.profiling = profiling
        self.guardrails = guardrails
        self.sensor_faults = 0           # insane readings rejected, total
        self.clamped_actuations = 0      # slew-clamped get_conf calls
        self._consec_faults = 0
        self._sensor_failed = False
        # telemetry audit trail: a core.telemetry.DecisionLog (or None).
        # set_perf stages the sensor-side facts; the matching get_conf
        # completes the Decision with the actuation-side facts.
        self.audit = None
        self._audit_pending: tuple[float, float | None, bool] | None = None

        # Resolve mapping + initial value from SmartConf.sys when on disk.
        if sys_dir is not None:
            sys_path = os.path.join(sys_dir, "SmartConf.sys")
            if os.path.exists(sys_path):
                entry = parse_sys_file(sys_path).get(conf_name, {})
                metric = metric or entry.get("metric")
                if initial is None and "initial" in entry:
                    initial = entry["initial"]
            goals_path = os.path.join(sys_dir, "goals.conf")
            if goal is None and metric is not None and os.path.exists(goals_path):
                goal = parse_goals_file(goals_path).get(metric)
            if model is None:
                payload = profiler.read_sysfile(sys_dir, conf_name)
                if "model" in payload:
                    model = ControllerModel(**payload["model"])
        if metric is None:
            raise ValueError(f"{conf_name}: no metric mapping (SmartConf.sys entry missing)")
        if goal is None:
            raise ValueError(f"{conf_name}: no goal for metric {metric!r} (user goals file missing)")
        if initial is None:
            initial = 0.0  # paper: initial quality does not matter (Fig. 6c starts at 0)
        self.metric = metric
        self.goal = goal
        if model is None:
            if not profiling:
                raise ValueError(
                    f"{conf_name}: no synthesized model; run with profiling=True first"
                )
            model = ControllerModel(alpha=1.0)  # placeholder during profiling
        self._controller = SmartController(model, goal, initial)
        # last configuration value computed from a sane reading: where the
        # guardrails pin the knob when the sensor is declared failed
        self._last_good_conf = float(initial)
        self._profile_buffer = (
            profiler.ProfileBuffer(sys_dir, conf_name) if (profiling and sys_dir) else None
        )
        self._profile_mem: list[tuple[float, float]] = []
        self.registry.register(self)

    # ------------------------------------------------------------ guardrails
    def _admit_reading(self, actual: float) -> bool:
        """Sensor-sanity gate: True if the reading may reach the controller.
        Insane readings (NaN/inf/out-of-range) are dropped; after
        ``fault_tolerance`` consecutive drops the knob pins to the
        last-known-good value until a sane reading arrives."""
        g = self.guardrails
        if g is None:
            return True
        if not g.sane(float(actual)):
            self.sensor_faults += 1
            self._consec_faults += 1
            if self._consec_faults >= max(1, g.fault_tolerance):
                self._sensor_failed = True
            return False
        if self._sensor_failed:
            # resume control FROM the pinned value, not from wherever the
            # integrator drifted while blind (anti-windup across the outage)
            self._controller._conf = self._pinned_conf()
        self._consec_faults = 0
        self._sensor_failed = False
        return True

    def _pinned_conf(self) -> float:
        g = self.guardrails
        fb = g.fallback if (g is not None and g.fallback is not None) \
            else self._last_good_conf
        lo, hi = self._controller.model.conf_min, self._controller.model.conf_max
        return min(max(float(fb), lo), hi)

    def _apply_guards(self, value: float) -> float:
        g = self.guardrails
        if g is None:
            return value
        if self._sensor_failed:
            return self._pinned_conf()
        if g.max_step is not None:
            prev = self._last_good_conf
            clamped = min(max(value, prev - g.max_step), prev + g.max_step)
            if clamped != value:
                self.clamped_actuations += 1
                # anti-windup: the controller must integrate from the value
                # actually applied, not the one it asked for
                self._controller._conf = clamped
            value = clamped
        self._last_good_conf = float(value)
        return value

    @property
    def sensor_failed(self) -> bool:
        """True while the guardrails hold the knob at last-known-good
        because the sensor keeps returning insane readings."""
        return self._sensor_failed

    # ------------------------------------------------------------- telemetry
    def attach_audit(self, log) -> None:
        """Attach a ``core.telemetry.DecisionLog``; every subsequent
        set_perf/get_conf pair appends one :class:`Decision`."""
        self.audit = log

    def _record_decision(self, raw: float, applied: float, *,
                         clamped: bool) -> None:
        log = self.audit
        if log is None:
            return
        from .telemetry import Decision
        pend = self._audit_pending
        self._audit_pending = None
        sensor, deputy, sane = pend if pend is not None \
            else (float("nan"), None, not self._sensor_failed)
        c = self._controller
        lp = c.last_perf
        log.append(Decision(
            tick=log.tick, conf=self.conf_name, metric=self.metric,
            goal=float(self.goal.value), sensor=float(sensor),
            deputy=None if deputy is None else float(deputy), sane=sane,
            error=float("nan") if lp is None else float(c.virtual_goal - lp),
            raw=float(raw), applied=float(applied), clamped=clamped,
            fallback=self._sensor_failed))

    # ------------------------------------------------------------------ API
    def set_perf(self, actual: float) -> None:
        """Feed the latest performance measurement to the controller."""
        ok = self._admit_reading(actual)
        if self.audit is not None:
            self._audit_pending = (float(actual), None, ok)
        if not ok:
            return
        if self.profiling:
            self._record_sample(self._controller.conf, actual)
        self._controller.observe(actual)

    def get_conf(self) -> float:
        """Compute the adjusted configuration value (Eq. 2 machinery)."""
        clamped_before = self.clamped_actuations
        if self._sensor_failed:
            raw = value = self._pinned_conf()
            self._controller._conf = value
        else:
            raw = self._controller.actuate()
            value = self._apply_guards(raw)
        if self._controller.goal_unreachable:
            warnings.warn(
                f"SmartConf[{self.conf_name}]: goal {self.goal.value} on "
                f"{self.metric} unreachable at actuator bound; making best effort",
                RuntimeWarning,
                stacklevel=2,
            )
        out = int(value) if self._controller.model.integer else value
        if self.audit is not None:
            self._record_decision(
                float(raw), float(out),
                clamped=self.clamped_actuations > clamped_before)
        return out

    def set_goal(self, goal: float | GoalSpec) -> None:
        """Runtime goal update by users/administrators (paper §4.3)."""
        if not isinstance(goal, GoalSpec):
            goal = GoalSpec(value=float(goal), hard=self.goal.hard,
                            super_hard=self.goal.super_hard, direction=self.goal.direction)
        self.goal = goal
        self._controller.set_goal(goal)
        self.registry._rebalance(self.metric)

    # Paper-fidelity camelCase aliases (Fig. 3).
    setPerf = set_perf
    getConf = get_conf
    setGoal = set_goal

    # ------------------------------------------------------------ profiling
    def _record_sample(self, conf_value: float, perf: float) -> None:
        self._profile_mem.append((conf_value, perf))
        if self._profile_buffer is not None:
            self._profile_buffer.record(conf_value, perf)

    def force_conf(self, value: float) -> None:
        """Pin the configuration (used by the profiler to sweep values)."""
        self._controller._conf = float(value)

    def clamp_conf_max(self, value: float) -> None:
        """Shrink the actuation ceiling mid-run (capacity loss: a chaos
        budget cut, a neighbour claiming HBM).  The controller keeps
        running against the smaller range; current and last-known-good
        values are pulled inside it so the next actuation cannot bounce
        back above the new ceiling."""
        model = self._controller.model
        model.conf_max = float(value)
        if self._controller._conf > model.conf_max:
            self._controller._conf = model.conf_max
        if self._last_good_conf > model.conf_max:
            self._last_good_conf = model.conf_max

    def finish_profiling(
        self, *, conf_min: float = 0.0, conf_max: float = float("inf"),
        integer: bool = True, min_samples_per_point: int = 2,
    ) -> ControllerModel:
        """Fit Eq. 1 from recorded samples and swap in the real controller."""
        if self._profile_buffer is not None:
            self._profile_buffer.flush()
            model = profiler.synthesize(
                self.sys_dir, self.conf_name,
                conf_min=conf_min, conf_max=conf_max, integer=integer,
                min_samples_per_point=min_samples_per_point,
            )
        else:
            model = profiler.synthesize(
                self.sys_dir or ".", self.conf_name, samples=self._profile_mem,
                conf_min=conf_min, conf_max=conf_max, integer=integer,
                min_samples_per_point=min_samples_per_point,
            ) if self.sys_dir else None
            if model is None:
                from .controller import fit_model  # in-memory fit
                import collections
                grouped = collections.defaultdict(list)
                for c, p in self._profile_mem:
                    grouped[c].append(p)
                confs = sorted(grouped)
                model = fit_model(confs, [grouped[c] for c in confs],
                                  conf_min=conf_min, conf_max=conf_max, integer=integer)
        current = self._controller.conf
        self._controller = SmartController(
            model, self.goal, current,
            n_interacting=self._controller.n_interacting,
        )
        self.profiling = False
        self.registry._rebalance(self.metric)
        return model

    # -------------------------------------------------------------- helpers
    @property
    def controller(self) -> SmartController:
        return self._controller

    def describe(self) -> dict:
        d = self._controller.describe()
        d.update(conf_name=self.conf_name, metric=self.metric)
        return d

    def close(self) -> None:
        self.registry.unregister(self)


class SmartConfIndirect(SmartConf):
    """Indirect/threshold PerfConf (paper Fig. 4 ``SmartConf_I``).

    The controller runs on the deputy variable C'; ``set_perf`` therefore takes
    the deputy's current value, and ``get_conf`` maps the desired deputy value
    through the transducer to produce the threshold configuration C.
    """

    def __init__(self, conf_name: str, sys_dir: str | None = None,
                 transducer: Transducer | Callable[[float], float] | None = None,
                 **kwargs) -> None:
        super().__init__(conf_name, sys_dir, **kwargs)
        if transducer is None:
            transducer = Transducer()
        if callable(transducer) and not isinstance(transducer, Transducer):
            fn = transducer

            class _Fn(Transducer):
                def transduce(self, value: float) -> float:
                    return fn(value)

            transducer = _Fn()
        self.transducer = transducer

    def set_perf(self, actual: float, deputy: float | None = None) -> None:  # type: ignore[override]
        if deputy is None:
            raise TypeError("SmartConfIndirect.set_perf requires the deputy's current value")
        if not math.isfinite(float(deputy)):
            # a corrupted deputy is a sensor fault even when the metric
            # reading itself is sane: Eq. 2 integrates from the deputy
            self.sensor_faults += 1
            self._consec_faults += 1
            if (self.guardrails is not None and self._consec_faults
                    >= max(1, self.guardrails.fault_tolerance)):
                self._sensor_failed = True
            if self.audit is not None:
                self._audit_pending = (float(actual), float(deputy), False)
            return
        ok = self._admit_reading(actual)
        if self.audit is not None:
            self._audit_pending = (float(actual), float(deputy), ok)
        if not ok:
            return
        if self.profiling:
            # Profile against the deputy: it is what actually drives the metric.
            self._record_sample(deputy, actual)
        self._controller.observe(actual, deputy=deputy)

    def get_conf(self) -> float:  # type: ignore[override]
        desired_deputy = self._controller.actuate()
        value = self.transducer.transduce(desired_deputy)
        if self._controller.model.integer:
            value = int(round(value))
        if self.audit is not None:
            self._record_decision(float(desired_deputy), float(value),
                                  clamped=False)
        return value

    setPerf = set_perf
    getConf = get_conf
