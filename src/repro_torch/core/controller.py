"""SmartConf feedback controller (paper §5).

Implements the control law of Wang et al., "Understanding and Auto-Adjusting
Performance-Related Configurations":

    model   (Eq. 1):  s_k     = alpha * c_{k-1}
    control (Eq. 2):  c_{k+1} = c_k + (1 - p) / alpha * e_{k+1},   e = s_goal - s

with the paper's PerfConf-specific extensions:

  * automatic pole selection (§5.1):  Delta = 1 + mean_i(3 sigma_i / m_i),
    p = 1 - 2/Delta if Delta > 2 else 0.  (The paper writes ``m'_i`` — the mean
    of performance measured w.r.t. the minimum; we implement the coefficient-of-
    variation reading, consistent with lambda's definition and the 3-sigma /
    99.7% convergence argument.  See DESIGN.md §10.)
  * hard goals (§5.2): virtual goal s~v = (1 - lambda) * s_goal for upper-bound
    constraints (lambda = mean_i(sigma_i / m_i)), plus *context-aware* two-pole
    control — the regular pole inside the safe region and pole 0 (the most
    aggressive stable pole) once the virtual goal is crossed.
  * interaction factor (§5.4): for *super-hard* goals shared by N configs the
    gain becomes (1 - p) / (N * alpha), splitting the error across controllers.

The controller is deliberately tiny: its value is in the synthesis rules, not
in the arithmetic.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Sequence

__all__ = [
    "GoalSpec",
    "ControllerModel",
    "SmartController",
    "fit_model",
    "compute_pole",
    "compute_virtual_goal",
]


@dataclasses.dataclass
class GoalSpec:
    """User-facing goal (paper §4.3): a number plus hard/super-hard flags.

    ``direction`` encodes which side of the goal is safe:
      * ``"upper"`` — performance metric must stay *below* the goal
        (memory consumption, latency).  The overwhelmingly common case.
      * ``"lower"`` — metric must stay *above* the goal (e.g. throughput floor).
    """

    value: float
    hard: bool = False
    super_hard: bool = False
    direction: str = "upper"

    def __post_init__(self) -> None:
        if self.direction not in ("upper", "lower"):
            raise ValueError(f"direction must be 'upper'|'lower', got {self.direction!r}")
        if self.super_hard:
            self.hard = True


@dataclasses.dataclass
class ControllerModel:
    """Profiling artifact (paper §5, Eq. 1): everything the synthesis needs.

    alpha   -- least-squares slope of performance vs configuration (through 0).
    delta   -- multiplicative model-error bound Delta (>= 1).
    lam     -- coefficient of variation lambda (system instability measure).
    conf_min/conf_max -- actuator saturation bounds for the configuration.
    integer -- whether the configuration is integer-typed (paper: >80% are).
    """

    alpha: float
    delta: float = 1.0
    lam: float = 0.0
    conf_min: float = 0.0
    conf_max: float = float("inf")
    integer: bool = True

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(text: str) -> "ControllerModel":
        return ControllerModel(**json.loads(text))


def fit_model(
    conf_values: Sequence[float],
    perf_samples: Sequence[Sequence[float]],
    *,
    conf_min: float = 0.0,
    conf_max: float = float("inf"),
    integer: bool = True,
) -> ControllerModel:
    """Fit Eq. 1 from profiling data (paper §5.5 "Profiling").

    ``conf_values[i]`` is the i-th sampled configuration value and
    ``perf_samples[i]`` the performance measurements observed under it.
    """
    if len(conf_values) != len(perf_samples) or not conf_values:
        raise ValueError("need one non-empty sample list per sampled configuration value")
    means, sigmas = [], []
    for samples in perf_samples:
        samples = list(samples)
        if not samples:
            raise ValueError("empty sample list")
        m = sum(samples) / len(samples)
        var = sum((x - m) ** 2 for x in samples) / max(len(samples) - 1, 1)
        means.append(m)
        sigmas.append(math.sqrt(var))
    # Eq. 1 slope.  The paper writes s = alpha * c (through the origin); Eq. 2
    # only ever uses alpha as the local derivative ds/dc, so we fit the affine
    # regression slope — identical when the data passes through the origin and
    # sign-correct for inversely-related PerfConfs (e.g. MR2820's
    # minspacestart, where *raising* the config *lowers* disk consumption).
    n = len(conf_values)
    c_bar = sum(conf_values) / n
    s_bar = sum(means) / n
    var_c = sum((c - c_bar) ** 2 for c in conf_values)
    if var_c == 0.0:
        # Single sampled configuration value: fall back to through-origin.
        den = sum(c * c for c in conf_values)
        if den == 0.0:
            raise ValueError("all sampled configuration values are zero; cannot fit alpha")
        alpha = sum(c * s for c, s in zip(conf_values, means)) / den
    else:
        alpha = sum((c - c_bar) * (s - s_bar)
                    for c, s in zip(conf_values, means)) / var_c
    if alpha == 0.0:
        raise ValueError("fitted alpha is zero: configuration does not affect the metric")
    # Relative-noise statistics over the sampled operating points.
    cvs = [sg / m for sg, m in zip(sigmas, means) if m > 0]
    lam = sum(cvs) / len(cvs) if cvs else 0.0
    delta = 1.0 + 3.0 * lam  # Delta = 1 + mean(3 sigma_i / m_i)
    return ControllerModel(
        alpha=alpha, delta=delta, lam=lam,
        conf_min=conf_min, conf_max=conf_max, integer=integer,
    )


def compute_pole(delta: float) -> float:
    """Paper §5.1: p = 1 - 2/Delta for Delta > 2, else 0 (guarantees convergence
    whenever the true multiplicative model error is within Delta)."""
    if delta > 2.0:
        return 1.0 - 2.0 / delta
    return 0.0


def compute_virtual_goal(goal: GoalSpec, lam: float) -> float:
    """Paper §5.2: s~v = (1 - lambda) * s~ for upper-bound hard goals; mirrored
    for lower-bound goals.  Soft goals are targeted directly."""
    if not goal.hard:
        return goal.value
    lam = min(max(lam, 0.0), 0.95)  # keep the virtual goal meaningful
    if goal.direction == "upper":
        return (1.0 - lam) * goal.value
    return (1.0 + lam) * goal.value


class SmartController:
    """One synthesized controller for one PerfConf (paper Fig. 1 grey boxes).

    The host-side control loop:

        ctl.observe(measured_perf)          # SmartConf.setPerf
        new_conf = ctl.actuate()            # SmartConf.getConf

    For *indirect* configurations (paper §5.3) the controller is built for the
    deputy variable C'; callers pass ``deputy=`` to :meth:`observe` so Eq. 2
    integrates from the deputy's *actual* value rather than the threshold's.
    """

    def __init__(
        self,
        model: ControllerModel,
        goal: GoalSpec,
        initial_conf: float,
        *,
        n_interacting: int = 1,
    ) -> None:
        self.model = model
        self.goal = goal
        self.pole = compute_pole(model.delta)
        self.aggressive_pole = 0.0
        self.virtual_goal = compute_virtual_goal(goal, model.lam)
        self.n_interacting = max(1, int(n_interacting))
        self._conf = float(initial_conf)
        self._last_perf: float | None = None
        self._deputy: float | None = None
        self.goal_unreachable = False  # best-effort alert (paper §4.3)

    # -- paper API verbs -----------------------------------------------------
    def observe(self, perf: float, deputy: float | None = None) -> None:
        self._last_perf = float(perf)
        self._deputy = None if deputy is None else float(deputy)

    def set_goal(self, goal: GoalSpec) -> None:
        """Runtime goal update (paper §4.3 setGoal)."""
        self.goal = goal
        self.virtual_goal = compute_virtual_goal(goal, self.model.lam)

    def set_interacting(self, n: int) -> None:
        self.n_interacting = max(1, int(n))

    def in_danger(self, perf: float) -> bool:
        """Has the metric crossed the virtual goal into the unsafe region?"""
        if self.goal.direction == "upper":
            return perf > self.virtual_goal
        return perf < self.virtual_goal

    def actuate(self) -> float:
        """Compute c_{k+1} (Eq. 2 + §5.2 two-pole + §5.4 interaction factor)."""
        if self._last_perf is None:
            return self._emit(self._conf)
        perf = self._last_perf
        # Context-aware pole (§5.2): aggressive once past the virtual goal.
        pole = self.pole
        if self.goal.hard and self.in_danger(perf):
            pole = self.aggressive_pole
        error = self.virtual_goal - perf
        gain = (1.0 - pole) / (self.model.alpha * self.n_interacting)
        base = self._deputy if self._deputy is not None else self._conf
        nxt = base + gain * error
        lo, hi = self.model.conf_min, self.model.conf_max
        clipped = min(max(nxt, lo), hi)
        # Best-effort alert: actuator saturated but error says push further.
        self.goal_unreachable = (clipped != nxt)
        return self._emit(clipped)

    def _emit(self, value: float) -> float:
        if self.model.integer:
            value = float(int(round(value)))
            value = min(max(value, self.model.conf_min), self.model.conf_max)
        self._conf = value
        return value

    # -- introspection -------------------------------------------------------
    @property
    def conf(self) -> float:
        return self._conf

    @property
    def last_perf(self) -> float | None:
        return self._last_perf

    def describe(self) -> dict:
        return {
            "alpha": self.model.alpha,
            "delta": self.model.delta,
            "lambda": self.model.lam,
            "pole": self.pole,
            "virtual_goal": self.virtual_goal,
            "goal": dataclasses.asdict(self.goal),
            "conf": self._conf,
            "n_interacting": self.n_interacting,
        }
