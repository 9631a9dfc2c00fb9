"""Alternative controller designs from the paper's §6.4 comparison: the
port of ``src/repro/core/ablations.py``.

These exist to reproduce Figure 7 — they are deliberately *worse* designs:

  * :class:`SinglePoleController` — traditional hard-constraint handling
    (Sironi et al. ThermOS): one conservative pole (0.9 in the paper's
    experiment) plus a virtual goal, but NO context-aware second pole.
  * :class:`NoVirtualGoalController` — SmartConf's two-pole switch but
    targeting the *actual* constraint instead of the virtual goal.

Both reuse :class:`~repro_torch.core.controller.SmartController`
mechanics so the comparison isolates exactly the design choice under study.
"""

from __future__ import annotations

from .controller import ControllerModel, GoalSpec, SmartController

__all__ = ["SinglePoleController", "NoVirtualGoalController"]


class SinglePoleController(SmartController):
    """One conservative pole, never switches to the aggressive pole."""

    def __init__(self, model: ControllerModel, goal: GoalSpec, initial_conf: float,
                 *, pole: float = 0.9, **kwargs) -> None:
        super().__init__(model, goal, initial_conf, **kwargs)
        self.pole = pole
        self.aggressive_pole = pole  # the ablation: no context-aware switch


class NoVirtualGoalController(SmartController):
    """Two-pole control, but targets the real constraint (no safety margin)."""

    def __init__(self, model: ControllerModel, goal: GoalSpec, initial_conf: float,
                 **kwargs) -> None:
        super().__init__(model, goal, initial_conf, **kwargs)
        self.virtual_goal = goal.value  # the ablation: no virtual goal

    def set_goal(self, goal: GoalSpec) -> None:
        self.goal = goal
        self.virtual_goal = goal.value
