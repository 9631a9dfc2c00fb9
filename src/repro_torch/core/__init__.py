"""SmartConf core — the paper's contribution (Wang et al. 2017).

Public API:

  * :class:`SmartConf` / :class:`SmartConfIndirect` / :class:`Transducer` —
    the developer-facing configuration objects (paper §4).
  * :class:`GoalSpec` — user-facing performance goal (value, hard?).
  * :class:`SmartController` + synthesis helpers — the control law (paper §5).
  * ``sensors`` — performance sensors for the framework's own PerfConfs.
"""

from .controller import (
    ControllerModel,
    GoalSpec,
    SmartController,
    compute_pole,
    compute_virtual_goal,
    fit_model,
)
from .smartconf import (
    ConfRegistry,
    GLOBAL_REGISTRY,
    Guardrails,
    SmartConf,
    SmartConfIndirect,
    Transducer,
    parse_goals_file,
    parse_sys_file,
)
from .profiler import ProfileBuffer, read_sysfile, synthesize, write_sysfile
from .sensors import (
    HBMAccountant,
    LatencySensor,
    QueueGauge,
    StepTimer,
    ThroughputSensor,
    device_live_bytes,
)

__all__ = [
    "ControllerModel", "GoalSpec", "SmartController",
    "compute_pole", "compute_virtual_goal", "fit_model",
    "ConfRegistry", "GLOBAL_REGISTRY", "Guardrails", "SmartConf",
    "SmartConfIndirect", "Transducer", "parse_goals_file", "parse_sys_file",
    "ProfileBuffer", "read_sysfile", "synthesize", "write_sysfile",
    "HBMAccountant", "LatencySensor", "QueueGauge", "StepTimer",
    "ThroughputSensor", "device_live_bytes",
]
