"""SmartConf core — the paper's contribution (Wang et al. 2017).

Public API:

  * :class:`SmartConf` / :class:`SmartConfIndirect` / :class:`Transducer` —
    the developer-facing configuration objects (paper §4).
  * :class:`GoalSpec` — user-facing performance goal (value, hard?).
  * :class:`SmartController` + synthesis helpers — the control law (paper §5).
  * ``sensors`` — performance sensors for the framework's own PerfConfs.
  * ``telemetry`` — metrics, Chrome-trace spans, the flight recorder and
    the controllers' decision audit.
  * ``simenv`` — deterministic replicas of the paper's six case studies;
    ``ablations`` — the two worse controller designs of §6.4.
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
from .telemetry import (
    Decision,
    DecisionLog,
    FlightRecorder,
    MetricsRegistry,
    Telemetry,
    Tracer,
)
from .sensors import (
    HBMAccountant,
    LatencySensor,
    QueueGauge,
    StepTimer,
    ThroughputSensor,
    device_live_bytes,
)
from . import ablations, simenv

__all__ = [
    "ControllerModel", "GoalSpec", "SmartController",
    "compute_pole", "compute_virtual_goal", "fit_model",
    "ConfRegistry", "GLOBAL_REGISTRY", "Guardrails", "SmartConf",
    "SmartConfIndirect", "Transducer", "parse_goals_file", "parse_sys_file",
    "ProfileBuffer", "read_sysfile", "synthesize", "write_sysfile",
    "Decision", "DecisionLog", "FlightRecorder", "MetricsRegistry",
    "Telemetry", "Tracer",
    "HBMAccountant", "LatencySensor", "QueueGauge", "StepTimer",
    "ThroughputSensor", "device_live_bytes",
    "ablations", "simenv",
]
