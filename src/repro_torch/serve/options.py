"""Typed engine configuration: :class:`ServeOptions` and :class:`SLOSpec`.

The same fields, names and defaults as the reference's ``ServeOptions``
for everything the port serves, mesh serving included (``mesh="DxM"``:
one process per mesh position, see ``launch/mesh.py``).  The port reads no
environment variables: what the reference's ``resolve()`` took from the
environment is passed explicitly (its ``REPRO_PREFILL_MODE`` re-routing of
``auto`` and ``REPRO_SPEC_DEPTH`` included: no environment variable picks
a path; ``REPRO_SERVE_MESH`` has no counterpart, so a mesh is always an
explicit request and an infeasible one raises), and telemetry is on only
when a hub is passed (``REPRO_TELEMETRY`` has no counterpart).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable

if TYPE_CHECKING:  # runtime-free: avoid importing telemetry at module load
    from repro_torch.core.telemetry import Telemetry

__all__ = ["SLOSpec", "ServeOptions"]


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Serving-level objectives the engine is *measured* against.

    ``ttft_s`` is the per-request TTFT bound: a finished request only counts
    toward goodput if its own TTFT met it, and the fleet goal the
    ``serve.admit_tier_max`` brownout controller drives is TTFT-p99 <=
    ``ttft_s``.  ``decode_s`` (optional) is the decode-latency p99 goal the
    ``serve.prefill_chunk_tokens`` controller targets.  ``window`` sizes the
    SLO latency sensors: small enough that the controllers see the current
    regime, not a stale mix across a load shift."""

    ttft_s: float
    decode_s: float | None = None
    window: int = 64


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    """Everything configurable about a ``ServeEngine``, in one place."""

    max_batch: int = 4
    cache_len: int = 256
    hbm_budget_bytes: int | None = None
    block_tokens: int = 16
    enable_smartconf: bool = True
    latency_goal_s: float | None = None
    # auto resolves to packed; bucketed and legacy (alias one_shot) are
    # the split paths: prefill, then a decode step, each tick
    prefill_mode: str = "auto"
    # auto resolves to paged on attention-only archs, dense otherwise
    kv_mode: str = "auto"
    slo: SLOSpec | None = None
    num_tiers: int = 3
    admit_tier_max: int | None = None
    # radix prefix cache over refcounted paged blocks (needs paged KV)
    prefix_cache: bool = False
    kv_cache_share: float = 0.5         # cache's share of the block budget
    prefix_hit_rate_goal: float = 0.3   # sc_cache goal (direction="lower")
    # block-level sliding-window eviction (all-window archs)
    window_evict: bool = True
    # self-speculative decode (packed prefill mode only)
    spec_depth: int = 0                 # initial draft depth k; 0 = off
    spec_depth_max: int = 8             # conf_max for sc_spec
    spec_adaptive: bool = True          # sc_spec actuates serve.spec_depth
    accept_rate_goal: float = 0.5       # sc_spec setpoint (direction="lower")
    # "DxM" (data, model) serving mesh, e.g. "2x4"; None = one device
    mesh: str | None = None
    # one engine is one replica: N of them go behind serve.ReplicaRouter
    replicas: int = 1
    # every controller-facing sensor reading passes through this tap
    sensor_tap: Callable[[str, float], float] | None = None
    telemetry: "Telemetry | None" = None

    def __post_init__(self) -> None:
        if self.prefill_mode == "one_shot":
            object.__setattr__(self, "prefill_mode", "legacy")
        if self.prefill_mode not in ("auto", "packed", "bucketed", "legacy"):
            raise ValueError(f"unknown prefill_mode {self.prefill_mode!r}")
        if self.kv_mode not in ("auto", "paged", "dense"):
            raise ValueError(f"unknown kv_mode {self.kv_mode!r}")
        if self.replicas != 1:
            raise ValueError(
                f"ServeOptions replicas={self.replicas}: one engine serves "
                "one replica; put N engines behind serve.ReplicaRouter")
