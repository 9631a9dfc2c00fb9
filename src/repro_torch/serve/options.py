"""Typed engine configuration: :class:`ServeOptions` and :class:`SLOSpec`.

The same fields, names and defaults as the reference's ``ServeOptions``
for everything the port serves.  Features the port does not serve yet
raise ``NotImplementedError`` naming their ROADMAP item when the options
are built — none is silently ignored.  The port reads no environment
variables: what the reference's ``resolve()`` took from the environment is
passed explicitly (its ``REPRO_PREFILL_MODE`` re-routing of ``auto``
included: no environment variable picks a path), and telemetry is on only
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
    prefix_cache: bool = False
    # block-level sliding-window eviction (all-window archs)
    window_evict: bool = True
    spec_depth: int = 0
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
        unported = (
            (self.prefix_cache, "prefix_cache", "Queue 1 item 6"),
            (self.spec_depth > 0, "spec_depth > 0", "Queue 1 item 6"),
            (self.mesh is not None, "mesh", "Queue 1 item 11"),
        )
        for on, name, item in unported:
            if on:
                raise NotImplementedError(
                    f"ServeOptions {name}: ROADMAP {item} (not ported yet)")
