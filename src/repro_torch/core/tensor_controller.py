"""The twin of ``src/repro/core/jax_controller.py``: the SmartConf control
law on tensors, for controllers that live beside the device work.

The host-side ``SmartController`` steps one controller at a time in
Python; this module gives its functional twin over f32 tensors, on the
device of its inputs (CUDA by default for :func:`make_spec`):

  * :class:`ControllerSpec` / :class:`ControllerState` are NamedTuples of
    tensors, so a batch of heterogeneous controllers is one stacked spec
    (:func:`stack_specs`).
  * :func:`controller_step` is Eq. 2 plus the two-pole hard-goal switch,
    built from ``torch.where`` (branchless, so it runs on a whole batch).
  * :func:`coordinated_step` is §5.4's interaction protocol for a batch of
    controllers sharing metrics: N is recomputed on the fly from the
    metric ids, so adding or removing controllers needs no re-synthesis.
  * :func:`sharded_coordinated_step` runs controllers spread over a mesh
    axis of processes (:mod:`repro_torch.launch.mesh`): each rank holds a
    slice of the batch, and the per-metric counts are summed by an
    all-reduce over the axis (the reference's ``jax.lax.psum``).

Everything here is pure; state threading is the caller's business.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .controller import (ControllerModel, GoalSpec, compute_pole,
                         compute_virtual_goal)

__all__ = [
    "ControllerSpec",
    "ControllerState",
    "make_spec",
    "stack_specs",
    "init_state",
    "controller_step",
    "indirect_controller_step",
    "interaction_counts",
    "coordinated_step",
    "sharded_coordinated_step",
]

F32 = torch.float32


class ControllerSpec(NamedTuple):
    """Static-per-controller parameters, stored as tensors so a batch of
    heterogeneous controllers is just a stacked spec."""

    alpha: torch.Tensor          # Eq. 1 slope
    pole: torch.Tensor           # regular pole (§5.1)
    goal: torch.Tensor           # user goal value
    virtual_goal: torch.Tensor   # (1 - lambda) * goal for hard upper goals
    hard: torch.Tensor           # bool: two-pole mode enabled
    direction: torch.Tensor      # +1: metric must stay below goal; -1: above
    conf_min: torch.Tensor
    conf_max: torch.Tensor
    metric_id: torch.Tensor      # int32 id of the controlled metric (§5.4)
    super_hard: torch.Tensor     # bool: split gain across interacting ones


class ControllerState(NamedTuple):
    conf: torch.Tensor


def _device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu'")
    return device


def make_spec(model: ControllerModel, goal: GoalSpec, *, metric_id: int = 0,
              device=None) -> ControllerSpec:
    """A single controller's spec from the host-side synthesis artifacts,
    on ``device`` (default CUDA)."""
    dev = _device(device)

    def f32(v):
        return torch.tensor(v, dtype=F32, device=dev)

    return ControllerSpec(
        alpha=f32(model.alpha),
        pole=f32(compute_pole(model.delta)),
        goal=f32(goal.value),
        virtual_goal=f32(compute_virtual_goal(goal, model.lam)),
        hard=torch.tensor(goal.hard, device=dev),
        direction=f32(1.0 if goal.direction == "upper" else -1.0),
        conf_min=f32(model.conf_min),
        conf_max=f32(min(model.conf_max, 3.4e38)),
        metric_id=torch.tensor(metric_id, dtype=torch.int32, device=dev),
        super_hard=torch.tensor(goal.super_hard, device=dev),
    )


def stack_specs(specs: list[ControllerSpec]) -> ControllerSpec:
    return ControllerSpec(*(torch.stack(xs) for xs in zip(*specs)))


def init_state(initial_conf, device=None) -> ControllerState:
    """The state at ``initial_conf`` (a number or a tensor; a tensor keeps
    its device)."""
    if isinstance(initial_conf, torch.Tensor):
        return ControllerState(conf=initial_conf.to(F32))
    return ControllerState(conf=torch.as_tensor(initial_conf, dtype=F32,
                                                device=_device(device)))


def _next_conf(spec: ControllerSpec, base: torch.Tensor,
               measurement: torch.Tensor,
               n_interacting: torch.Tensor) -> torch.Tensor:
    """Eq. 2 with the §5.2 context-aware pole and §5.4 interaction
    factor."""
    measurement = torch.as_tensor(measurement, device=base.device).to(F32)
    # danger: metric crossed the virtual goal on the unsafe side
    danger = torch.where(spec.direction > 0,
                         measurement > spec.virtual_goal,
                         measurement < spec.virtual_goal)
    pole = torch.where(spec.hard & danger, torch.zeros_like(spec.pole),
                       spec.pole)
    error = spec.virtual_goal - measurement
    n = torch.where(spec.super_hard, n_interacting.to(F32),
                    torch.ones((), dtype=F32, device=base.device))
    gain = (1.0 - pole) / (spec.alpha * n)
    nxt = base + gain * error
    return torch.minimum(torch.maximum(nxt, spec.conf_min), spec.conf_max)


def _one(like: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=F32, device=like.device)


def controller_step(spec: ControllerSpec, state: ControllerState,
                    measurement) -> tuple[ControllerState, torch.Tensor]:
    """One control interval for a direct configuration."""
    conf = _next_conf(spec, state.conf, measurement, _one(state.conf))
    return ControllerState(conf=conf), conf


def indirect_controller_step(spec: ControllerSpec, state: ControllerState,
                             measurement, deputy
                             ) -> tuple[ControllerState, torch.Tensor]:
    """One control interval for an indirect configuration (§5.3): Eq. 2
    integrates from the *deputy's* actual value.  The returned value is
    the desired deputy value; the caller applies its transducer."""
    base = torch.as_tensor(deputy, device=state.conf.device).to(F32)
    conf = _next_conf(spec, base, measurement, _one(state.conf))
    return ControllerState(conf=conf), conf


def _onehot(metric_ids: torch.Tensor, num_metrics: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(metric_ids.long(),
                                       num_metrics).to(F32)      # [C, M]


def interaction_counts(metric_ids: torch.Tensor,
                       num_metrics: int) -> torch.Tensor:
    """N per controller: how many controllers share each controller's
    metric."""
    onehot = _onehot(metric_ids, num_metrics)
    return onehot @ onehot.sum(dim=0)                                # [C]


def coordinated_step(specs: ControllerSpec, states: ControllerState,
                     measurements, *, num_metrics: int = 8
                     ) -> tuple[ControllerState, torch.Tensor]:
    """Batched controllers with §5.4 coordination: ``specs``/``states``
    hold stacked tensors of C controllers; controllers with equal
    ``metric_id`` and ``super_hard`` split the error N ways."""
    n = interaction_counts(specs.metric_id, num_metrics)
    conf = _next_conf(specs, states.conf, measurements, n)
    return ControllerState(conf=conf), conf


def sharded_coordinated_step(mesh, axis_name: str, *, num_metrics: int = 8):
    """§5.4 coordination across a mesh axis of processes.

    Returns ``(specs, states, measurements) -> (states', confs)`` where
    each rank passes its slice of the controller batch and the
    interaction count N is agreed by an all-reduce of the per-metric
    counts over ``axis_name`` (a collective: every rank of the axis
    calls it).  Controllers of different modules never rendezvous at a
    single code location; they only share this metric-count reduction."""
    from repro_torch.distributed.collectives import all_reduce

    def local_step(specs: ControllerSpec, states: ControllerState,
                   measurements):
        onehot = _onehot(specs.metric_id, num_metrics)
        per_metric = all_reduce(onehot.sum(dim=0), mesh, axis_name)
        n = onehot @ per_metric
        conf = _next_conf(specs, states.conf, measurements, n)
        return ControllerState(conf=conf), conf

    return local_step
