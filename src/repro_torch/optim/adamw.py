"""AdamW from scratch: decoupled weight decay on matrices, bias
correction, global-norm clipping, linear warmup then cosine decay.  The
port of ``src/repro/optim/adamw.py`` over parameter dicts of tensors.

Moments are f32 whatever the parameters' dtype; the new parameter is
computed in f32 and cast back to its own dtype.  Unlike the reference,
whose arrays are immutable, :func:`update` writes the parameters and the
moments **in place** (under ``torch.no_grad()``): at full width the
parameters, gradients and moments are most of device memory, and a
second copy would not fit.  :func:`state_pspecs` places the moments as
the parameters are placed (ZeRO).  The step counter and the schedule are 0-d
f32/int32 CPU tensors, so the host never waits for the device to learn
the learning rate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.distributed.sharding import keyed_specs
from repro_torch.models.bridge import keyed_leaves, tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, on the CPU
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def init(params) -> AdamWState:
    """Zero f32 moments beside every parameter, on its device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``; computed
    in f32 as the reference does.  Returns a 0-d f32 CPU tensor."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * frac))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def global_norm(tree, placement=None, mp=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.  With
    ``placement`` (a ``distributed.sharding.Placement`` mirroring
    ``tree``) and ``mp`` (the step's ``collectives.ModelParallel``) the
    tree holds this rank's ``model`` slices: the squares of the leaves
    split over ``model`` are summed over it (one all-reduce), each
    replicated leaf, whole on every rank, is counted once."""
    if placement is None:
        sq = [x.float().square().sum() for x in tree_leaves(tree)]
        return torch.stack(sq).sum().sqrt()
    specs = dict(keyed_specs(placement.specs))
    leaves = list(keyed_leaves(tree))
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0][1].device)
    parts: dict[bool, list] = {True: [zero], False: [zero]}
    for key, x in leaves:
        parts[placement.splits_model(specs[key])].append(
            x.float().square().sum())
    split = mp.all_reduce(torch.stack(parts[True]).sum())
    return (split + torch.stack(parts[False]).sum()).sqrt()


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: AdamWConfig, *,
           gnorm: torch.Tensor | None = None):
    """One AdamW step from ``grads`` (any float dtype).  Updates ``params``
    and ``state``'s moments in place and returns ``(params, new_state,
    metrics)``; ``metrics`` holds ``lr`` (CPU) and ``grad_norm`` (on the
    parameters' device) as 0-d f32 tensors.  ``gnorm`` is the global
    norm when ``grads`` are slices of the gradients (a rank's share under
    FSDP): the clip must read the whole tree's norm."""
    step = state.step + 1
    lr = schedule(cfg, step)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = float(1.0 - _f32(b1) ** _f32(step))
    c2 = float(1.0 - _f32(b2) ** _f32(step))
    lr_f = float(lr)
    # leaves are matched by their place in the tree, not by dict order
    trees = [dict(keyed_leaves(t)) for t in (grads, state.m, state.v)]
    for key, p in keyed_leaves(params):
        g, m, v = (t[key] for t in trees)
        g = g.float() * scale
        m.mul_(b1).add_(g * (1.0 - b1))
        v.mul_(b2).add_(g.square_() * (1.0 - b2))
        delta = (m / c1) / ((v / c2).sqrt_() + cfg.eps)
        if p.dim() >= 2:     # decoupled weight decay on matrices only
            delta.add_(p.float() * cfg.weight_decay)
        p.copy_((p.float() - lr_f * delta).to(p.dtype))
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, AdamWState(step, state.m, state.v), metrics


def state_pspecs(param_pspecs) -> AdamWState:
    """The moments' specs mirror the parameters' (ZeRO-1/2: under FSDP a
    rank's moments are its slices of the parameters' placement); the
    step counter is replicated."""
    return AdamWState(step=(), m=param_pspecs, v=param_pspecs)
