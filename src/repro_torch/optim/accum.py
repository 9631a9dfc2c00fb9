"""Microbatch gradient accumulation: the port of
``src/repro/optim/accum.py``.

The reference scans over microbatches; here a Python loop runs each
microbatch's forward and backward in turn and adds its gradients into an
f32 accumulator, then takes the mean, so only one microbatch's
activations live at a time.  ``train.microbatch_tokens`` quantizes a
controller's desired count to a divisor of the batch
(:func:`quantize_microbatches`).
"""

from __future__ import annotations

import torch

from repro_torch.models.bridge import tree_leaves, tree_map


def split_batch(batch: dict, n_micro: int) -> dict:
    """[B, ...] -> [n_micro, B / n_micro, ...] for every leaf."""
    def f(x):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} "
                             "microbatches")
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])
    return tree_map(f, batch)


def value_and_grad(loss_fn, params, batch):
    """``loss_fn(params, batch) -> (loss, aux)`` and the gradient of
    ``loss`` with respect to every leaf of ``params`` (same nesting, each
    leaf's dtype).  Leaves are marked as requiring grad in place."""
    leaves = list(tree_leaves(params))
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    loss, aux = loss_fn(params, batch)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(torch.Tensor.detach, aux), \
        tree_map(lambda _: next(grads), params)


def accumulate_grads(loss_fn, params, batch: dict, n_micro: int):
    """Mean loss, aux and gradients over ``n_micro`` sequential
    microbatches; with more than one, the gradients come back in f32."""
    if n_micro <= 1:
        return value_and_grad(loss_fn, params, batch)
    micro = split_batch(batch, n_micro)
    acc = loss_acc = aux_acc = None
    for i in range(n_micro):
        loss, aux, g = value_and_grad(loss_fn, params,
                                      tree_map(lambda x: x[i], micro))
        if acc is None:
            acc = tree_map(lambda t: t.float(), g)
            loss_acc, aux_acc = loss, aux
        else:
            for a, t in zip(tree_leaves(acc), tree_leaves(g)):
                a.add_(t)
            loss_acc = loss_acc + loss
            aux_acc = {k: aux_acc[k] + v for k, v in aux.items()}
        del g
    inv = 1.0 / n_micro
    for a in tree_leaves(acc):
        a.mul_(inv)
    return loss_acc * inv, tree_map(lambda a: a * inv, aux_acc), acc


def divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def quantize_microbatches(batch_size: int, desired: float) -> int:
    """Nearest valid microbatch count for a controller-desired value."""
    ds = divisors(batch_size)
    return min(ds, key=lambda d: abs(d - desired))
