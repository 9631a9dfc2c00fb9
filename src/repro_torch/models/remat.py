"""The reference's ``remat="dots"`` policy: products without batch dims
kept, the rest of a checkpointed layer recomputed.

The reference checkpoints its scanned group body under
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
(``src/repro/models/transformer.py:255``): the output of a
``dot_general`` without batch dims may be saved, everything else (the
batched products, the attention kernels, the elementwise work) runs
again in the backward pass, and JAX saves such an output only where the
backward pass reads it.  The port's products of that kind are the
``x @ w`` of a weight ``w [d, f]`` (q/k/v/o, the MLP, the recurrent
blocks' projections, the MoE router and shared experts), and each goes
through :func:`dot`.  ``torch.utils.checkpoint`` runs a layer under
:func:`contexts`' pair (its ``context_fn``): in the forward each
:func:`dot` keeps its output, and in the recompute it gives that output
back in the same order instead of multiplying again, with the same
backward (:class:`_Dot`).

All but one: a layer's last product (``w_down``, RWKV-6's ``cm_v``,
the shared experts' ``w_down``, a decoder's cross-attention ``wo``)
closes it, and only the sums that end the layer read its output.  Its
backward needs its input and its weight, never its output, and the
recompute is not asked for the layer's output, so the reference does
not save it.  When a layer's forward ends, its closing product lets go
of its output and keeps only the shape; the recompute gets an expanded
scalar of that shape (:func:`_placeholder`), which costs no product.
``torch.utils.checkpoint`` stops the recompute once it has packed what
the backward pass needs, and what runs after that product (the sums,
the MoE aux loss) saves nothing of its output, so nothing reads the
placeholder's value.

Only the products pay for the policy.  Selective checkpointing
(``create_selective_checkpoint_contexts``) keeps the same products but
runs every op of the layer through a Python dispatch mode, in the
forward and again in the recompute.  Measured on an H100 (2 x 4096
tokens a step), that made a 2-layer rwkv6-7b step, whose chunk loop
runs many small ops, 73-77% slower than recomputing everything, and a
4-layer yi-6b step up to 7% slower on a slow host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["dot", "contexts"]

# the checkpointed layers running now, innermost last
_ACTIVE: list["_Pass"] = []


class _Dropped(NamedTuple):
    """What a layer keeps of its closing product: the shape and dtype of
    its output."""
    shape: torch.Size
    dtype: torch.dtype


class _Pass:
    """One pass of a checkpointed layer: the forward, which appends each
    product's output to ``kept`` and, as it ends, puts the closing
    product's :class:`_Dropped` in place of its output; or the recompute,
    which hands them back in order and lets go of each.  The recompute
    stops once it has what the backward pass needs, so what it did not
    reach is let go when it ends: those outputs are needed by nothing."""

    def __init__(self, kept: list, replay: bool):
        self.kept, self.replay, self.next = kept, replay, 0

    def __enter__(self) -> "_Pass":
        self.next = 0
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.pop()
        if self.replay:
            self.kept.clear()
        elif self.kept:
            last = self.kept[-1]
            self.kept[-1] = _Dropped(last.shape, last.dtype)


def contexts() -> tuple[_Pass, _Pass]:
    """``torch.utils.checkpoint``'s ``context_fn`` for ``"dots"``: the
    forward's context and the recompute's, sharing one list of kept
    products."""
    kept: list[torch.Tensor] = []
    return _Pass(kept, False), _Pass(kept, True)


def _placeholder(shape, dtype, device) -> torch.Tensor:
    """The recompute's stand-in for a closing product's output: a scalar
    expanded to its shape, which nothing reads."""
    return torch.zeros((), dtype=dtype, device=device).expand(shape)


class _Dot(torch.autograd.Function):
    """``x2d.mm(w)``, or ``out`` where the forward already computed it;
    the backward is autograd's own for ``mm`` (``grad.mm(w.t())``,
    ``x2d.t().mm(grad)``), so the gradients are bit for bit those of a
    plain ``x @ w``."""

    @staticmethod
    def forward(ctx, x2d, w, out):
        ctx.save_for_backward(x2d, w)
        return x2d.mm(w) if out is None else out

    @staticmethod
    def backward(ctx, grad):
        x2d, w = ctx.saved_tensors
        gx = grad.mm(w.t()) if ctx.needs_input_grad[0] else None
        gw = x2d.t().mm(grad) if ctx.needs_input_grad[1] else None
        return gx, gw, None


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``x [..., d]`` and a weight ``w [d, f]``: a product
    without batch dims, which ``"dots"`` keeps unless it closes the
    layer.  Outside a checkpointed layer under ``"dots"`` it is ``x @ w``
    itself."""
    if not _ACTIVE or not torch.is_grad_enabled():
        return x @ w
    p = _ACTIVE[-1]
    x2d = x.reshape(-1, x.shape[-1])
    out = None
    if p.replay:
        if p.next >= len(p.kept):
            raise RuntimeError(
                "remat dots: a layer recomputed twice, or more products "
                "than its forward ran; checkpoint it with remat='full'")
        out, p.kept[p.next] = p.kept[p.next], None
        p.next += 1
        if out.shape != (x2d.shape[0], w.shape[1]):
            raise RuntimeError(
                f"remat dots: the recompute's product {p.next} is "
                f"{tuple(x2d.shape)} @ {tuple(w.shape)}, the forward kept "
                f"{tuple(out.shape)}")
        if isinstance(out, _Dropped):
            out = _placeholder(out.shape, out.dtype, x2d.device)
    y = _Dot.apply(x2d, w, out)
    if not p.replay:
        p.kept.append(y.detach())
    return y.view(*x.shape[:-1], w.shape[1])
