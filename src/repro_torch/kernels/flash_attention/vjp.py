"""Differentiable flash attention: a ``torch.autograd.Function`` over the
forward-with-logsumexp and backward kernels (scores never materialize in
either pass), the port of the reference's ``jax.custom_vjp``.

Forward saves ``q, k, v, o, lse``; backward makes ``dO`` contiguous (what
autograd hands it may be a transposed view) and calls the backward
kernels.  On CPU tensors the same Function runs the plain versions
(:func:`~.ref.attention_lse_ref`, :func:`~.ref.attention_bwd_ref`), so the
CPU tests exercise its wiring."""

from __future__ import annotations

import torch

from repro_torch.kernels import use_plain

from .flash_attention import flash_attention_fwd_lse
from .flash_attention_bwd import flash_attention_bwd
from .ref import attention_bwd_ref, attention_lse_ref


class FlashAttention(torch.autograd.Function):
    """q: [B,H,S,D]; k, v: [B,Kv,S,D] -> o [B,H,S,D]; ``causal`` and
    ``window`` are not differentiated."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        if use_plain(q, k, v):
            o, lse = attention_lse_ref(q, k, v, causal=causal, window=window)
        else:
            o, lse = flash_attention_fwd_lse(q, k, v, causal=causal,
                                             window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        bwd = attention_bwd_ref if use_plain(q, do) else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=ctx.causal,
                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_grad(q, k, v, causal: bool = True, window: int = 0):
    """q: [B,H,S,D]; k, v: [B,Kv,S,D] -> [B,H,S,D], differentiable."""
    return FlashAttention.apply(q, k, v, causal, window)
