"""Device dispatch for flash attention in the model layout: CPU tensors run
the plain version, CUDA tensors launch the kernel (or raise), ``meta``
tensors take the kernel wrapper's reckoning."""

from __future__ import annotations

from repro_torch.kernels import on_meta, use_plain

from .flash_attention import flash_attention
from .ref import attention_ref


def attention_op(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,S,H,D]; k,v: [B,S,Kv,D] (model layout) -> [B,S,H,D].  The
    forward alone, without the logsumexp (what a pass that takes no
    gradient needs)."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if not on_meta(qt, kt, vt) and use_plain(qt, kt, vt):
        out = attention_ref(qt, kt, vt, causal=causal, window=window)
    else:
        out = flash_attention(qt, kt, vt, causal=causal, window=window)
    return out.transpose(1, 2)
