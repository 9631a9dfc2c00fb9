"""Plain PyTorch versions of flash attention, forward and backward.

Layout as the kernels take it: q, o, dO [B, H, S, D]; k, v [B, Kv, S, D];
lse [B, H, S] f32.  Query head ``h`` reads KV head ``h // (H // Kv)``
(MHA, GQA and MQA), computed as a grouped einsum without repeating K/V.
A key ``k`` is admitted by query ``q`` when ``k <= q`` (``causal``) and
``q - k < window`` (``window > 0``); the non-causal windowed case admits
every later key, as the reference does.  Positions are ``arange(S)``.

Everything is computed in f32 from the inputs cast up, the scores scaled
by ``D ** -0.5`` after the dot, and outputs are cast back to the input
dtype, as ``src/repro/kernels/flash_attention/ref.py`` does.
:func:`attention_bwd_ref` writes out the FlashAttention-2 backward:
``D_i = rowsum(dO_i * O_i)``, ``P = exp(s - lse)`` under the mask, then
dV, dS, dQ and dK, with each GQA group's dK and dV summed in f32 into
``[B, Kv, S, D]``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(s: int, causal: bool, window: int, device) -> torch.Tensor:
    """[S, S] bool: query row admits key column."""
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window > 0:
        ok &= (qi - ki) < window
    return ok


def _grouped(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """[B, H, S, D] -> [B, Kv, G, S, D] in f32 (a view where possible)."""
    b, h, s, d = x.shape
    return x.float().reshape(b, kvh, h // kvh, s, d)


def _scores(q, k, causal: bool, window: int) -> torch.Tensor:
    """Scaled f32 scores [B, Kv, G, S, S], masked entries at -1e30."""
    d = q.shape[-1]
    s = torch.einsum("bkgqd,bksd->bkgqs", _grouped(q, k.shape[1]),
                     k.float()) * d ** -0.5
    ok = _mask(q.shape[2], causal, window, q.device)
    return torch.where(ok, s, NEG_INF)


def attention_lse_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,H,S,D]; k,v: [B,Kv,S,D] -> (o [B,H,S,D] in q's dtype,
    lse [B,H,S] f32)."""
    b, h, s, d = q.shape
    sc = _scores(q, k, causal, window)
    lse = torch.logsumexp(sc, dim=-1)                       # [B,Kv,G,S]
    p = torch.exp(sc - lse[..., None])
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return (o.reshape(b, h, s, d).to(q.dtype), lse.reshape(b, h, s))


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,H,S,D]; k,v: [B,Kv,S,D] -> [B,H,S,D] in q's dtype."""
    return attention_lse_ref(q, k, v, causal=causal, window=window)[0]


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0):
    """q, o, do: [B,H,S,D]; k, v: [B,Kv,S,D]; lse: [B,H,S] f32 ->
    (dq [B,H,S,D], dk [B,Kv,S,D], dv [B,Kv,S,D]) in q's, k's and v's
    dtypes."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    scale = d ** -0.5
    qg, dog = _grouped(q, kvh), _grouped(do, kvh)
    ok = _mask(s, causal, window, q.device)
    sc = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    lse_g = lse.float().reshape(b, kvh, h // kvh, s)
    p = torch.where(ok, torch.exp(sc - lse_g[..., None]), 0.0)
    del sc
    dsum = (dog * _grouped(o, kvh)).sum(dim=-1)             # [B,Kv,G,S]
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, v.float())
    ds = p * (dp - dsum[..., None])
    del p, dp
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
