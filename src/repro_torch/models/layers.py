"""Model building blocks: norms, RoPE, attention projections, dense MLPs.

Plain functions over parameter dicts of tensors.  Layouts are the
reference's: ``wq``/``wk``/``wv`` are ``[d, heads, head_dim]`` used as
``bsd,dhk->bshk`` and ``wo`` is ``[heads, head_dim, d]``, so weights carry
over without transposes.  Projections are plain matrix products
(``torch.matmul``).  Packed attention runs through the hand-written
kernels, and so does the dense decode step's one-token attention (the
dense decode kernel the reference wrote for it, where the reference
itself computes it in XLA).  A padded prompt chunk's attention over its
ring or paged view is plain torch, as the reference computes it in XLA
outside any kernel.  Full-sequence self-attention (training, one-shot
prefill) runs through the flash attention kernels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # normalise in f32, cast back to x's dtype, and only then scale: the
    # reference's rounding order, which matters in bf16
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return y.to(dt) * params["scale"]


def layernorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * params["scale"] + params["bias"]


def norm_init(kind: str, d: int, dtype, device) -> dict:
    return (rmsnorm_init(d, dtype, device) if kind == "rms"
            else layernorm_init(d, dtype, device))


def apply_norm(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rms" else layernorm(params, x)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (absolute).  Angles in f32."""
    d = x.shape[-1]
    half = d // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = 1.0 / (theta ** (idx / half))
    angles = positions[..., :, None].float() * freqs      # [..., S, half]
    cos = torch.cos(angles)[..., :, None, :]              # [..., S, 1, half]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense projections
# ---------------------------------------------------------------------------


def dense_init(shape, dtype, device, generator: torch.Generator,
               in_axis: int = -2) -> torch.Tensor:
    """Uniform(-1, 1) / sqrt(fan_in), drawn in f32 then cast — the
    reference's distribution (not its bits: the generators differ)."""
    scale = 1.0 / math.sqrt(shape[in_axis])
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.uniform_(-1.0, 1.0, generator=generator)
    return w.mul_(scale).to(dtype)


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def attn_output(params: dict, o: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matrix product."""
    h, k, d = params["wo"].shape
    return o.flatten(-2) @ params["wo"].reshape(h * k, d)


# ---------------------------------------------------------------------------
# attention over positioned keys
# ---------------------------------------------------------------------------


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B,Sq,H,D], k: [B,Sk,Kv,D] -> scores [B,H,Sq,Sk], GQA without
    repeating K."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k)
    return s.reshape(b, h, sq, k.shape[1])


def _grouped_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: [B,H,Sq,Sk], v: [B,Sk,Kv,D] -> [B,Sq,H,D]."""
    b, h, sq, sk = p.shape
    kvh = v.shape[2]
    pg = p.reshape(b, kvh, h // kvh, sq, sk)
    o = torch.einsum("bkgqs,bskd->bqkgd", pg, v)
    return o.reshape(b, sq, h, o.shape[-1])


def chunk_attention(q, k, v, *, k_pos, q_pos, window: int = 0):
    """Queries against per-row positioned keys.  q [B,C,H,D]; k,v
    [B,N,Kv,D]; k_pos [B,N] (-1 = unwritten); q_pos [B,C].  A key is
    admitted when written, causal and (with a window) inside it.  As in
    the reference, a row that admits no key gives the mean of V, and the
    probabilities are rounded to q's dtype before the product with V."""
    s = _grouped_scores(q * q.shape[-1] ** -0.5, k).float()     # [B,H,C,N]
    valid = (k_pos[:, None, :] >= 0) & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window > 0:
        valid &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    s = torch.where(valid[:, None], s, -1e30)
    return _grouped_out(torch.softmax(s, dim=-1).to(q.dtype), v)


def decode_attention(q, k_cache, v_cache, *, k_pos, q_pos, window: int = 0):
    """One token against a dense cache: q [B,1,H,D]; caches [B,S,Kv,D];
    k_pos [B,S]; q_pos [B] -> [B,1,H,D].  The caches go to
    ``decode_attention_op`` as ``[B,Kv,S,D]`` views, read in place: the
    dense decode kernel on a card, its plain version on the CPU.  The
    one-query case of :func:`chunk_attention` but for two things, both
    the reference's Pallas kernel's: the probabilities meet V in f32 (not
    rounded to q's dtype), and a row no key admits gives exact zeros (not
    the mean of V)."""
    from repro_torch.kernels.decode_attention import decode_attention_op
    o = decode_attention_op(q[:, 0], k_cache.transpose(1, 2),
                            v_cache.transpose(1, 2), k_pos, q_pos,
                            window=window)
    return o[:, None]


def attention(q, k, v, *, q_pos, k_pos, causal: bool = True,
              window: int = 0):
    """Full-sequence self-attention: q [B,S,H,D]; k,v [B,S,Kv,D] ->
    [B,S,H,D].  ``window`` = 0 is unbounded; W keeps ``q - k < W``.

    Always the flash route (the reference's ``REPRO_ATTN_IMPL=pallas``;
    its default XLA route computes the same function): when a gradient is
    wanted, the differentiable Function over the forward-with-logsumexp
    and backward kernels, else the forward kernel alone.  CPU tensors run
    the plain versions.  Positions are taken to be ``arange(S)``, as
    training passes them; ``q_pos``/``k_pos`` are not read.  Queries
    against keys of another length (cross-attention, enc-dec only) are
    ROADMAP Queue 1 item 12."""
    del q_pos, k_pos
    if q.shape[1] != k.shape[1]:
        raise NotImplementedError(
            "cross-attention (enc-dec) is ROADMAP Queue 1 item 12 (not "
            "ported yet)")
    from repro_torch.kernels.flash_attention import (attention_op,
                                                     flash_attention_grad)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return attention_op(q, k, v, causal=causal, window=window)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return flash_attention_grad(qt, kt, vt, causal, window).transpose(1, 2)


def segment_attention(q, k, v, *, q_pos, k_pos, q_seg, k_seg,
                      window: int = 0):
    """Token-packed ragged attention: q [B,P,H,D]; k,v [B,N,Kv,D];
    q_pos/q_seg [B,P]; k_pos/k_seg [B,N].  A key is admitted when it
    shares the query's segment (>= 0), is written, causal and inside the
    window; a query no key admits gives exact zeros.  Each row of the
    (B == 1) packed stream goes through ``segment_attention_op``: the flat
    segment kernel on a card, its plain version on the CPU."""
    from repro_torch.kernels.segment_attention import segment_attention_op
    out = [segment_attention_op(q[i], k[i], v[i], q_pos[i], k_pos[i],
                                q_seg[i], k_seg[i], window=window)
           for i in range(q.shape[0])]
    return torch.stack(out).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    # the reference's gelu is the tanh approximation
    if kind == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif kind == "geglu":
        h = F.gelu(x @ params["w_gate"], approximate="tanh") \
            * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]
