"""Model building blocks: norms, RoPE, attention projections, dense MLPs.

Plain functions over parameter dicts of tensors.  Layouts are the
reference's: ``wq``/``wk``/``wv`` are ``[d, heads, head_dim]`` used as
``bsd,dhk->bshk`` and ``wo`` is ``[heads, head_dim, d]``, so weights carry
over without transposes.  Projections are plain matrix products
(``torch.matmul``); only attention runs through the hand-written kernels.
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
