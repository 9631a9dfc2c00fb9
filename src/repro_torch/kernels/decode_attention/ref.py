"""Plain PyTorch oracle for decode attention."""

from __future__ import annotations

import torch


def decode_mask(k_pos, q_pos, window: int = 0):
    """[B, S] bool: the keys each row admits (written, causal, in the
    window)."""
    valid = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window > 0:
        valid &= (q_pos[:, None] - k_pos) < window
    return valid


def decode_attention_ref(q, k, v, k_pos, q_pos, *, window: int = 0):
    """q: [B,H,D]; k,v: [B,Kv,S,D]; k_pos [B,S]; q_pos [B] -> [B,H,D].

    A row whose every key is masked softmaxes uniformly over the -1e30
    scores and returns the mean of V, as the JAX package's oracle does;
    the paged decode versions zero such rows instead."""
    b, h, d = q.shape
    kv_heads = k.shape[1]
    if kv_heads != h:
        k = k.repeat_interleave(h // kv_heads, dim=1)
        v = v.repeat_interleave(h // kv_heads, dim=1)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k.float()) * (d ** -0.5)
    valid = decode_mask(k_pos, q_pos, window)
    s = torch.where(valid[:, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, v.float()).to(q.dtype)
