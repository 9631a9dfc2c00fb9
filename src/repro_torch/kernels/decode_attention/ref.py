"""Plain PyTorch versions of decode attention.

:func:`decode_attention_plain` is the kernel's function: what CPU tensors
run and what ``chip_smoke.py`` holds the CUDA kernel to.
:func:`decode_attention_ref` mirrors the JAX package's oracle, which
differs only on a row that admits no key; the tests keep it to compare
with that oracle."""

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

    Scores, probabilities and their product with V in f32.  A row whose
    every key is masked softmaxes uniformly over the -1e30 scores and
    returns the mean of V, as the JAX package's oracle does."""
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


def decode_attention_plain(q, k, v, k_pos, q_pos, *, window: int = 0):
    """The dense decode kernel's function: :func:`decode_attention_ref`
    with exact zeros on a row that admits no key, as the JAX package's
    Pallas kernel (its ``l == 0`` guard) and the CUDA kernel give.  The
    engine's idle slots are such rows on a decode tick with fewer running
    requests than slots."""
    out = decode_attention_ref(q, k, v, k_pos, q_pos, window=window)
    live = decode_mask(k_pos, q_pos, window).any(dim=-1)       # [B]
    return torch.where(live[:, None, None], out, 0.0)
