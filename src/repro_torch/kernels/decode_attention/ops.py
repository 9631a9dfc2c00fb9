"""Device dispatch for dense decode attention: CPU tensors run the plain
version, CUDA tensors launch the kernel (or raise)."""

from __future__ import annotations

from repro_torch.kernels import use_plain

from .decode_attention import decode_attention
from .ref import decode_attention_plain


def decode_attention_op(q, k, v, k_pos, q_pos, *, window: int = 0,
                        split_groups=None):
    """q [B,H,D]; k, v [B,Kv,S,D] (strided); k_pos [B,S]; q_pos [B] ->
    [B,H,D].  ``split_groups`` plans the kernel's key split (the plain
    version has none)."""
    if use_plain(q, k, v, k_pos, q_pos):
        return decode_attention_plain(q, k, v, k_pos, q_pos, window=window)
    return decode_attention(q, k, v, k_pos, q_pos, window=window,
                            split_groups=split_groups)
