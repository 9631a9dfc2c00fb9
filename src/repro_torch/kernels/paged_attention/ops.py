"""Device dispatch for paged decode attention: CPU tensors run the plain
version, CUDA tensors launch the kernel (or raise)."""

from __future__ import annotations

from repro_torch.kernels import use_plain

from .paged_attention import paged_decode_attention
from .ref import paged_decode_attention_ref


def paged_decode_attention_op(q, k_store, v_store, block_tables, q_pos, *,
                              window: int = 0):
    """q [B,H,D]; stores [N,Kv,T,D]; tables [B,M]; q_pos [B] -> [B,H,D]."""
    if use_plain(q, k_store, v_store, block_tables, q_pos):
        return paged_decode_attention_ref(q, k_store, v_store, block_tables,
                                          q_pos, window=window)
    return paged_decode_attention(q, k_store, v_store, block_tables, q_pos,
                                  window=window)
