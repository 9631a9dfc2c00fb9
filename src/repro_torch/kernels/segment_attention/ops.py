"""Device dispatch for segment attention, flat and paged: CPU tensors run
the plain version, CUDA tensors launch the kernel (or raise)."""

from __future__ import annotations

from repro_torch.kernels import use_plain

from .ref import paged_segment_attention_ref, segment_attention_ref
from .segment_attention import paged_segment_attention, segment_attention


def segment_attention_op(q, k, v, q_pos, k_pos, q_seg, k_seg, *,
                         window: int = 0):
    """Flat-key segment attention: q [P,H,D]; k,v [N,Kv,D]; q_pos/q_seg
    [P]; k_pos/k_seg [N] -> [P,H,D]."""
    if use_plain(q, k, v, q_pos, k_pos, q_seg, k_seg):
        return segment_attention_ref(q, k, v, q_pos, k_pos, q_seg, k_seg,
                                     window=window)
    return segment_attention(q, k, v, q_pos, k_pos, q_seg, k_seg,
                             window=window)


def paged_segment_attention_op(q, k_store, v_store, block_tables, q_pos,
                               q_seg, *, window: int = 0):
    """q [P,H,D]; stores [N,Kv,T,D]; tables [B,M]; q_pos/q_seg [P]
    -> [P,H,D].  The plain version materializes the table-gathered view;
    the kernel walks each slot's table row itself."""
    if use_plain(q, k_store, v_store, block_tables, q_pos, q_seg):
        return paged_segment_attention_ref(q, k_store, v_store, block_tables,
                                           q_pos, q_seg, window=window)
    return paged_segment_attention(q, k_store, v_store, block_tables, q_pos,
                                   q_seg, window=window)
