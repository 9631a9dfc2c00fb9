"""Plain PyTorch oracle for segment-masked attention over packed streams.

One flat query stream carries contiguous chunks from different requests
(prefill chunks and length-1 decode segments alike); every query and key
names its segment, and a key is visible iff it belongs to the same segment,
has been written (``k_pos >= 0``), is causal (``k_pos <= q_pos``), and sits
inside the sliding window.  Queries whose segment is negative (dead pad
lanes), or whose predicate admits no key, return exact zeros.

The paged oracle gathers the logical K/V view through the block table
(``kernels.paged_attention.paged_gather``) and defers to the flat oracle,
so the two can never drift apart.
"""

from __future__ import annotations

import torch


def _segment_mask(q_pos, k_pos, q_seg, k_seg, window: int):
    """[P, N] bool visibility predicate (the packed-segment ABI)."""
    ok = (k_seg[None, :] == q_seg[:, None]) & (q_seg[:, None] >= 0)
    ok &= k_pos[None, :] >= 0
    ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return ok


def segment_attention_ref(q, k, v, q_pos, k_pos, q_seg, k_seg, *,
                          window: int = 0):
    """q: [P,H,D]; k,v: [N,Kv,D]; q_pos/q_seg: [P]; k_pos/k_seg: [N]
    -> [P,H,D].  GQA/MQA via a grouped einsum (no repeated K/V).  q is
    scaled by D^-0.5 before the dot (the kernel scales the dot product)."""
    p, h, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    qg = (q * d ** -0.5).reshape(p, kvh, g, d)
    s = torch.einsum("pkgd,nkd->kgpn", qg.float(), k.float())   # [Kv,G,P,N]
    ok = _segment_mask(q_pos, k_pos, q_seg, k_seg, window)      # [P,N]
    s = torch.where(ok[None, None], s, -1e30)
    pr = torch.softmax(s, dim=-1)
    # fully-masked queries (dead pad lanes) would softmax uniformly over
    # -1e30 scores; zero them instead
    live = ok.any(dim=-1)                                       # [P]
    pr = torch.where(live[None, None, :, None], pr, 0.0)
    o = torch.einsum("kgpn,nkd->pkgd", pr, v.float())
    return o.reshape(p, h, d).to(q.dtype)


def paged_segment_attention_ref(q, k_store, v_store, block_tables, q_pos,
                                q_seg, *, window: int = 0):
    """q: [P,H,D]; k_store/v_store: [N,Kv,T,D]; block_tables: [B,M] int32
    (-1 = unallocated); q_pos/q_seg: [P] (segment id == block-table row)
    -> [P,H,D].  Key positions are implied by table order and key segments
    by table row.  A segment >= B raises IndexError, as the kernel fails."""
    from repro_torch.kernels.paged_attention import paged_gather
    k, v, k_pos = paged_gather(k_store, v_store, block_tables)
    b, kvh, mt, d = k.shape
    if q_seg.numel() and int(q_seg.max()) >= b:
        raise IndexError(f"segment {int(q_seg.max())} names no row of "
                         f"{b} block-table rows")
    k_flat = k.transpose(1, 2).reshape(b * mt, kvh, d)
    v_flat = v.transpose(1, 2).reshape(b * mt, kvh, d)
    kpos_flat = k_pos.reshape(b * mt)
    kseg_flat = torch.arange(b, dtype=torch.int32,
                             device=q.device).repeat_interleave(mt)
    return segment_attention_ref(q, k_flat, v_flat, q_pos, kpos_flat,
                                 q_seg, kseg_flat, window=window)
