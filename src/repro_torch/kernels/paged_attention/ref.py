"""Plain PyTorch oracle for paged decode attention.

Gathers each row's logical KV view through the block table and defers to
the dense decode kernel's plain version.  Logical position ``p`` of row
``b`` lives in physical block ``block_tables[b, p // T]`` at offset
``p % T``.

A row that admits no key gives exact zeros.  The engine's idle slots are
such rows (position 0, table row all -1) on every decode-only tick with
fewer running requests than slots.  The JAX package's Pallas kernel and
the CUDA kernel give zeros there; the JAX package's oracle gives the mean
of V."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import decode_attention_plain


def paged_gather(k_store, v_store, block_tables):
    """Materialize each row's logical KV view from the block store.

    k_store/v_store: [N, Kv, T, D]; block_tables: [B, M] int32 (-1 = hole).
    Returns (k [B, Kv, M*T, D], v [B, Kv, M*T, D], k_pos [B, M*T]) where
    ``k_pos`` is each view slot's logical position, -1 behind a -1 entry.
    An entry >= N raises IndexError (a stale table), as the kernels fail."""
    n, kv_heads, t, d = k_store.shape
    b, m = block_tables.shape
    idx = block_tables.long().clamp(min=0)                      # [B, M]
    k = k_store[idx].permute(0, 2, 1, 3, 4).reshape(b, kv_heads, m * t, d)
    v = v_store[idx].permute(0, 2, 1, 3, 4).reshape(b, kv_heads, m * t, d)
    pos = torch.arange(m * t, dtype=torch.int32,
                       device=block_tables.device)[None, :]
    ok = (block_tables >= 0).repeat_interleave(t, dim=1)        # [B, M*T]
    k_pos = torch.where(ok, pos, -1)
    return k, v, k_pos


def paged_decode_attention_ref(q, k_store, v_store, block_tables, q_pos, *,
                               window: int = 0):
    """q: [B,H,D]; stores: [N,Kv,T,D]; block_tables: [B,M] int32; q_pos:
    [B] -> [B,H,D].  Keys past q_pos, behind -1 entries, or outside the
    window are masked; a row with no key left is exact zeros."""
    k, v, k_pos = paged_gather(k_store, v_store, block_tables)
    return decode_attention_plain(q, k, v, k_pos, q_pos, window=window)
