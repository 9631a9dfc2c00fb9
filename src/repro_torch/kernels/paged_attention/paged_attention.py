"""Paged decode attention on Hopper: the wrapper of
``csrc/paged_attention.cu`` (one query token per row against the block
store, gathered through per-row block tables).

Layout (shared with ``repro_torch.serve.paging`` and ``models.blocks``):

  * block store ``k_store, v_store: [N, Kv, T, D]``, one allocation all
    sequences share; ``T`` is the block token granularity;
  * block table ``block_tables: [B, M] int32``: entry ``i`` of row ``b``
    names the physical block holding positions ``[i*T, (i+1)*T)``; ``-1``
    marks an unallocated entry;
  * a key at position ``p`` is admitted when its entry is >= 0,
    ``p <= q_pos`` and, with a window, ``q_pos - p < window``.

The kernel splits each row's table across CTAs (flash-decoding) and a
second kernel combines the splits; :func:`split_blocks` picks the split
from the shapes alone (the table width, the (row, KV head) pairs and the
SM count), so the wrapper never reads ``q_pos`` or the tables back to the
host.  The wrapper checks device, dtype, shape, contiguity and alignment,
allocates the f32 partials, launches on the current stream, raises if a
launch failed, and counts launches in ``paged_decode_attention.launches``.
The plain version of the same function is
:func:`~repro_torch.kernels.paged_attention.ref.paged_decode_attention_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (HEAD_DIMS, KERNEL_DTYPES, _build,
                                 check_operand)
from repro_torch.kernels.decode_attention.decode_attention import CTAS_PER_SM

MAX_BLOCK_TOKENS = 64   # K/V block tiles live in shared memory


def split_blocks(m: int, groups: int, sms: int) -> tuple[int, int]:
    """``(blocks_per_split, n_split)`` for a table of ``m`` entries per row
    and ``groups`` (row, KV head) pairs on ``sms`` SMs: enough runs of
    consecutive entries for about ``CTAS_PER_SM`` CTAs per SM, every run
    non-empty and together covering all ``m``.  From the shapes alone: the
    live blocks depend on ``q_pos`` and the tables, which stay on the
    device."""
    want = -(-CTAS_PER_SM * sms // max(1, groups))
    per = -(-m // want)
    return per, -(-m // per)


@functools.cache
def _launcher():
    fn = _build.library("paged_attention").paged_decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q: torch.Tensor, k_store: torch.Tensor,
                           v_store: torch.Tensor, block_tables: torch.Tensor,
                           q_pos: torch.Tensor, *, window: int = 0,
                           split_groups: int | None = None) -> torch.Tensor:
    """q: [B, H, D]; k_store/v_store: [N, Kv, T, D]; block_tables: [B, M]
    int32 (-1 = unallocated); q_pos: [B] int32 -> [B, H, D] in q's dtype.
    CUDA tensors only.  ``split_groups`` is the (row, KV head) count the
    key split is planned for (:func:`split_blocks`), ``B * Kv`` by
    default: a tensor-parallel shard holding ``Kv / M`` heads passes the
    global ``B * Kv`` and so splits, and sums, as one device would."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention kernel needs CUDA tensors, "
                         f"got {dev}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"q: dtype {q.dtype} not in {list(KERNEL_DTYPES)}")
    check_operand("q", q, dtype=q.dtype, ndim=3, device=dev)
    check_operand("k_store", k_store, dtype=q.dtype, ndim=4, device=dev)
    check_operand("v_store", v_store, dtype=q.dtype, ndim=4, device=dev)
    check_operand("block_tables", block_tables, dtype=torch.int32, ndim=2,
                  device=dev, align=4)
    check_operand("q_pos", q_pos, dtype=torch.int32, ndim=1, device=dev,
                  align=4)
    b, h, d = q.shape
    n, kv, t, d2 = k_store.shape
    m = block_tables.shape[1]
    if v_store.shape != k_store.shape or d2 != d:
        raise ValueError(f"store shapes {tuple(k_store.shape)} / "
                         f"{tuple(v_store.shape)} do not match q {tuple(q.shape)}")
    if block_tables.shape[0] != b or q_pos.shape[0] != b:
        raise ValueError("block_tables / q_pos rows must match q's batch")
    if h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not 1 <= t <= MAX_BLOCK_TOKENS:
        raise ValueError(f"block_tokens {t} outside [1, {MAX_BLOCK_TOKENS}]")
    out = torch.empty_like(q)
    if b == 0 or n == 0 or m == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per, n_split = split_blocks(
        m, b * kv if split_groups is None else split_groups, sms)
    g = h // kv
    o_part = torch.empty((b, kv, n_split, g, d), dtype=torch.float32,
                         device=dev)
    ml_part = torch.empty((b, kv, n_split, g, 2), dtype=torch.float32,
                          device=dev)
    err = _launcher()(
        q.data_ptr(), k_store.data_ptr(), v_store.data_ptr(),
        block_tables.data_ptr(), q_pos.data_ptr(), o_part.data_ptr(),
        ml_part.data_ptr(), out.data_ptr(), b, h, kv, n, t, m, d, per,
        n_split, int(window), float(d) ** -0.5, KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_attention: CUDA error {err} at "
                           "launch")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
