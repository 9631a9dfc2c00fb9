"""Paged segment attention on Hopper: the wrapper of
``csrc/paged_segment_attention.cu``.

One packed query stream (prefill chunks and length-1 decode segments of
many requests) attends against the paged block store through per-slot
block tables.  Key positions are implied by table order and key segments
by table row, so no ``[B, M*T]`` logical view is ever materialized.  The
same-segment / written / causal / window predicate is applied per key, and
each CTA walks only the table rows of the segments in its q tile, up to
their causal horizon.  Dead lanes (``q_seg < 0``) and lanes no key admits
come out as exact zeros.

The wrapper checks device, dtype, shape, contiguity and alignment, launches
on the current stream, raises if the launch failed, and counts launches in
``paged_segment_attention.launches``.  The plain version is
:func:`~repro_torch.kernels.segment_attention.ref
.paged_segment_attention_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (HEAD_DIMS, KERNEL_DTYPES, _build,
                                 check_operand)

MAX_BLOCK_TOKENS = 64   # K/V block tiles live in shared memory
MAX_GROUP = 64          # query heads per KV head a CTA can hold


@functools.cache
def _launcher():
    fn = _build.library("segment_attention").paged_segment_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def paged_segment_attention(q: torch.Tensor, k_store: torch.Tensor,
                            v_store: torch.Tensor,
                            block_tables: torch.Tensor, q_pos: torch.Tensor,
                            q_seg: torch.Tensor, *,
                            window: int = 0) -> torch.Tensor:
    """q: [P, H, D]; k_store/v_store: [N, Kv, T, D]; block_tables: [B, M]
    int32 (-1 = unallocated); q_pos/q_seg: [P] int32 (segment id ==
    block-table row, -1 = dead lane) -> [P, H, D] in q's dtype.  CUDA
    tensors only."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_segment_attention kernel needs CUDA "
                         f"tensors, got {dev}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"q: dtype {q.dtype} not in {list(KERNEL_DTYPES)}")
    check_operand("q", q, dtype=q.dtype, ndim=3, device=dev)
    check_operand("k_store", k_store, dtype=q.dtype, ndim=4, device=dev)
    check_operand("v_store", v_store, dtype=q.dtype, ndim=4, device=dev)
    check_operand("block_tables", block_tables, dtype=torch.int32, ndim=2,
                  device=dev, align=4)
    check_operand("q_pos", q_pos, dtype=torch.int32, ndim=1, device=dev,
                  align=4)
    check_operand("q_seg", q_seg, dtype=torch.int32, ndim=1, device=dev,
                  align=4)
    p, h, d = q.shape
    n, kv, t, d2 = k_store.shape
    b, m = block_tables.shape
    if v_store.shape != k_store.shape or d2 != d:
        raise ValueError(f"store shapes {tuple(k_store.shape)} / "
                         f"{tuple(v_store.shape)} do not match q {tuple(q.shape)}")
    if q_pos.shape[0] != p or q_seg.shape[0] != p:
        raise ValueError("q_pos / q_seg must have one entry per query")
    if h % kv or h // kv > MAX_GROUP:
        raise ValueError(f"{h} query heads over {kv} KV heads: need an "
                         f"integer group of at most {MAX_GROUP}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not 1 <= t <= MAX_BLOCK_TOKENS:
        raise ValueError(f"block_tokens {t} outside [1, {MAX_BLOCK_TOKENS}]")
    out = torch.empty_like(q)
    if p == 0 or b == 0 or m == 0 or n == 0:
        return out.zero_()
    err = _launcher()(
        q.data_ptr(), k_store.data_ptr(), v_store.data_ptr(),
        block_tables.data_ptr(), q_pos.data_ptr(), q_seg.data_ptr(),
        out.data_ptr(), p, h, kv, n, t, b, m, d, int(window),
        float(d) ** -0.5, KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged_segment_attention: CUDA error {err} at "
                           "launch")
    paged_segment_attention.launches += 1
    return out


paged_segment_attention.launches = 0
