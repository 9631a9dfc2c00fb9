"""Segment attention on Hopper: the wrappers of ``csrc/segment_attention.cu``
(flat keys) and ``csrc/paged_segment_attention.cu`` (the block store).

:func:`segment_attention` attends one packed query stream against a flat
key axis ``k/v [N, Kv, D]`` whose every key carries its own position and
segment (``k_pos/k_seg [N]``): the dense serve path's slot rings followed
by the stream's own keys, though any tags are taken.  Key tiles that no
query of a q tile admits are skipped before their K/V is read.

:func:`paged_segment_attention`: one packed query stream (prefill chunks and length-1 decode segments of
many requests) attends against the paged block store through per-slot
block tables.  Key positions are implied by table order and key segments
by table row, so no ``[B, M*T]`` logical view is ever materialized.  The
same-segment / written / causal / window predicate is applied per key, and
each CTA walks only the table rows of the segments in its q tile, up to
their causal horizon.  Dead lanes (``q_seg < 0``) and lanes no key admits
come out as exact zeros.

Each wrapper checks device, dtype, shape, contiguity and alignment,
launches on the current stream, raises if the launch failed, and counts
its launches in ``<wrapper>.launches``.  The plain versions are
:func:`~repro_torch.kernels.segment_attention.ref.segment_attention_ref`
and :func:`~repro_torch.kernels.segment_attention.ref
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


KEY_TILE = 32           # keys per tile of the flat kernel (its summaries)


@functools.cache
def _flat_launcher():
    fn = _build.library("segment_attention").segment_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def segment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor,
                      q_seg: torch.Tensor, k_seg: torch.Tensor, *,
                      window: int = 0) -> torch.Tensor:
    """q: [P, H, D]; k/v: [N, Kv, D]; q_pos/q_seg: [P] int32 (-1 segment =
    dead lane); k_pos/k_seg: [N] int32 (-1 position = unwritten) -> [P, H,
    D] in q's dtype.  CUDA tensors only."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"segment_attention kernel needs CUDA tensors, got "
                         f"{dev}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"q: dtype {q.dtype} not in {list(KERNEL_DTYPES)}")
    check_operand("q", q, dtype=q.dtype, ndim=3, device=dev)
    check_operand("k", k, dtype=q.dtype, ndim=3, device=dev)
    check_operand("v", v, dtype=q.dtype, ndim=3, device=dev)
    for name, t in (("q_pos", q_pos), ("q_seg", q_seg), ("k_pos", k_pos),
                    ("k_seg", k_seg)):
        check_operand(name, t, dtype=torch.int32, ndim=1, device=dev,
                      align=4)
    p, h, d = q.shape
    n, kv, d2 = k.shape
    if v.shape != k.shape or d2 != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)} / {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if q_pos.shape[0] != p or q_seg.shape[0] != p:
        raise ValueError("q_pos / q_seg must have one entry per query")
    if k_pos.shape[0] != n or k_seg.shape[0] != n:
        raise ValueError("k_pos / k_seg must have one entry per key")
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    if p == 0 or h == 0:
        return out
    if n == 0:
        return out.zero_()
    info = torch.empty(4 * -(-n // KEY_TILE), dtype=torch.int32, device=dev)
    err = _flat_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        q_seg.data_ptr(), k_pos.data_ptr(), k_seg.data_ptr(),
        info.data_ptr(), out.data_ptr(), p, h, kv, n, d, int(window),
        float(d) ** -0.5, KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"segment_attention: CUDA error {err} at launch")
    segment_attention.launches += 1
    return out


segment_attention.launches = 0


@functools.cache
def _launcher():
    fn = _build.library("paged_segment_attention") \
        .paged_segment_attention_launch
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
