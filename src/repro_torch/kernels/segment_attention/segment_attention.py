"""Segment attention on Hopper: the wrappers of ``csrc/segment_attention.cu``
(flat keys) and ``csrc/paged_segment_attention.cu`` (the block store).

:func:`segment_attention` attends one packed query stream against a flat
key axis ``k/v [N, Kv, D]`` whose every key carries its own position and
segment (``k_pos/k_seg [N]``): the dense serve path's slot rings followed
by the stream's own keys, though any tags are taken.  Key tiles that no
query of a work item admits are skipped before their K/V is read.

:func:`paged_segment_attention`: one packed query stream (prefill chunks
and length-1 decode segments of many requests) attends against the paged
block store through per-slot block tables.  Key positions are implied by
table order and key segments by table row, so no ``[B, M*T]`` logical
view is ever materialized.  Only the table rows of the segments in the
stream are walked, up to their causal horizon.

Both apply the same-segment / written / causal / window predicate per key;
dead lanes (``q_seg < 0``) and lanes no key admits come out as exact zeros.

Two routes each, by the call's shapes alone (:func:`segment_route`,
:func:`paged_segment_route`; each CUDA library's entry point applies the
same rule and reports it through its ``extern "C"`` route function): bf16
at D 64, 120, 128 and 256 (the paged kernel also needs block tokens 8, 16,
32 or 64) runs the tensor-core kernel (wgmma fed by TMA, P rounded to bf16
before it meets V), every other call the CUDA-core kernel.  Neither falls
back to the other.  The tensor-core kernels split the call into work
items, each a (q tile, KV head, live segment of the tile), as
:func:`segment_grid` and :func:`tile_items` state in Python; a one-block
plan kernel lists the live ones and a persistent grid takes them from an
atomic ticket, so a tile of decode riders from several slots walks their
contexts in parallel.

Each wrapper checks device, dtype, shape, contiguity and alignment,
launches on the current stream, raises if the launch failed, and counts
its launches in ``<wrapper>.launches`` and, by route, in
``<wrapper>.route_launches``.  The plain versions are
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
KEY_TILE = 32           # keys per summarised tile, at least (the flat
                        # kernel's scratch: 32 on the CUDA cores, 64 on
                        # the tensor cores)
TILE_ROWS = 64          # (token, query head) rows of a tensor-core work item
ROUTES = ("tensor_core", "cuda_core")
# head dims and block tokens whose bf16 calls run on the tensor cores
TENSOR_CORE_HEAD_DIMS = (64, 120, 128, 256)
TENSOR_CORE_BLOCK_TOKENS = (8, 16, 32, 64)


def segment_route(dtype: torch.dtype, head_dim: int) -> str:
    """The flat kernel a call of this dtype and head dim takes:
    ``"tensor_core"`` for bf16 at D 64, 120, 128 and 256, ``"cuda_core"``
    for f32 at every head dim and bf16 at D 16."""
    if dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def paged_segment_route(dtype: torch.dtype, head_dim: int,
                        block_tokens: int) -> str:
    """The paged kernel a call takes: ``"tensor_core"`` for bf16 at D 64,
    120, 128 and 256 with block tokens 8, 16, 32 or 64 (whole blocks stack
    into 64-key tiles on the 128-byte swizzle's 8-row atoms),
    ``"cuda_core"`` for everything else."""
    if block_tokens in TENSOR_CORE_BLOCK_TOKENS:
        return segment_route(dtype, head_dim)
    return "cuda_core"


def _library_route(library: str, fn: str, *args: int) -> str:
    route = getattr(_build.library(library), fn)
    route.argtypes = [ctypes.c_int] * len(args)
    route.restype = ctypes.c_int
    return ROUTES[0] if route(*args) else ROUTES[1]


def library_segment_route(dtype: torch.dtype, head_dim: int) -> str:
    """What :func:`segment_route` must agree with: the flat library's own
    rule (built on first use)."""
    return _library_route("segment_attention", "segment_attention_route",
                          head_dim, KERNEL_DTYPES[dtype])


def library_paged_segment_route(dtype: torch.dtype, head_dim: int,
                                block_tokens: int) -> str:
    """What :func:`paged_segment_route` must agree with: the paged
    library's own rule."""
    return _library_route("paged_segment_attention",
                          "paged_segment_attention_route", head_dim,
                          KERNEL_DTYPES[dtype], block_tokens)


def segment_grid(p: int, h: int, kv: int,
                 b: int | None = None) -> tuple[int, int, int, int]:
    """The tensor-core kernels' split into work items, from the shapes
    alone: ``(tokens per tile, tiles, head chunks, items per tile)``.  A
    work item's 64 rows are (token, query head) pairs of one KV head:
    ``gc = min(G, 64)`` heads of a chunk (``G = h // kv``; one chunk
    unless G > 64) times ``64 // gc`` tokens.  A tile holds at most as many
    distinct segments as tokens, and the paged kernel's segments are table
    rows, so at most ``b`` of them.  Tiles x ``kv`` x chunks x items per
    tile bounds the work items (and sizes the plan's list); the live ones
    are each tile's :func:`tile_items`."""
    g = h // kv
    gc = min(g, TILE_ROWS)
    bq = TILE_ROWS // gc
    items = bq if b is None else max(1, min(bq, b))
    return bq, -(-p // bq), -(-g // gc), items


def tile_items(q_seg_tile) -> tuple[list[int], list[int]]:
    """One q tile's work items: the distinct live segments of its tokens,
    in the order they open in the stream (item z takes the z-th), and for
    each token the item that writes its rows.  A dead lane (segment < 0)
    is written, as zeros, by item 0, which exists even when no lane is
    live.  The kernels follow the same rule."""
    segs: list[int] = []
    for s in q_seg_tile:
        if s >= 0 and s not in segs:
            segs.append(int(s))
    return segs, [segs.index(s) if s >= 0 else 0 for s in q_seg_tile]


def _work(route: str, p: int, h: int, kv: int, b: int | None,
          dev: torch.device) -> torch.Tensor | None:
    """The tensor-core route's int32 scratch: two counters, then room for
    every (q tile, item) pair the shapes allow (the kernels' plan lists the
    live ones there).  None on the CUDA cores."""
    if route != "tensor_core":
        return None
    _, n_tiles, _, items = segment_grid(p, h, kv, b)
    return torch.empty(2 + n_tiles * items, dtype=torch.int32, device=dev)


@functools.cache
def _flat_launcher():
    fn = _build.library("segment_attention").segment_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
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
    route = segment_route(q.dtype, d)
    work = _work(route, p, h, kv, None, dev)
    err = _flat_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        q_seg.data_ptr(), k_pos.data_ptr(), k_seg.data_ptr(),
        info.data_ptr(), None if work is None else work.data_ptr(),
        out.data_ptr(), p, h, kv, n, d, int(window),
        float(d) ** -0.5, KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"segment_attention: CUDA error {err} at launch")
    segment_attention.launches += 1
    segment_attention.route_launches[route] += 1
    return out


segment_attention.launches = 0
segment_attention.route_launches = dict.fromkeys(ROUTES, 0)


@functools.cache
def _launcher():
    fn = _build.library("paged_segment_attention") \
        .paged_segment_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
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
    route = paged_segment_route(q.dtype, d, t)
    work = _work(route, p, h, kv, b, dev)
    err = _launcher()(
        q.data_ptr(), k_store.data_ptr(), v_store.data_ptr(),
        block_tables.data_ptr(), q_pos.data_ptr(), q_seg.data_ptr(),
        out.data_ptr(), None if work is None else work.data_ptr(), p, h,
        kv, n, t, b, m, d, int(window),
        float(d) ** -0.5, KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged_segment_attention: CUDA error {err} at "
                           "launch")
    paged_segment_attention.launches += 1
    paged_segment_attention.route_launches[route] += 1
    return out


paged_segment_attention.launches = 0
paged_segment_attention.route_launches = dict.fromkeys(ROUTES, 0)
