"""Serving tensor-parallel wrappers and the collectives under them.

The serving part of the reference's ``distributed/collectives.py``, for a
mesh of processes (:mod:`repro_torch.launch.mesh`) in place of a device
mesh under ``shard_map``:

* :func:`tp_segment_attention` / :func:`tp_paged_segment_attention` — the
  head-sharded segment attention of the packed tick.  A rank holds only
  its contiguous chunk of the KV heads (its slice of the block stores and
  dense rings), slices q to the matching chunk of query heads, runs the
  single-device op on that chunk, and all-gathers the ``[P, H/M, D]``
  outputs over ``model`` along the head axis.  Pure data movement, so the
  result equals the single-device op's bit for bit.
* :func:`tp_paged_decode_attention` / :func:`tp_decode_attention` — the
  same for the decode step.  The reference needs no such wrappers (its
  decode runs on arrays GSPMD keeps sharded); a rank of the port holds
  only its slice, so its decode runs on its head chunk too.  Both decode
  kernels plan their key split from the shapes, so each passes
  ``split_groups``, the global (row, KV head) count: a shard then launches
  the single-device plan over its own heads, and its heads sum in the
  single-device order.
* :func:`own_heads` — this rank's chunk of a full head axis (the K/V a
  step writes into its slice of the cache).
* :func:`all_reduce`, :func:`all_gather` and :func:`agreed_clock`.
* :func:`reduce_f32_buckets` and :func:`gather_leaves` — data-parallel
  training's two collectives (``train_step.make_mesh_train_step``): the
  gradients cast to f32 and summed in a few flat buckets of at most
  :data:`BUCKET_BYTES`, and FSDP's sliced leaves all-gathered as bytes
  in the same buckets, not one call a leaf (each call pays gloo's host
  round trip).
* :func:`quantize_int8`, :func:`dequantize_int8` and
  :func:`compressed_psum_grads` — the reference's int8 block-quantized
  gradient mean, as it is: a MAX all-reduce agrees on each 128-block's
  scale, the int8 payload is summed as int32, so the bytes it moves
  equal f32's (the reference's docstring counts int8's).

Without an active serving mesh (:func:`~repro_torch.distributed.sharding
.use_mesh`), or when the model axis does not divide both head counts,
the wrappers call the plain ops.

Gloo carries every collective.  Its all-gather takes CPU tensors only, so
a CUDA tensor is always copied to host memory, reduced or gathered there,
and copied back — in this module, on every call, not as a fallback.

``sp_decode_combine`` (the sequence-parallel decode combine) is not
ported: no port path reads it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.bridge import keyed_leaves, keyed_map, tree_map

from .sharding import current_mesh, keyed_specs

__all__ = ["tp_segment_attention", "tp_paged_segment_attention",
           "tp_paged_decode_attention", "tp_decode_attention",
           "own_heads", "all_reduce", "all_gather", "agreed_clock",
           "agreed_flag", "reduce_f32_buckets", "gather_leaves",
           "quantize_int8", "dequantize_int8", "compressed_psum_grads",
           "BUCKET_BYTES"]

_BLOCK = 128
# host bytes a training collective stages at a time
BUCKET_BYTES = 256 * 2**20


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.cpu() if x.is_cuda else x


def all_reduce(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM):
    """``x`` reduced by ``op`` (a sum by default) over the mesh axes
    ``axes`` (a new tensor on x's device; ``x`` itself when the group is
    one rank)."""
    if mesh.axis_size(axes) == 1:
        return x
    h = _host(x).clone()
    dist.all_reduce(h, op=op, group=mesh.group(axes))
    return h.to(x.device)


def agreed_flag(flag: bool, mesh) -> bool:
    """True on every rank of ``mesh`` when ``flag`` is True on any (a MAX
    all-reduce): a host decision every rank must take alike."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    return bool(all_reduce(t, mesh, ("data", "model"),
                           op=dist.ReduceOp.MAX).item())


def _buckets(sizes: list[int], limit: int) -> list[list[int]]:
    """Consecutive index runs whose sizes sum to at most ``limit`` (a
    larger item gets a run of its own)."""
    out: list[list[int]] = []
    total = limit
    for i, n in enumerate(sizes):
        if total + n > limit:
            out.append([])
            total = 0
        out[-1].append(i)
        total += n
    return out


def reduce_f32_buckets(tensors: list, mesh, axes) -> list:
    """Each tensor cast to f32 and summed over ``axes``, a few flat
    buckets to a collective: new f32 tensors of the inputs' shapes, each
    an allocation of its own (so a reduction over one runs as over any
    fresh tensor), on the inputs' device."""
    group = mesh.axis_size(axes) > 1
    out: list = [None] * len(tensors)
    for run in _buckets([t.numel() * 4 for t in tensors], BUCKET_BYTES):
        dev = tensors[run[0]].device
        flat = torch.empty(sum(tensors[i].numel() for i in run),
                           dtype=torch.float32, device=dev)
        off = 0
        for i in run:
            n = tensors[i].numel()
            flat[off:off + n].copy_(tensors[i].reshape(-1))
            off += n
        if group:
            h = _host(flat)
            dist.all_reduce(h, group=mesh.group(axes))
            flat = h.to(dev)
        off = 0
        for i in run:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape).clone()
            off += n
        del flat
    return out


def gather_leaves(tree, placement):
    """The full tree from this rank's slices under ``placement`` (a
    :class:`~repro_torch.distributed.sharding.Placement`): every sharded
    leaf's slices all-gathered along its sharded dim, as bytes, in flat
    buckets of at most :data:`BUCKET_BYTES` a rank.  A leaf may be split on
    one dim only; unsplit leaves come back as they are."""
    keys, leaves = zip(*keyed_leaves(tree))
    specs = dict(keyed_specs(placement.specs))
    todo: dict[tuple, list[int]] = {}
    where: dict[int, tuple[int, tuple]] = {}
    for i, (x, spec) in enumerate(zip(leaves, (specs[k] for k in keys))):
        dims = placement.sharded_dims(spec)
        if not dims:
            continue
        if len(dims) > 1:
            raise ValueError(f"a leaf split on dims {dims}: gather_leaves "
                             "takes one split dim a leaf")
        where[i] = dims[0]
        todo.setdefault(dims[0][1], []).append(i)
    full = list(leaves)
    for axes, idx in todo.items():
        n = placement.mesh.axis_size(axes)
        group = placement.mesh.group(axes)
        sizes = [leaves[i].numel() * leaves[i].element_size() for i in idx]
        for run in _buckets(sizes, BUCKET_BYTES):
            dev = leaves[idx[run[0]]].device
            flat = torch.cat([leaves[idx[j]].contiguous().reshape(-1)
                              .view(torch.uint8) for j in run])
            h = _host(flat)
            parts = [torch.empty_like(h) for _ in range(n)]
            dist.all_gather(parts, h, group=group)
            off = 0
            for j in run:
                i = idx[j]
                x, nb = leaves[i], sizes[j]
                pieces = [p[off:off + nb].view(x.dtype).view(x.shape)
                          for p in parts]
                full[i] = torch.cat(pieces, dim=where[i][0]).to(dev)
                off += nb
            del flat, parts, h
    by_key = dict(zip(keys, full))
    return keyed_map(lambda k, _: by_key[k], tree)


def all_gather(x: torch.Tensor, mesh, axis_name: str, dim: int):
    """The ``axis_name`` group's tensors concatenated along ``dim`` in rank
    order (``jax.lax.all_gather(..., tiled=True)``)."""
    n = mesh.axis_size(axis_name)
    if n == 1:
        return x
    h = _host(x).contiguous()
    parts = [torch.empty_like(h) for _ in range(n)]
    dist.all_gather(parts, h, group=mesh.group(axis_name))
    return torch.cat(parts, dim=dim).to(x.device)


def agreed_clock(clock, mesh):
    """``clock`` as every rank of ``mesh`` reads it together: each reading
    is the MAX over the ranks, so every host decision that reads time
    (sensors, controllers, SLO gates, telemetry) sees the same number on
    every rank, the slowest rank's — the one a user waits for.  Every rank
    must read it at the same points, which they do while their decisions
    agree and their options are the same: telemetry reads it too, so
    every rank serves with a hub or none does."""
    if mesh.size == 1:
        return clock

    def read() -> float:
        t = torch.tensor([float(clock())], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX,
                        group=mesh.group(("data", "model")))
        return float(t.item())

    return read


def _serve_tp_mesh(heads: int, kv_heads: int):
    """The active mesh iff serving TP applies to this op's head counts.

    Requires a live ``use_mesh`` context with a non-trivial ``model`` axis
    that divides BOTH head counts — contiguous head chunks then preserve the
    GQA group mapping (local ``h // (H_loc/Kv_loc)`` equals the global
    grouping), so the per-shard op is the single-device math on a head
    slice.  Anything else returns None and the caller runs unsharded."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return None
    s = mesh.shape["model"]
    if s <= 1 or heads % s or kv_heads % s:
        return None
    return mesh


def _model_size() -> int:
    mesh = current_mesh()
    return mesh.shape["model"] if mesh is not None else 1


def _chunk(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's contiguous ``model`` chunk of ``x`` along ``dim``."""
    n = x.shape[dim] // mesh.shape["model"]
    return x.narrow(dim, mesh.model_index * n, n)


def own_heads(x: torch.Tensor, n_local: int, dim: int = 1) -> torch.Tensor:
    """This rank's chunk of ``n_local`` heads of ``x``'s full head axis
    ``dim`` (x itself when it already has ``n_local``): a rank writes only
    its own KV heads into its slice of the cache."""
    if x.shape[dim] == n_local:
        return x
    mesh = current_mesh()
    if mesh is None or x.shape[dim] != n_local * mesh.shape["model"]:
        raise ValueError(f"{x.shape[dim]} heads against a cache slice of "
                         f"{n_local} and mesh {mesh}")
    return _chunk(x, mesh, dim)


def _head_parallel(op, q, kv_local: int, *args, **kw):
    """``op(q, *args, **kw)`` where ``args`` hold this rank's KV chunk
    (``kv_local`` heads): on q's matching head chunk, the outputs
    all-gathered over ``model`` along the head axis (1)."""
    mesh = _serve_tp_mesh(q.shape[1], kv_local * _model_size())
    if mesh is None:
        return op(q, *args, **kw)
    o = op(_chunk(q, mesh, 1).contiguous(), *args, **kw)
    return all_gather(o, mesh, "model", dim=1)


def tp_segment_attention(q, k, v, q_pos, k_pos, q_seg, k_seg, *,
                         window: int = 0):
    """Head-sharded flat segment attention: q [P,H,D] (all heads); k, v
    [N,Kv/M,D] (this rank's KV chunk) -> [P,H,D]."""
    from repro_torch.kernels.segment_attention import segment_attention_op
    return _head_parallel(segment_attention_op, q, k.shape[1], k, v, q_pos,
                          k_pos, q_seg, k_seg, window=window)


def tp_paged_segment_attention(q, k_store, v_store, block_tables, q_pos,
                               q_seg, *, window: int = 0):
    """Head-sharded paged segment attention: q [P,H,D]; stores
    [N,Kv/M,T,D] (this rank's slice).  Block indices (tables, positions,
    segments) are global and the same on every rank."""
    from repro_torch.kernels.segment_attention import \
        paged_segment_attention_op
    return _head_parallel(paged_segment_attention_op, q, k_store.shape[1],
                          k_store, v_store, block_tables, q_pos, q_seg,
                          window=window)


def tp_paged_decode_attention(q, k_store, v_store, block_tables, q_pos, *,
                              window: int = 0):
    """Head-sharded paged decode: q [B,H,D]; stores [N,Kv/M,T,D] -> [B,H,D],
    the key split planned for the global ``B * Kv`` pairs."""
    from repro_torch.kernels.paged_attention import paged_decode_attention_op
    kv = k_store.shape[1] * _model_size()
    return _head_parallel(paged_decode_attention_op, q, k_store.shape[1],
                          k_store, v_store, block_tables, q_pos,
                          window=window, split_groups=q.shape[0] * kv)


def tp_decode_attention(q, k, v, k_pos, q_pos, *, window: int = 0):
    """Head-sharded dense decode: q [B,H,D]; k, v [B,Kv/M,S,D] (views of
    this rank's rings) -> [B,H,D], the key split planned for the global
    ``B * Kv`` pairs."""
    from repro_torch.kernels.decode_attention import decode_attention_op
    kv = k.shape[1] * _model_size()
    return _head_parallel(decode_attention_op, q, k.shape[1], k, v, k_pos,
                          q_pos, window=window, split_groups=q.shape[0] * kv)


def quantize_int8(x: torch.Tensor, scale: torch.Tensor | None = None):
    """Blockwise symmetric int8 quantization of ``x`` flattened, in blocks
    of 128 (the last padded with zeros); a block of zeros takes scale 1.
    Pass a precomputed (e.g. agreed) ``scale`` [n_blocks, 1] to share
    ranges across the participants of a compressed collective.  Returns
    ``(q [n_blocks, 128] int8, scale, x's shape)``."""
    orig_shape = tuple(x.shape)
    flat = x.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    if scale is None:
        scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
        scale = torch.where(scale == 0.0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, orig_shape


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    orig_shape) -> torch.Tensor:
    """``q * scale`` in f32, the padding cut, in ``orig_shape``."""
    out = (q.float() * scale).reshape(-1)
    size = 1
    for s in orig_shape:
        size *= s
    return out[:size].reshape(orig_shape)


def compressed_psum_grads(grads, mesh, axis_name: str):
    """The mean of ``grads`` (a tree) over ``axis_name``, in int8 with
    int32 sums, leaf by leaf: (1) agree on each block's scale, the MAX of
    the ranks' block maxima over 127 (an f32 all-reduce of 1/128 of the
    payload), (2) quantize with it, (3) sum the payload as int32, (4)
    dequantize and divide by the group's size.  Each leaf comes back in
    its own dtype."""
    n = float(mesh.axis_size(axis_name))

    def one(g):
        flat = g.float().reshape(-1)
        flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % _BLOCK))
        local = flat.reshape(-1, _BLOCK).abs().amax(dim=1, keepdim=True)
        glob = all_reduce(local, mesh, axis_name,
                          op=dist.ReduceOp.MAX) / 127.0
        glob = torch.where(glob == 0.0, 1.0, glob)
        q, _, shape = quantize_int8(g, scale=glob)
        summed = all_reduce(q.to(torch.int32), mesh, axis_name)
        return (dequantize_int8(summed, glob, shape) / n).to(g.dtype)

    return tree_map(one, grads)
