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
  in the same buckets, not one call a leaf (each call pays a gloo
  barrier at least).
* :class:`ModelParallel` and the tensor-parallel training collectives
  over ``model`` (the Megatron layout the reference's GSPMD arrives at
  under ``DEFAULT_RULES``): the conjugate pair :func:`copy_to_model`
  (identity forward, gradient summed over ``model``) and
  :func:`reduce_from_model` (forward summed, gradient passed through),
  the second pair :func:`sum_to_slice` (forward summed and cut to this
  rank's slice, gradient all-gathered) and :func:`gather_from_slice`
  (forward all-gathered, gradient summed and cut), which the recurrent
  blocks' forms take, the vocab-parallel :func:`vocab_embed` and
  :func:`vocab_cross_entropy`, and :meth:`ModelParallel.sum_buckets`
  for the gradients of leaves a rank uses only in part.  Each keeps
  shapes and carries nothing on ``meta`` (the dry-run), where
  :class:`ModelParallel` counts its calls and bytes all the same.  The
  forward is handed the
  :class:`ModelParallel` of its step explicitly (``tp=``): nothing here
  reads :func:`~repro_torch.distributed.sharding.current_mesh`, so
  serving's head-parallel wrappers stay off inside a training step, and
  the forward that non-reentrant ``checkpoint`` recomputes inside the
  backward pass (on autograd's thread) reaches the same collectives.
* :func:`quantize_int8`, :func:`dequantize_int8` and
  :func:`compressed_psum_grads` — the reference's int8 block-quantized
  gradient mean, as it is: a MAX all-reduce agrees on each 128-block's
  scale, the int8 payload is summed as int32, so the bytes it moves
  equal f32's (the reference's docstring counts int8's).

Without an active serving mesh (:func:`~repro_torch.distributed.sharding
.use_mesh`), or when the model axis does not divide both head counts,
the wrappers call the plain ops.

The transport follows the payload's device alone, as the kernels'
wrappers do (``kernels.use_plain``): a CUDA tensor goes through the
group's CUDA IPC arena (:mod:`repro_torch.distributed.ipc`: the ranks
share the card, copy their payloads into slots every peer has mapped, and
each rank folds or concatenates them on the card in rank order, gloo
carrying only a barrier a chunk), a CPU tensor through gloo.  The gloo
path raises on any other tensor, so no CUDA payload crosses host memory;
a failure to open a handle is an error, not a fallback.
:func:`agreed_clock` and :func:`agreed_flag` carry host decisions on CPU
tensors, over gloo.

``sp_decode_combine`` (the sequence-parallel decode combine) is not
ported: no port path reads it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.bridge import keyed_leaves, keyed_map, tree_map

from . import ipc
from .sharding import TP_SPLITS, current_mesh, keyed_specs

__all__ = ["tp_segment_attention", "tp_paged_segment_attention",
           "tp_paged_decode_attention", "tp_decode_attention",
           "own_heads", "all_reduce", "all_gather", "agreed_clock",
           "agreed_flag", "reduce_f32_buckets", "gather_leaves",
           "quantize_int8", "dequantize_int8", "compressed_psum_grads",
           "BUCKET_BYTES", "ModelParallel", "copy_to_model",
           "reduce_from_model", "sum_to_slice", "gather_from_slice",
           "vocab_embed", "vocab_cross_entropy"]

_BLOCK = 128
# the bytes a training collective packs into one flat bucket
BUCKET_BYTES = 256 * 2**20


def _gloo(x: torch.Tensor) -> torch.Tensor:
    """``x`` for gloo, which carries CPU tensors only: any other raises
    (a CUDA payload takes the IPC arena, never a trip through the
    host)."""
    if x.device.type != "cpu":
        raise ValueError(f"gloo carries CPU tensors, not a {x.device} "
                         f"tensor {tuple(x.shape)}")
    return x


def _reduce(x: torch.Tensor, group, op, out=None) -> torch.Tensor:
    """``x`` reduced by ``op`` over ``group``: into ``out`` (contiguous,
    x's shape; ``x`` itself may be it), else a new tensor."""
    if x.is_cuda:
        return ipc.arena(group, x.device).all_reduce(x, op, out=out)
    if out is None:
        out = _gloo(x).clone()
    elif out is not x:
        out.copy_(_gloo(x))
    dist.all_reduce(_gloo(out), op=op, group=group)
    return out


def all_reduce(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM):
    """``x`` reduced by ``op`` (a sum by default) over the mesh axes
    ``axes`` (a new tensor on x's device; ``x`` itself when the group is
    one rank)."""
    if mesh.axis_size(axes) == 1:
        return x
    return _reduce(x, mesh.group(axes), op)


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
    fresh tensor), on the inputs' device.  On ``meta`` (the dry-run) the
    sum carries nothing."""
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
        if group and not flat.is_meta:
            _reduce(flat, mesh.group(axes), dist.ReduceOp.SUM, out=flat)
        off = 0
        for i in run:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape).clone()
            off += n
        del flat
    return out


def gather_leaves(tree, placement, axes=None):
    """The tree gathered over the mesh ``axes`` (every axis when None)
    from this rank's slices under ``placement`` (a
    :class:`~repro_torch.distributed.sharding.Placement`): every dim split
    over those axes all-gathered, as bytes, in flat buckets of at most
    :data:`BUCKET_BYTES` a rank (each leaf 16-byte aligned in it); dims
    split over other axes stay this rank's slices (the tensor-parallel
    step gathers over ``data`` and keeps its ``model`` slice).  A leaf
    split on two dims (``("data", "model", None)``) is gathered one axis
    group after the other, in the same order on every rank.  On ``meta``
    (the dry-run) each gathered leaf is made in one piece, without the
    bucket."""
    keys, leaves = zip(*keyed_leaves(tree))
    specs = dict(keyed_specs(placement.specs))
    todo: dict[tuple, list[tuple[int, int]]] = {}
    for i, spec in enumerate(specs[k] for k in keys):
        for dim, group in placement.sharded_dims(spec):
            if axes is not None and not set(group) <= set(axes):
                if set(group) & set(axes):
                    raise ValueError(f"{keys[i]}: dim {dim} is split over "
                                     f"{group}, gathered over {axes}")
                continue
            todo.setdefault(group, []).append((i, dim))
    full = list(leaves)
    for group_axes in sorted(todo):
        idx = todo[group_axes]
        n = placement.mesh.axis_size(group_axes)
        group = placement.mesh.group(group_axes)
        sizes = [full[i].numel() * full[i].element_size() for i, _ in idx]
        # each leaf at a 16-byte offset of its bucket, so that its bytes
        # view as its dtype whatever leaves come before it
        spans = [-(-nb // 16) * 16 for nb in sizes]
        for run in _buckets(spans, BUCKET_BYTES):
            dev = full[idx[run[0]][0]].device
            if dev.type == "meta":
                # the dry-run: nothing to carry, the gathered shapes
                for j in run:
                    i, dim = idx[j]
                    full[i] = torch.cat([full[i]] * n, dim=dim)
                continue
            flat = torch.zeros(sum(spans[j] for j in run),
                               dtype=torch.uint8, device=dev)
            off = 0
            for j in run:
                flat[off:off + sizes[j]] = (full[idx[j][0]].contiguous()
                                            .reshape(-1).view(torch.uint8))
                off += spans[j]
            rows = _gather_rows(flat, group, n)
            off = 0
            for j in run:
                i, dim = idx[j]
                x, nb = full[i], sizes[j]
                full[i] = ipc.concat([r[off:off + nb] for r in rows],
                                     x.dtype, x.shape, dim)
                off += spans[j]
            del flat, rows
    by_key = dict(zip(keys, full))
    return keyed_map(lambda k, _: by_key[k], tree)


def _gather_rows(flat: torch.Tensor, group, n: int):
    """The ``n`` ranks' 1-D uint8 ``flat`` in rank order: rows of a
    ``[n, bytes]`` tensor on the card, a list of CPU tensors on gloo."""
    if flat.is_cuda:
        return ipc.arena(group, flat.device).gather_rows(flat)
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, _gloo(flat), group=group)
    return parts


def all_gather(x: torch.Tensor, mesh, axis_name: str, dim: int):
    """The ``axis_name`` group's tensors concatenated along ``dim`` in rank
    order (``jax.lax.all_gather(..., tiled=True)``)."""
    n = mesh.axis_size(axis_name)
    if n == 1:
        return x
    flat = x.contiguous().view(-1).view(torch.uint8)
    rows = _gather_rows(flat, mesh.group(axis_name), n)
    return ipc.concat(rows, x.dtype, x.shape, dim)


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


# ---------------------------------------------------------------------------
# tensor-parallel training over ``model``
# ---------------------------------------------------------------------------


class ModelParallel:
    """The ``model`` axis of a training step's mesh, as its forward and
    backward read it: ``mesh``, ``size`` (M), ``index`` (this rank's
    model position) and ``split``, which of the logical families
    (``heads``, ``kv_heads``, ``vocab``, ``experts``) and which blocks'
    ``ff`` dims (``mlp``, ``rglru``, ``tm_cm``, ``shared``) the step's
    placement splits over ``model`` (``sharding.model_split``: an entry
    whose dim ``model`` does not divide stays replicated, and the form
    that reads it runs whole).  ``counts`` holds
    the calls and bytes of the collectives over ``model`` this rank has
    run, by kind (``"all-reduce"``, ``"all-gather"``: the bytes a rank
    hands the call), on ``meta`` too (where they carry nothing);
    ``calls`` and ``bytes`` are their totals."""

    def __init__(self, mesh, split: dict) -> None:
        self.mesh = mesh
        self.size = mesh.shape["model"]
        self.index = mesh.model_index
        self.split = {f: bool(split.get(f, False)) for f in TP_SPLITS}
        self.reset()

    def reset(self) -> None:
        """Set the counts to 0."""
        self.counts = {"all-reduce": [0, 0], "all-gather": [0, 0]}

    @property
    def calls(self) -> int:
        return sum(c for c, _ in self.counts.values())

    @property
    def bytes(self) -> int:
        return sum(b for _, b in self.counts.values())

    def kv_span(self, heads: int, kv_heads: int) -> tuple[int, int]:
        """``(first, count)`` of the KV heads this rank's chunk of
        ``heads / M`` query heads reads when the KV heads are replicated
        (query head ``h`` reads KV head ``h // (heads / kv_heads)``).
        Raises ``ValueError`` when the chunk straddles two GQA groups."""
        local, group = heads // self.size, heads // kv_heads
        if local % group and group % local:
            raise ValueError(
                f"{heads} query heads over {self.size} model ranks give "
                f"chunks of {local}, which straddle the GQA groups of "
                f"{group} (KV heads {kv_heads}, replicated over model)")
        return self.index * local // group, max(local // group, 1)

    def own(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's contiguous ``1/M`` of ``x`` along ``dim`` (a view)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)

    def _note(self, op: str, nbytes: int) -> None:
        c = self.counts[op]
        c[0] += 1
        c[1] += nbytes

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM):
        """``x`` reduced over ``model`` in f32, back in x's dtype (a new
        tensor; shapes alone on ``meta``)."""
        self._note("all-reduce", x.numel() * 4)
        if x.is_meta:
            return torch.empty_like(x)
        return all_reduce(x.float(), self.mesh, "model", op=op).to(x.dtype)

    def all_gather(self, x: torch.Tensor, dim: int = -1):
        """The ranks' ``x`` concatenated along ``dim`` in ``model`` order
        (shapes alone on ``meta``)."""
        self._note("all-gather", x.numel() * x.element_size())
        if x.is_meta:
            return torch.cat([x] * self.size, dim=dim)
        return all_gather(x, self.mesh, "model", dim)

    def sum_buckets(self, tensors: list) -> list:
        """:func:`reduce_f32_buckets` over ``model``, counted a call a
        bucket."""
        sizes = [t.numel() * 4 for t in tensors]
        for run in _buckets(sizes, BUCKET_BYTES):
            self._note("all-reduce", sum(sizes[i] for i in run))
        return reduce_f32_buckets(tensors, self.mesh, "model")


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mp.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        return mp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumToSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return mp.own(mp.all_reduce(x), dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mp.all_gather(g, ctx.dim), None, None


class _GatherFromSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return mp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mp.own(ctx.mp.all_reduce(g), ctx.dim).contiguous(), \
            None, None


def copy_to_model(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """``x`` (replicated over ``model``) entering a column-parallel
    region: the identity, whose gradient is summed over ``model`` (each
    rank's products give a part of it)."""
    return _CopyToModel.apply(x, mp)


def reduce_from_model(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """A row-parallel region's partial output summed over ``model`` (in
    f32, rounded once to x's dtype); its gradient passes through."""
    return _ReduceFromModel.apply(x, mp)


def sum_to_slice(x: torch.Tensor, mp: ModelParallel,
                 dim: int = -1) -> torch.Tensor:
    """This rank's ``1/M`` along ``dim`` of the sum over ``model`` of the
    ranks' partial products ``x`` (in f32, rounded once to x's dtype):
    an all-reduce, then this rank's slice.  Each rank goes on with a
    different slice, so the gradient of its ``x`` is every rank's slice
    gradient put together: an all-gather along ``dim``
    (:func:`reduce_from_model`'s passed-through gradient holds only when
    every rank goes on with the whole sum)."""
    return _SumToSlice.apply(x, mp, dim)


def gather_from_slice(x: torch.Tensor, mp: ModelParallel,
                      dim: int = -1) -> torch.Tensor:
    """The ranks' slices ``x`` put together along ``dim`` (an all-gather),
    for a computation every rank repeats whole and then uses in part: the
    gradient of the whole is a part on each rank, so this rank's slice
    of its sum over ``model`` is ``x``'s (the conjugate of
    :func:`sum_to_slice`)."""
    return _GatherFromSlice.apply(x, mp, dim)


def vocab_embed(table: torch.Tensor, ids: torch.Tensor,
                mp: ModelParallel) -> torch.Tensor:
    """The embedding of ``ids`` from this rank's rows ``table`` [V/M, d]
    of a vocab-split table: ids outside its rows give zeros, the ranks'
    lookups summed over ``model`` (exact: one rank holds each id)."""
    rows = table.shape[0]
    local = ids.long() - mp.index * rows
    own = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)]
    x = torch.where(own[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return reduce_from_model(x, mp)


class _VocabCrossEntropy(torch.autograd.Function):
    """Summed cross-entropy of f32 logits split over ``model`` on the
    vocab dim: [..., V/M] this rank's columns, labels global ids."""

    @staticmethod
    def forward(ctx, logits, labels, mp):
        cols = logits.shape[-1]
        local = labels.long() - mp.index * cols
        own = (local >= 0) & (local < cols)
        top = mp.all_reduce(logits.amax(dim=-1), op=dist.ReduceOp.MAX)
        e = torch.exp(logits - top[..., None])
        total = mp.all_reduce(e.sum(dim=-1))
        gold = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None])
        gold = torch.where(own, gold[..., 0], torch.zeros(
            (), dtype=logits.dtype, device=logits.device))
        gold = mp.all_reduce(gold)
        ctx.save_for_backward(e, total, local, own)
        return (top + torch.log(total) - gold).sum()

    @staticmethod
    def backward(ctx, g):
        e, total, local, own = ctx.saved_tensors
        d = e / total[..., None]
        d.scatter_add_(-1, local.clamp(0, d.shape[-1] - 1)[..., None],
                       -own[..., None].to(d.dtype))
        return d * g, None, None


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        mp: ModelParallel) -> torch.Tensor:
    """``sum(logsumexp(logits) - logits[label])`` over every row, the
    logits ``[..., V/M]`` this rank's columns: a MAX all-reduce of the
    row maxima (no gradient), a summed one of ``sum exp``, and the gold
    logit from the rank that holds it.  Its gradient is ``softmax -
    onehot`` on the local columns."""
    return _VocabCrossEntropy.apply(logits, labels, mp)
