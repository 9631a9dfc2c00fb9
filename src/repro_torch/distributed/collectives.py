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

Without an active serving mesh (:func:`~repro_torch.distributed.sharding
.use_mesh`), or when the model axis does not divide both head counts,
the wrappers call the plain ops.

Gloo carries every collective.  Its all-gather takes CPU tensors only, so
a CUDA tensor is always copied to host memory, reduced or gathered there,
and copied back — in this module, on every call, not as a fallback.

Training's ``quantize_int8``, ``dequantize_int8`` and
``compressed_psum_grads`` are ROADMAP Queue 1 item 11b and not ported.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import current_mesh

__all__ = ["tp_segment_attention", "tp_paged_segment_attention",
           "tp_paged_decode_attention", "tp_decode_attention",
           "own_heads", "all_reduce", "all_gather", "agreed_clock"]


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.cpu() if x.is_cuda else x


def all_reduce(x: torch.Tensor, mesh, axes):
    """``x`` summed over the mesh axes ``axes`` (a new tensor on x's
    device; ``x`` itself when the group is one rank)."""
    if mesh.axis_size(axes) == 1:
        return x
    h = _host(x).clone()
    dist.all_reduce(h, group=mesh.group(axes))
    return h.to(x.device)


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
