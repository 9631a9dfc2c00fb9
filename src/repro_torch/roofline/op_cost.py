"""Analytic FLOP, byte and live-memory counts of a step: the counterpart of
``src/repro/roofline/hlo_cost.py``.

The reference parses a compiled program's HLO and applies analytic counts
to its instructions.  The port has no compiled program to read, so it
applies the same counts to the operations a step runs: :class:`OpCost` is
a ``TorchDispatchMode`` that sees every aten operation under it (the
autograd backward's too) and records

  * **FLOPs**: ``2 * prod(result dims) * prod(contracted dims)`` for every
    matrix product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
    ``dot``: what ``matmul``, ``linear`` and ``einsum`` lower to), as
    ``hlo_cost._dot_flops``;
  * **HBM-proxy bytes** (``bytes``): one write per result and one read per
    operand for the ops whose data really travels (the aten counterparts of
    ``hlo_cost._HBM_OPS``): products, reductions, sort and top-k, ``cat``,
    pad and copies; gathers count twice their result, scatters and index
    puts twice their update, as the reference's slice-accurate rule;
  * ``bytes_raw``: results and operands of every op but views and empty
    allocations;
  * **live bytes**: every device storage (not the host's) an op creates
    counts from its creation to its release (a weak reference on the storage), each rounded up to the
    CUDA caching allocator's 512-byte blocks; the tensors handed to
    :func:`analyze` count from the start.  ``peak_live_bytes`` is the
    largest sum seen.

A hand-written kernel has no aten body to count: given ``meta`` tensors
its wrapper returns ``meta`` outputs of its shapes and calls
:func:`charge` with its own work, the count :func:`flash_bound` and
:func:`dense_bound` give for a call (:func:`flash_count`,
:func:`dense_count`).  Those functions, and the other kernels' counts
(:func:`segment_bound`, :func:`decode_bound`, :func:`flat_bound`), are
also what ``chip_smoke.py`` prints beside each kernel's time: each turns
its FLOPs and bytes into the least time the card could take at
:data:`~repro_torch.roofline.analysis.HW`.

On ``meta`` an operation whose result depends on the data (``.item()``,
``nonzero``, a copy back to the host) cannot run: it raises
:class:`DataDependentOp`, which names it.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .analysis import HW

__all__ = ["OpCost", "analyze", "charge", "DataDependentOp", "KernelCost",
           "ALLOC_ROUND", "COLLECTIVES", "segment_bound", "decode_bound",
           "flat_bound", "dense_bound", "dense_count", "flash_bound",
           "flash_count", "flash_pairs", "FLASH_PRODUCTS"]

# the CUDA caching allocator hands out blocks in multiples of 512 bytes
ALLOC_ROUND = 512

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")
# c10d's functional collectives, by the reference's kinds
_COLLECTIVE_OPS = {"all_reduce": "all-reduce",
                   "all_gather_into_tensor": "all-gather",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "all_to_all_single": "all-to-all"}

_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv",
             "dot", "vdot"}
# the matrix operand whose last dim is contracted (and addbmm's batch too)
_LHS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "vdot": 0, "addmm": 1,
        "baddbmm": 1, "addmv": 1, "addbmm": 1}
_GATHERS = {"gather", "index_select", "index", "embedding", "take",
            "narrow_copy"}
# scatters and index puts: the argument that holds the update
_SCATTERS = {"scatter": 3, "scatter_add": 3, "scatter_reduce": 3,
             "index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
             "index_add": 3, "index_copy": 3, "slice_scatter": 1,
             "select_scatter": 1, "diagonal_scatter": 1,
             "embedding_dense_backward": 0}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
               "argmin", "logsumexp", "norm", "linalg_vector_norm", "var",
               "std", "var_mean", "prod", "all", "any", "_softmax",
               "_log_softmax", "_softmax_backward_data",
               "_log_softmax_backward_data", "nll_loss_forward",
               "nll_loss_backward", "cumsum", "_foreach_norm"}
_SORTS = {"sort", "topk", "argsort", "kthvalue"}
_MOVES = {"cat", "constant_pad_nd", "copy_", "clone"}
_EMPTY = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "lift_fresh"}
# ops whose result needs the data itself
_DATA_DEPENDENT = {"_local_scalar_dense", "nonzero", "masked_select",
                   "unique", "_unique", "_unique2", "unique_consecutive",
                   "unique_dim", "bincount", "histc", "masked_scatter"}

_ACTIVE: list["OpCost"] = []


class DataDependentOp(RuntimeError):
    """An op whose result depends on tensor data ran on ``meta``."""

    def __init__(self, op: str):
        super().__init__(f"{op} needs the tensor data and cannot run on "
                         "meta (a data-dependent op)")
        self.op = op


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _dims(t) -> int:
    return int(np.prod(t.shape, dtype=np.int64)) if t.dim() else 1


def _product_flops(name: str, args, out) -> float:
    a = args[_LHS[name]]
    contract = a.shape[-1] if a.dim() else 1
    if name == "addbmm":
        contract *= a.shape[0]
    return 2.0 * _dims(out) * contract


class OpCost(TorchDispatchMode):
    """Counts the ops run under it (see the module docstring).  ``live``:
    tensors already allocated that count as live from the start."""

    def __init__(self, live=()):
        super().__init__()
        self.counts = {"flops": 0.0, "bytes": 0.0, "bytes_raw": 0.0,
                       "coll_count": 0}
        self.counts.update(dict.fromkeys(COLLECTIVES, 0.0))
        self.ops: dict[tuple[str, str], dict] = {}
        self._live: dict[int, int] = {}
        self.live_bytes = self.peak_live_bytes = 0
        for t in live:
            self._track(t)
        self.argument_bytes = self.live_bytes

    # ---- live memory --------------------------------------------------
    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t) -> None:
        if not isinstance(t, torch.Tensor) or t.device.type == "cpu":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._live[key] = n
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    # ---- counts --------------------------------------------------------
    def add(self, op: str, tag: str, *, flops: float = 0.0,
            nbytes: float = 0.0, raw: float = 0.0) -> None:
        self.counts["flops"] += flops
        self.counts["bytes"] += nbytes
        self.counts["bytes_raw"] += raw
        rec = self.ops.setdefault((op, tag), {"op": op, "tag": tag,
                                              "bytes": 0.0, "flops": 0.0,
                                              "calls": 0})
        rec["bytes"] += nbytes
        rec["flops"] += flops
        rec["calls"] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if any(t.device.type == "meta" for t in ins):
            if name in _DATA_DEPENDENT or (
                    func is torch.ops.aten.repeat_interleave.Tensor
                    and kwargs.get("output_size") is None):
                raise DataDependentOp(f"aten.{name}")
            dst = (kwargs.get("device") if name == "_to_copy"
                   else args[0].device if name == "copy_" else None)
            if dst is not None and torch.device(dst).type != "meta":
                raise DataDependentOp(f"aten.{name} to {dst} (a read of "
                                      "the data back to the host)")
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        if func.is_view or name in _EMPTY:
            return out
        out_b = sum(_nbytes(t) for t in outs)
        in_b = sum(_nbytes(t) for t in ins)
        raw = out_b + in_b
        flops = hbm = 0.0
        kind = None
        if name in _PRODUCTS:
            flops, hbm, kind = _product_flops(name, args, outs[0]), raw, \
                "dot"
        elif name in _GATHERS:
            hbm, kind = 2 * out_b, "gather"
        elif name in _SCATTERS:
            i = _SCATTERS[name]
            upd = args[i] if i < len(args) else None
            if not isinstance(upd, torch.Tensor):   # a scalar value
                upd = None
            hbm, kind = 2 * (_nbytes(upd) if upd is not None else out_b), \
                "scatter"
        elif name in _REDUCTIONS:
            hbm, kind = raw, "reduce"
        elif name in _SORTS:
            hbm, kind = raw, "sort"
        elif name in _MOVES:
            hbm, kind = raw, name
        elif name in _COLLECTIVE_OPS:
            coll = _COLLECTIVE_OPS[name]
            self.counts[coll] += out_b
            self.counts["coll_count"] += 1
            hbm, kind = out_b, coll
        self.add(name, kind or "elementwise", flops=flops, nbytes=hbm,
                 raw=raw)
        return out

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # ---- results ---------------------------------------------------------
    def result(self) -> dict:
        """The reference ``analyze_module``'s keys that mean something
        here (``flops``, ``bytes``, ``bytes_raw``, the per-kind collective
        bytes, ``coll_count``, ``collective_bytes``), plus
        ``peak_live_bytes`` and the ``argument_bytes`` live at the
        start."""
        out = dict(self.counts)
        out["collective_bytes"] = sum(out[k] for k in COLLECTIVES)
        out["peak_live_bytes"] = self.peak_live_bytes
        out["argument_bytes"] = self.argument_bytes
        return out

    def attribute(self, top: int = 20) -> list[dict]:
        """Ops by the bytes they move, largest first (then FLOPs), as
        ``hlo_cost.attribute``: ``op`` the aten op or kernel, ``tag`` its
        kind."""
        recs = sorted(self.ops.values(),
                      key=lambda r: (-r["bytes"], -r["flops"]))
        return [dict(r) for r in recs[:top]]


def analyze(fn, *args, **kwargs) -> tuple[dict, OpCost]:
    """Run ``fn(*args, **kwargs)`` under a fresh :class:`OpCost` whose
    live set starts with every tensor in ``args`` and ``kwargs``; returns
    ``(counter.result(), counter)``."""
    counter = OpCost([t for t in tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)])
    with counter:
        fn(*args, **kwargs)
    return counter.result(), counter


def charge(kernel: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's own work, called by its wrapper's ``meta``
    branch: added to the innermost :class:`OpCost` running, if any."""
    if _ACTIVE:
        _ACTIVE[-1].add(kernel, "kernel", flops=flops, nbytes=nbytes,
                        raw=nbytes)


# ---------------------------------------------------------------------------
# the kernels' own counts and bounds
# ---------------------------------------------------------------------------


class KernelCost(NamedTuple):
    """One kernel call's least time on the card (``ms``), what sets it
    (``by``: ``"bytes"`` or ``"operations"``), and the counts it comes
    from."""

    ms: float
    by: str
    flops: int
    nbytes: int


def _cost(flops, nbytes, dtype) -> KernelCost:
    peak = HW["peak_flops"] if dtype == torch.bfloat16 \
        else HW["peak_flops_f32"]
    t_bytes, t_ops = nbytes / HW["hbm_bw"], flops / peak
    return KernelCost(max(t_bytes, t_ops) * 1e3,
                      "bytes" if t_bytes >= t_ops else "operations", flops,
                      nbytes)


def _live_blocks(tables, slot, hi_pos, lo_pos, window, t):
    j_lo = max(0, lo_pos - window + 1) // t if window else 0
    j_hi = min(hi_pos // t, tables.shape[1] - 1)
    row = tables[slot, j_lo:j_hi + 1]
    return int((row >= 0).sum())


def segment_bound(x, window=0) -> KernelCost:
    """The paged segment kernel's call on ``x`` (its keyword arguments):
    bytes (q, out, the live K/V blocks of every slot in the stream up to
    its horizon, tables, tags) against flops (4*D per admitted (query
    head, key) pair).  Only the q of lanes that admit a key counts: a dead
    lane, or a lane no key admits, gives zeros whatever its q holds."""
    tabs = x["block_tables"].cpu()
    qp, qs = x["q_pos"].cpu(), x["q_seg"].cpu()
    p, h, d = x["q"].shape
    kv, t = x["k_store"].shape[1], x["k_store"].shape[2]
    esz = x["q"].element_size()
    nbytes = p * h * d * esz + tabs.numel() * 4 + 2 * p * 4
    flops = 0
    for s in torch.unique(qs[qs >= 0]).tolist():
        pos = qp[qs == s]
        nb = _live_blocks(tabs, s, int(pos.max()), int(pos.min()), window,
                          t)
        nbytes += nb * 2 * kv * t * d * esz
        ok = (tabs[s] >= 0).repeat_interleave(t)          # [M*T]
        kpos = torch.arange(ok.numel())
        adm = ok[None, :] & (kpos[None, :] <= pos[:, None])
        if window:
            adm &= (pos[:, None] - kpos[None, :]) < window
        flops += int(adm.sum()) * h * 4 * d
        nbytes += int(adm.any(dim=1).sum()) * h * d * esz
    return _cost(flops, nbytes, x["q"].dtype)


def decode_bound(x, window=0) -> KernelCost:
    """As :func:`segment_bound` for paged decode, one query token per row;
    only the q of rows that admit a key counts."""
    tabs, qp = x["block_tables"].cpu(), x["q_pos"].cpu()
    b, h, d = x["q"].shape
    kv, t = x["k_store"].shape[1], x["k_store"].shape[2]
    esz = x["q"].element_size()
    nbytes = b * h * d * esz + tabs.numel() * 4 + b * 4
    flops = 0
    for r in range(b):
        q = int(qp[r])
        nb = _live_blocks(tabs, r, q, q, window, t)
        nbytes += nb * 2 * kv * t * d * esz
        ok = (tabs[r] >= 0).repeat_interleave(t)
        kpos = torch.arange(ok.numel())
        adm = ok & (kpos <= q)
        if window:
            adm &= (q - kpos) < window
        flops += int(adm.sum()) * h * 4 * d
        nbytes += h * d * esz if bool(adm.any()) else 0
    return _cost(flops, nbytes, x["q"].dtype)


def flat_bound(x, window=0) -> KernelCost:
    """The flat segment kernel's call on ``x``: bytes (the q of lanes that
    admit a key, the whole output, each admitted key's K and V once, the
    tags) against flops (4*D per admitted (query head, key) pair)."""
    qp, qs, kp, ks = x["q_pos"], x["q_seg"], x["k_pos"], x["k_seg"]
    p, h, d = x["q"].shape
    n, kv, _ = x["k"].shape
    esz = x["q"].element_size()
    adm = ((ks[None, :] == qs[:, None]) & (qs[:, None] >= 0)
           & (kp[None, :] >= 0) & (kp[None, :] <= qp[:, None]))
    if window:
        adm &= (qp[:, None] - kp[None, :]) < window
    nbytes = (int(adm.any(dim=1).sum()) * h * d * esz + p * h * d * esz
              + int(adm.any(dim=0).sum()) * 2 * kv * d * esz
              + (2 * p + 2 * n) * 4)
    flops = int(adm.sum()) * h * 4 * d
    del adm
    return _cost(flops, nbytes, x["q"].dtype)


def dense_count(b, h, kv, d, s, esz, n_adm, rows_adm) -> tuple[int, int]:
    """``(flops, bytes)`` of a dense decode call on [B, Kv, S, D] caches
    that admits ``n_adm`` (row, key) pairs over ``rows_adm`` rows: the q
    of those rows, the whole output, each admitted key's K and V rows
    once, k_pos and q_pos; 4*D flops per admitted (query head, key)
    pair."""
    nbytes = (rows_adm * h * d * esz + b * h * d * esz
              + n_adm * 2 * kv * d * esz + b * s * 4 + b * 4)
    return n_adm * h * 4 * d, nbytes


def dense_bound(x, window=0) -> KernelCost:
    """The dense decode kernel's call on ``x``, counting the keys this
    call's positions admit."""
    kp, qp = x["k_pos"], x["q_pos"]
    adm = (kp >= 0) & (kp <= qp[:, None])
    if window > 0:
        adm &= (qp[:, None] - kp) < window
    b, h, d = x["q"].shape
    kv, s = x["k"].shape[1], x["k"].shape[2]
    flops, nbytes = dense_count(b, h, kv, d, s, x["q"].element_size(),
                                int(adm.sum()), int(adm.any(dim=1).sum()))
    return _cost(flops, nbytes, x["q"].dtype)


def flash_pairs(s: int, causal: bool, window: int, sk=None) -> int:
    """Admitted (query, key) pairs of one head: what the kernels' work and
    so their bound depends on.  Keys of another length ``sk`` come
    without a mask: every pair."""
    if sk is not None and sk != s:
        return s * sk
    q = np.arange(s)
    hi = q if causal else np.full(s, s - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(s, int)
    return int((hi - lo + 1).sum())


# matrix products per admitted pair and head dim, in units of 2 D flops:
# the forward QK^T and PV; dQ recomputes QK^T and dO V^T, then dS K; dK/dV
# recomputes both, then P^T dO and dS^T Q
FLASH_PRODUCTS = {"flash_attention": 2, "flash_attention_fwd_lse": 2,
                  "flash_attention_dq": 3, "flash_attention_dkv": 4}


def flash_count(kernel, b, h, kv, s, d, causal, window, dtype,
                sk=None) -> tuple[int, int]:
    """``(flops, bytes)`` of one flash kernel's call: each input read once
    and each output written once, and its matrix products over the
    admitted pairs; ``sk`` keys (``s`` unless given) a head."""
    esz = torch.tensor([], dtype=dtype).element_size()
    sk = s if sk is None else sk
    q_b, kv_b, row_b = b * h * s * d * esz, b * kv * sk * d * esz, b * h * s * 4
    nbytes = {"flash_attention": 2 * q_b + 2 * kv_b,
              "flash_attention_fwd_lse": 2 * q_b + 2 * kv_b + row_b,
              "flash_attention_dq": 3 * q_b + 2 * kv_b + 2 * row_b,
              "flash_attention_dkv": 2 * q_b + 4 * kv_b + 2 * row_b}[kernel]
    ops = FLASH_PRODUCTS[kernel] * 2 * d * b * h * flash_pairs(s, causal,
                                                                window, sk)
    return ops, nbytes


def flash_bound(kernel, b, h, kv, s, d, causal, window, dtype,
                sk=None) -> KernelCost:
    """Least time for one flash kernel's call (:func:`flash_count`) at the
    peak for the input dtype."""
    ops, nbytes = flash_count(kernel, b, h, kv, s, d, causal, window, dtype,
                              sk)
    return _cost(ops, nbytes, dtype)
