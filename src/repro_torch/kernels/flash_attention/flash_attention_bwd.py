"""Flash attention backward on Hopper: the wrappers of
``csrc/flash_attention_bwd.cu``.

:func:`flash_attention_bwd` takes the forward's inputs, its output ``o``
and logsumexp ``lse``, and the output gradient ``dO``, computes
``Dsum = rowsum(dO * O)`` in f32 with plain torch (as the reference does
outside its kernels), and launches the dQ kernel
(:func:`flash_attention_dq`) and the dK/dV kernel
(:func:`flash_attention_dkv`).  dK and dV come out as ``[B, Kv, Sk, D]``
with each GQA group summed in f32 inside the kernel.  Keys of another
length than the queries are taken as the forward takes them: without a
mask only.

Two routes, by dtype and head dim alone (:func:`bwd_route`; the CUDA
source's entry points apply the same rule): bf16 at D 64, 120, 128 and
256 runs the tensor-core kernels (wgmma fed by TMA), f32 at every head dim
and bf16 at D 16 the CUDA-core kernels.  Neither falls back to the other.
The rule is the forward's (:func:`~.flash_attention.fwd_route`).  At bf16
D 256 the dK/dV
kernel splits each GQA group's query heads over :func:`dkv_split` CTAs a
key tile where the key tiles alone would leave SMs idle; the wrapper then
allocates the kernel's f32 workspace of partial sums, which a second
kernel adds in a fixed order (the same bits every launch).

Each kernel wrapper checks its operands, launches on the current stream,
raises if the launch failed, and counts its launches in
``<wrapper>.launches`` and, by route, in ``<wrapper>.route_launches``;
on ``meta`` tensors it launches and counts nothing, returns its outputs'
shapes and charges its count, as the forward's wrappers do.
The plain version is
:func:`~repro_torch.kernels.flash_attention.ref.attention_bwd_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import KERNEL_DTYPES, _build, check_operand, sm_count
from repro_torch.roofline.analysis import HW

from .flash_attention import (ROUTES, charge_meta, check_qkv, fwd_route,
                              library_route)

# keys per dK/dV CTA on the tensor-core route (flash_tc.cuh's kKeys)
KEY_TILE = 64


def bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernels a call of this dtype and head dim takes: the
    forward's rule, ``"tensor_core"`` for bf16 at D 64, 120, 128 and 256,
    ``"cuda_core"`` for f32 at every head dim and bf16 at D 16."""
    return fwd_route(dtype, head_dim)


def dkv_split(b: int, sk: int, group: int, sms: int) -> int:
    """CTAs a (key tile, KV head, batch) of the bf16 D 256 dK/dV kernel,
    each over its share of the ``group`` query heads: as many as the SMs
    hold beside ``b`` x the key tiles (``sms // (b * tiles)``), at least
    1, at most ``group``.  The KV heads do not enter, so a tensor-parallel
    rank's launch on its KV heads splits each head's group as the whole
    launch does, and sums its dK and dV in the same order."""
    tiles = b * -(-sk // KEY_TILE)
    return max(1, min(group, sms // tiles))


@functools.cache
def _launchers():
    lib = _build.library("flash_attention_bwd")
    dq, dkv = lib.flash_attention_dq_launch, lib.flash_attention_dkv_launch
    dq.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    dkv.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p])
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


def library_bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """What :func:`bwd_route` must agree with: the backward library's own
    rule."""
    return library_route("flash_attention_bwd", "flash_attention_bwd_route",
                         dtype, head_dim)


def _check_bwd(q, k, v, do, lse, dsum, causal, window) -> None:
    check_qkv(q, k, v, causal, window)
    check_operand("do", do, dtype=q.dtype, ndim=4, device=q.device)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)}")
    for name, t in (("lse", lse), ("dsum", dsum)):
        check_operand(name, t, dtype=torch.float32, ndim=3, device=q.device,
                      align=4)
        if t.shape != q.shape[:3]:
            raise ValueError(f"{name} {tuple(t.shape)} is not [B, H, Sq] of "
                             f"q {tuple(q.shape)}")


def _args(q, k, causal, window):
    b, h, s, d = q.shape
    return (b, h, k.shape[1], s, k.shape[2], d, int(bool(causal)),
            int(window), float(d) ** -0.5, KERNEL_DTYPES[q.dtype])


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def flash_attention_dq(q, k, v, do, lse, dsum, *, causal: bool = True,
                       window: int = 0) -> torch.Tensor:
    """q, do: [B,H,Sq,D]; k, v: [B,Kv,Sk,D]; lse, dsum: [B,H,Sq] f32 -> dq
    [B,H,Sq,D] in q's dtype.  CUDA (or meta) tensors only."""
    _check_bwd(q, k, v, do, lse, dsum, causal, window)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    if q.device.type == "meta":
        charge_meta("flash_attention_dq", q, k, causal, window)
        return dq
    err = _launchers()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                          dq.data_ptr(), *_args(q, k, causal, window),
                          _stream(q))
    if err:
        raise RuntimeError(f"flash attention dQ: CUDA error {err} at launch")
    flash_attention_dq.launches += 1
    flash_attention_dq.route_launches[bwd_route(q.dtype, q.shape[-1])] += 1
    return dq


flash_attention_dq.launches = 0
flash_attention_dq.route_launches = dict.fromkeys(ROUTES, 0)


def flash_attention_dkv(q, k, v, do, lse, dsum, *, causal: bool = True,
                        window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """As :func:`flash_attention_dq` -> (dk, dv [B,Kv,Sk,D]) in k's dtype,
    each summed over its group of query heads (at bf16 D 256 over
    :func:`dkv_split`'s CTAs a key tile, whose f32 partials go through a
    workspace allocated here, on ``meta`` too, so that a dry run holds it
    live for the call, split for the roofline's H100).  CUDA (or meta)
    tensors only."""
    _check_bwd(q, k, v, do, lse, dsum, causal, window)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    meta = q.device.type == "meta"
    b, h, _, d = q.shape
    n_split = 1
    if d == 256 and bwd_route(q.dtype, d) == "tensor_core":
        n_split = dkv_split(b, k.shape[2], h // k.shape[1],
                            HW["sms"] if meta else sm_count(q.device.index))
    work = (torch.empty((2, n_split) + tuple(k.shape), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    if meta:
        charge_meta("flash_attention_dkv", q, k, causal, window)
        return dk, dv
    err = _launchers()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                          dk.data_ptr(), dv.data_ptr(),
                          None if work is None else work.data_ptr(),
                          *_args(q, k, causal, window), n_split, _stream(q))
    if err:
        raise RuntimeError(f"flash attention dK/dV: CUDA error {err} at "
                           "launch")
    flash_attention_dkv.launches += 1
    flash_attention_dkv.route_launches[bwd_route(q.dtype, q.shape[-1])] += 1
    return dk, dv


flash_attention_dkv.launches = 0
flash_attention_dkv.route_launches = dict.fromkeys(ROUTES, 0)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """q, o, do: [B,H,Sq,D]; k, v: [B,Kv,Sk,D]; lse: [B,H,Sq] f32 ->
    (dq [B,H,Sq,D], dk [B,Kv,Sk,D], dv [B,Kv,Sk,D]).  CUDA (or meta)
    tensors only."""
    check_operand("o", o, dtype=q.dtype, ndim=4, device=q.device)
    dsum = (do.float() * o.float()).sum(dim=-1)
    dq = flash_attention_dq(q, k, v, do, lse, dsum, causal=causal,
                            window=window)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, dsum, causal=causal,
                                 window=window)
    return dq, dk, dv
