"""Flash attention backward on Hopper: the wrappers of
``csrc/flash_attention_bwd.cu``.

:func:`flash_attention_bwd` takes the forward's inputs, its output ``o``
and logsumexp ``lse``, and the output gradient ``dO``, computes
``Dsum = rowsum(dO * O)`` in f32 with plain torch (as the reference does
outside its kernels), and launches the dQ kernel
(:func:`flash_attention_dq`) and the dK/dV kernel
(:func:`flash_attention_dkv`).  dK and dV come out as ``[B, Kv, S, D]``
with each GQA group summed in f32 inside the kernel.

Two routes, by dtype and head dim alone (:func:`bwd_route`; the CUDA
source's entry points apply the same rule): bf16 at D 64, 120 and 128
runs the tensor-core kernels (wgmma fed by TMA), f32 at every head dim and
bf16 at D 16 and 256 the CUDA-core kernels.  Neither falls back to the
other.

Each kernel wrapper checks its operands, launches on the current stream,
raises if the launch failed, and counts its launches in
``<wrapper>.launches`` and, by route, in ``<wrapper>.route_launches``.
The plain version is
:func:`~repro_torch.kernels.flash_attention.ref.attention_bwd_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import KERNEL_DTYPES, _build, check_operand

from .flash_attention import (ROUTES, TENSOR_CORE_HEAD_DIMS, check_qkv,
                              library_route)


def bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernels a call of this dtype and head dim takes:
    ``"tensor_core"`` for bf16 at D 64, 120 and 128, ``"cuda_core"`` for
    f32 at every head dim and bf16 at D 16 and 256 (whose 64 x 256 f32 dK
    and dV accumulators exceed one warpgroup's registers)."""
    if dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


@functools.cache
def _launchers():
    lib = _build.library("flash_attention_bwd")
    dq, dkv = lib.flash_attention_dq_launch, lib.flash_attention_dkv_launch
    dq.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    dkv.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


def library_bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """What :func:`bwd_route` must agree with: the backward library's own
    rule."""
    return library_route("flash_attention_bwd", "flash_attention_bwd_route",
                         dtype, head_dim)


def _check_bwd(q, k, v, do, lse, dsum) -> None:
    check_qkv(q, k, v)
    check_operand("do", do, dtype=q.dtype, ndim=4, device=q.device)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)}")
    for name, t in (("lse", lse), ("dsum", dsum)):
        check_operand(name, t, dtype=torch.float32, ndim=3, device=q.device,
                      align=4)
        if t.shape != q.shape[:3]:
            raise ValueError(f"{name} {tuple(t.shape)} is not [B, H, S] of "
                             f"q {tuple(q.shape)}")


def _args(q, k, causal, window):
    b, h, s, d = q.shape
    return (b, h, k.shape[1], s, d, int(bool(causal)), int(window),
            float(d) ** -0.5, KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_dq(q, k, v, do, lse, dsum, *, causal: bool = True,
                       window: int = 0) -> torch.Tensor:
    """q, do: [B,H,S,D]; k, v: [B,Kv,S,D]; lse, dsum: [B,H,S] f32 -> dq
    [B,H,S,D] in q's dtype.  CUDA tensors only."""
    _check_bwd(q, k, v, do, lse, dsum)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    err = _launchers()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                          dq.data_ptr(), *_args(q, k, causal, window))
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
    """As :func:`flash_attention_dq` -> (dk, dv [B,Kv,S,D]) in k's dtype,
    each summed over its group of query heads.  CUDA tensors only."""
    _check_bwd(q, k, v, do, lse, dsum)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    err = _launchers()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                          dk.data_ptr(), dv.data_ptr(),
                          *_args(q, k, causal, window))
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
    """q, o, do: [B,H,S,D]; k, v: [B,Kv,S,D]; lse: [B,H,S] f32 ->
    (dq [B,H,S,D], dk [B,Kv,S,D], dv [B,Kv,S,D]).  CUDA tensors only."""
    check_operand("o", o, dtype=q.dtype, ndim=4, device=q.device)
    dsum = (do.float() * o.float()).sum(dim=-1)
    dq = flash_attention_dq(q, k, v, do, lse, dsum, causal=causal,
                            window=window)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, dsum, causal=causal,
                                 window=window)
    return dq, dk, dv
