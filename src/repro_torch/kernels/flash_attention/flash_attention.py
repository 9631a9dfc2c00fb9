"""Flash attention forward on Hopper: the wrappers of
``csrc/flash_attention.cu``.

:func:`flash_attention` returns ``o``; :func:`flash_attention_fwd_lse`
also returns the logsumexp ``lse [B, H, S]`` f32 that the backward kernels
recompute the probabilities from (the reference keeps it on 128 lanes and
slices one; here it is one value per row).  Both launch the same kernel,
with and without its ``lse`` output.  Causal, sliding-window and
non-causal attention, MHA/GQA/MQA (query head ``h`` reads KV head
``h // (H // Kv)``), any ``S`` without padding, head dims in
:data:`~repro_torch.kernels.HEAD_DIMS`, f32 and bf16.  Keys may be of
another length ``Sk`` than the queries' ``Sq`` (cross-attention:
``k, v [B, Kv, Sk, D]``) without a mask only, ``causal=False`` and
``window=0`` (:func:`~.ref.check_lengths`).

Two routes, by dtype and head dim alone (:func:`fwd_route`; the CUDA
source's entry point applies the same rule): bf16 at D 64, 120, 128 and
256 runs the tensor-core kernels (wgmma fed by TMA, P rounded to bf16
before it meets V; at D 256 two consumer warpgroups on a 128-row q tile),
f32 at every head dim and bf16 at D 16 the CUDA-core kernel.  Neither
falls back to the other.

Each wrapper checks device, dtype, shape, contiguity and alignment,
launches on the current stream, raises if the launch failed, and counts
its launches in ``<wrapper>.launches`` and, by route, in
``<wrapper>.route_launches``.  Given ``meta`` tensors it launches nothing
and counts no launch: it returns ``meta`` outputs (the ones the kernel
allocates) and charges the kernel's count
(:func:`~repro_torch.roofline.op_cost.flash_count`) to the running
:class:`~repro_torch.roofline.op_cost.OpCost`.  The plain versions are
:func:`~repro_torch.kernels.flash_attention.ref.attention_ref` and
:func:`~repro_torch.kernels.flash_attention.ref.attention_lse_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (HEAD_DIMS, KERNEL_DTYPES, _build,
                                 check_operand)
from repro_torch.roofline import op_cost

from .ref import check_lengths


ROUTES = ("tensor_core", "cuda_core")
# head dims whose bf16 flash kernels (forward and backward) run on the
# tensor cores
TENSOR_CORE_HEAD_DIMS = (64, 120, 128, 256)


def fwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The forward kernel a call of this dtype and head dim takes:
    ``"tensor_core"`` for bf16 at D 64, 120, 128 and 256, ``"cuda_core"``
    for f32 at every head dim and bf16 at D 16."""
    if dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def library_route(library: str, fn: str, dtype: torch.dtype,
                  head_dim: int) -> str:
    """The route the CUDA library's own dispatch takes for a call (built on
    first use), from its ``extern "C"`` route function ``fn``."""
    route = getattr(_build.library(library), fn)
    route.argtypes = [ctypes.c_int, ctypes.c_int]
    route.restype = ctypes.c_int
    return ROUTES[0] if route(head_dim, KERNEL_DTYPES[dtype]) else ROUTES[1]


def library_fwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """What :func:`fwd_route` must agree with: the forward library's
    own rule."""
    return library_route("flash_attention", "flash_attention_fwd_route",
                         dtype, head_dim)


@functools.cache
def _launcher():
    fn = _build.library("flash_attention").flash_attention_fwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int) -> None:
    """Raise unless q [B,H,Sq,D] and k, v [B,Kv,Sk,D] are contiguous CUDA
    (or ``meta``) tensors of one kernel dtype whose heads group evenly and
    whose head dim has a kernel, with ``Sk == Sq`` unless the call has no
    mask."""
    dev = q.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash attention kernels need CUDA tensors, got "
                         f"{dev}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"q: dtype {q.dtype} not in {list(KERNEL_DTYPES)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, dtype=q.dtype, ndim=4, device=dev)
    b, h, s, d = q.shape
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d \
            or k.shape[2] == 0:
        raise ValueError(f"k/v shapes {tuple(k.shape)} / {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    check_lengths(s, k.shape[2], causal, window)
    kv = k.shape[1]
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if max(b, h) > 65535:
        raise ValueError(f"batch {b} or heads {h} above the grid's 65535")


def charge_meta(kernel: str, q, k, causal: bool, window: int) -> None:
    """A ``meta`` call's stand-in for a launch: the kernel's count."""
    b, h, s, d = q.shape
    op_cost.charge(kernel, *op_cost.flash_count(
        kernel, b, h, k.shape[1], s, d, causal, window, q.dtype,
        k.shape[2]))


def _forward(q, k, v, lse, causal: bool, window: int) -> torch.Tensor:
    out = torch.empty_like(q)
    b, h, s, d = q.shape
    if out.numel() == 0 or q.device.type == "meta":
        return out
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, k.shape[1], s,
        k.shape[2], d,
        int(bool(causal)), int(window), float(d) ** -0.5,
        KERNEL_DTYPES[q.dtype], torch.cuda.current_stream(q.device)
        .cuda_stream)
    if err:
        raise RuntimeError(f"flash attention forward: CUDA error {err} at "
                           "launch")
    return out


def _count(wrapper, q) -> None:
    wrapper.launches += 1
    wrapper.route_launches[fwd_route(q.dtype, q.shape[-1])] += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,H,Sq,D]; k,v: [B,Kv,Sk,D] -> o [B,H,Sq,D] in q's dtype.  CUDA
    (or meta) tensors only."""
    check_qkv(q, k, v, causal, window)
    out = _forward(q, k, v, None, causal, window)
    if q.device.type == "meta":
        charge_meta("flash_attention", q, k, causal, window)
    else:
        _count(flash_attention, q)
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: [B,H,Sq,D]; k,v: [B,Kv,Sk,D] -> (o [B,H,Sq,D] in q's dtype,
    lse [B,H,Sq] f32).  CUDA (or meta) tensors only."""
    check_qkv(q, k, v, causal, window)
    b, h, s, _ = q.shape
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    out = _forward(q, k, v, lse, causal, window)
    if q.device.type == "meta":
        charge_meta("flash_attention_fwd_lse", q, k, causal, window)
    else:
        _count(flash_attention_fwd_lse, q)
    return out, lse


flash_attention_fwd_lse.launches = 0
flash_attention_fwd_lse.route_launches = dict.fromkeys(ROUTES, 0)
