"""Flash attention forward on Hopper: the wrappers of
``csrc/flash_attention.cu``.

:func:`flash_attention` returns ``o``; :func:`flash_attention_fwd_lse`
also returns the logsumexp ``lse [B, H, S]`` f32 that the backward kernels
recompute the probabilities from (the reference keeps it on 128 lanes and
slices one; here it is one value per row).  Both launch the same kernel,
with and without its ``lse`` output.  Causal, sliding-window and
non-causal attention, MHA/GQA/MQA (query head ``h`` reads KV head
``h // (H // Kv)``), any ``S`` without padding, head dims in
:data:`~repro_torch.kernels.HEAD_DIMS`, f32 and bf16.

Each wrapper checks device, dtype, shape, contiguity and alignment,
launches on the current stream, raises if the launch failed, and counts
its launches in ``<wrapper>.launches``.  The plain versions are
:func:`~repro_torch.kernels.flash_attention.ref.attention_ref` and
:func:`~repro_torch.kernels.flash_attention.ref.attention_lse_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (HEAD_DIMS, KERNEL_DTYPES, _build,
                                 check_operand)


@functools.cache
def _launcher():
    fn = _build.library("flash_attention").flash_attention_fwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q [B,H,S,D] and k, v [B,Kv,S,D] are contiguous CUDA
    tensors of one kernel dtype whose heads group evenly and whose head
    dim has a kernel."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash attention kernels need CUDA tensors, got "
                         f"{dev}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"q: dtype {q.dtype} not in {list(KERNEL_DTYPES)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, dtype=q.dtype, ndim=4, device=dev)
    b, h, s, d = q.shape
    if v.shape != k.shape or k.shape[0] != b or k.shape[2:] != (s, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)} / {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    kv = k.shape[1]
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if max(b, h) > 65535:
        raise ValueError(f"batch {b} or heads {h} above the grid's 65535")


def _forward(q, k, v, lse, causal: bool, window: int) -> torch.Tensor:
    out = torch.empty_like(q)
    b, h, s, d = q.shape
    if out.numel() == 0:
        return out
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, k.shape[1], s, d,
        int(bool(causal)), int(window), float(d) ** -0.5,
        KERNEL_DTYPES[q.dtype], torch.cuda.current_stream(q.device)
        .cuda_stream)
    if err:
        raise RuntimeError(f"flash attention forward: CUDA error {err} at "
                           "launch")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,H,S,D]; k,v: [B,Kv,S,D] -> o [B,H,S,D] in q's dtype.  CUDA
    tensors only."""
    check_qkv(q, k, v)
    out = _forward(q, k, v, None, causal, window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: [B,H,S,D]; k,v: [B,Kv,S,D] -> (o [B,H,S,D] in q's dtype,
    lse [B,H,S] f32).  CUDA tensors only."""
    check_qkv(q, k, v)
    b, h, s, _ = q.shape
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    out = _forward(q, k, v, lse, causal, window)
    flash_attention_fwd_lse.launches += 1
    return out, lse


flash_attention_fwd_lse.launches = 0
