"""The RWKV-6 scan on Hopper: the wrapper of ``csrc/rwkv6_scan.cu``.

    y_t[j]  = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
    S[i, j] <- exp(logw_t[i]) * S[i, j] + k_t[i] * v_t[j]

over r, k, v, logw: [BH, S, 64] f32 with bonus u [BH, 64] and state
[BH, 64, 64], both f32.  ``rwkv6_scan_state`` seeds ``S`` from the
caller's ``s0`` and returns the state after the last step beside the
per-step outputs: the scan-state ABI that carries each slot's WKV state
across prefill chunks and packed ticks.  ``rwkv6_scan`` starts from zero.
The kernel takes any ``S``; nothing is padded to a time chunk.

The kernel gives each bh row one CTA of four warps (sixteen rows of two
state columns per thread) and streams time through a ring of
``STAGES`` shared-memory stages of ``CHUNK`` steps by ``cp.async``; a
CTA takes :func:`smem_bytes` of dynamic shared memory, four CTAs an SM.

The wrapper checks device, dtype (f32 only: what ``time_mix_chunk``
passes), head dim (64 only: the kernel's thread layout covers 64 x 64),
shape and contiguity, picks the copy width (:func:`copy_bytes`), launches
on the current stream, raises if the launch failed, and counts launches
in ``rwkv6_scan_state.launches``.  The plain version is
:func:`~repro_torch.kernels.rwkv6.ref.rwkv6_ref_state`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, check_operand

HEAD_DIM = 64
THREADS = 128               # four warps a bh row (csrc kThreads)
CHUNK = 16                  # time steps a shared-memory stage holds
STAGES = 3                  # stages of the cp.async ring


def smem_bytes() -> int:
    """Dynamic shared memory of one CTA (csrc ``rwkv6_scan_smem_bytes``):
    each stage holds r, k, exp(logw) and v for ``CHUNK`` steps, the steps'
    bonus dot products and their step pairs' sums, all f32."""
    return 4 * STAGES * (4 * CHUNK * HEAD_DIM + 2 * CHUNK)


def copy_bytes(*streams: torch.Tensor) -> int:
    """Bytes a ``cp.async`` copy of the streamed inputs takes: 16 when every
    base address is 16-byte aligned, else 8 (the wrapper admits 8-byte
    aligned inputs; each step's row of 256 bytes keeps the alignment)."""
    return 16 if all(t.data_ptr() % 16 == 0 for t in streams) else 8


@functools.cache
def _launcher():
    fn = _build.library("rwkv6_scan").rwkv6_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rwkv6_scan_state(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor,
                     s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw: [BH, S, 64] f32; u: [BH, 64] f32; s0: [BH, 64, 64]
    f32 -> (y [BH, S, 64] f32, s_out [BH, 64, 64] f32).  CUDA tensors
    only."""
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"rwkv6_scan_state kernel needs CUDA tensors, got "
                         f"{dev}")
    for name, t, ndim in (("r", r, 3), ("k", k, 3), ("v", v, 3),
                          ("logw", logw, 3), ("u", u, 2), ("s0", s0, 3)):
        check_operand(name, t, dtype=torch.float32, ndim=ndim, device=dev,
                      align=8)
    bh, s, n = r.shape
    if n != HEAD_DIM:
        raise ValueError(f"rwkv6_scan_state kernel is built for head dim "
                         f"{HEAD_DIM}, got {n}")
    if (any(t.shape != r.shape for t in (k, v, logw))
            or u.shape != (bh, n) or s0.shape != (bh, n, n)):
        raise ValueError(
            f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, logw {tuple(logw.shape)}, u "
            f"{tuple(u.shape)}, s0 {tuple(s0.shape)} do not match")
    y = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    if bh == 0:
        return y, s_out
    err = _launcher()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                      logw.data_ptr(), u.data_ptr(), s0.data_ptr(),
                      y.data_ptr(), s_out.data_ptr(), bh, s,
                      copy_bytes(r, k, v, logw),
                      torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rwkv6_scan_state: CUDA error {err} at launch")
    rwkv6_scan_state.launches += 1
    return y, s_out


rwkv6_scan_state.launches = 0


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r, k, v, logw: [BH, S, 64] f32; u: [BH, 64] -> y, from a zero
    state."""
    bh, _, n = r.shape
    s0 = torch.zeros(bh, n, n, dtype=torch.float32, device=r.device)
    return rwkv6_scan_state(r, k, v, logw, u, s0)[0]
