"""The RG-LRU scan on Hopper: the wrapper of ``csrc/rglru_scan.cu``.

    h_t = exp(log_a_t) * h_{t-1} + b_t      over log_a, b: [B, S, F] f32

``rglru_scan_state`` seeds ``h`` from the caller's ``h0 [B, F]`` and
returns the state after the last step beside the per-step outputs: the
scan-state ABI that carries each slot's recurrence across prefill chunks
and packed ticks.  ``rglru_scan`` starts from zero.  The kernel takes any
``S``; nothing is padded to a time chunk.

The kernel gives each CTA ``channels`` channels (one thread each) of one
row across all of time and streams time through a ring of shared-memory
stages of ``STEPS`` steps filled by ``cp.async``, and stores h from
registers.  :func:`launch_plan` picks the launch shape from the shapes and
pointers alone: the CTA width (:func:`cta_channels`) and the copy width
(:func:`copy_bytes`).

The wrapper checks device, dtype (f32 only: what ``rglru_chunk`` passes),
shape and contiguity, launches on the current stream, raises if the launch
failed, and counts launches in ``rglru_scan_state.launches``.  The plain
version is :func:`~repro_torch.kernels.rglru.ref.rglru_ref_state`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, check_operand

CHANNELS = (32, 64)         # channels a CTA takes (csrc template W)
STEPS = 32                  # time steps a ring stage holds (csrc kSteps)


def stages(channels: int) -> int:
    """Ring stages of a CTA (csrc ``Ring::kStages``): four CTAs of 64
    channels or six of 32 fit an SM."""
    return 3 if channels == 64 else 4


def smem_bytes(channels: int) -> int:
    """Dynamic shared memory of one CTA (csrc ``rglru_scan_smem_bytes``):
    each stage holds log_a and b for ``STEPS`` steps, f32."""
    return 4 * stages(channels) * 2 * STEPS * channels


def cta_channels(bsz: int, f: int, sms: int) -> int:
    """64 channels a CTA, or 32 where 64 would leave fewer than two CTAs
    an SM (one slot's prompt: [1, S, 4096] gives 64 CTAs of 64)."""
    return 64 if bsz * -(-f // 64) >= 2 * sms else 32


def copy_bytes(f: int, *streams: torch.Tensor) -> int:
    """Bytes a ``cp.async`` copy of log_a and b takes: 16 when F % 4 == 0
    and every base address is 16-byte aligned (each step's row then keeps
    the alignment), else 4 (the wrapper admits 4-byte aligned inputs)."""
    return 16 if f % 4 == 0 and all(t.data_ptr() % 16 == 0
                                    for t in streams) else 4


def launch_plan(log_a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """(channels a CTA, bytes a copy) for these operands, from shapes and
    pointers."""
    bsz, _, f = log_a.shape
    return (cta_channels(bsz, f, _sm_count(log_a.device)),
            copy_bytes(f, log_a, b))


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.cache
def _launcher():
    fn = _build.library("rglru_scan").rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rglru_scan_state(log_a: torch.Tensor, b: torch.Tensor,
                     h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """log_a, b: [B, S, F] f32; h0: [B, F] f32 -> (h [B, S, F] f32,
    h_out [B, F] f32).  CUDA tensors only."""
    dev = log_a.device
    if dev.type != "cuda":
        raise ValueError(f"rglru_scan_state kernel needs CUDA tensors, got "
                         f"{dev}")
    for name, t, ndim in (("log_a", log_a, 3), ("b", b, 3), ("h0", h0, 2)):
        check_operand(name, t, dtype=torch.float32, ndim=ndim, device=dev,
                      align=4)
    bsz, s, f = log_a.shape
    if b.shape != log_a.shape or h0.shape != (bsz, f):
        raise ValueError(f"shapes log_a {tuple(log_a.shape)}, b "
                         f"{tuple(b.shape)}, h0 {tuple(h0.shape)} do not "
                         "match")
    h = torch.empty_like(b)
    h_out = torch.empty_like(h0)
    if bsz == 0 or f == 0:
        return h, h_out
    err = _launcher()(log_a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                      h.data_ptr(), h_out.data_ptr(), bsz, s, f,
                      *launch_plan(log_a, b),
                      torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan_state: CUDA error {err} at launch")
    rglru_scan_state.launches += 1
    return h, h_out


rglru_scan_state.launches = 0


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log_a, b: [B, S, F] f32 -> h [B, S, F], with h_{-1} = 0."""
    h0 = torch.zeros(b.shape[0], b.shape[2], dtype=torch.float32,
                     device=b.device)
    return rglru_scan_state(log_a, b, h0)[0]
