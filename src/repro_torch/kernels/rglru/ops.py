"""Device dispatch for the RG-LRU scan: CPU tensors run the plain version,
CUDA tensors launch the kernel (or raise)."""

from __future__ import annotations

from repro_torch.kernels import use_plain

from .ref import rglru_ref, rglru_ref_state
from .rglru import rglru_scan, rglru_scan_state


def rglru_state_op(log_a, b, h0):
    """State-in/state-out scan: (h [B,S,F], h_out [B,F] f32) seeded from
    ``h0`` — the entry point of chunked and packed prefill, which carry
    each row's state across chunk boundaries."""
    if use_plain(log_a, b, h0):
        return rglru_ref_state(log_a, b, h0)
    return rglru_scan_state(log_a, b, h0)


def rglru_op(log_a, b):
    """log_a, b: [B,S,F] -> h [B,S,F], with h_{-1} = 0."""
    if use_plain(log_a, b):
        return rglru_ref(log_a, b)
    return rglru_scan(log_a, b)
