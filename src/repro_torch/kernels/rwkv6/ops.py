"""Device dispatch for the RWKV-6 scan: CPU tensors run the plain version,
CUDA tensors launch the kernel (or raise)."""

from __future__ import annotations

from repro_torch.kernels import use_plain

from .ref import rwkv6_ref, rwkv6_ref_state
from .rwkv6 import rwkv6_scan, rwkv6_scan_state


def rwkv6_state_op(r, k, v, logw, u, s0):
    """State-in/state-out time mix: (y [BH,S,N], s_out [BH,N,N] f32) seeded
    from ``s0`` — the entry point of chunked and packed prefill, which
    carry each row's state across chunk boundaries."""
    if use_plain(r, k, v, logw, u, s0):
        return rwkv6_ref_state(r, k, v, logw, u, s0)
    return rwkv6_scan_state(r, k, v, logw, u, s0)


def rwkv6_op(r, k, v, logw, u):
    """r, k, v, logw: [BH,S,N]; u: [BH,N] -> y [BH,S,N], from a zero
    state."""
    if use_plain(r, k, v, logw, u):
        return rwkv6_ref(r, k, v, logw, u)
    return rwkv6_scan(r, k, v, logw, u)
