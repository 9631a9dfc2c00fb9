"""Plain PyTorch oracle for the RG-LRU recurrence.

    h_t = exp(log_a_t) * h_{t-1} + b_t

``rglru_ref_state`` is the state-in/state-out form behind chunked and
packed prefill: ``h`` starts from the caller's carried value and the
state after the last step comes back beside the per-step outputs.  A plain
f32 loop over time, one step per time index.
"""

from __future__ import annotations

import torch


def rglru_ref_state(log_a, b, h0):
    """log_a, b: [B, S, F]; h0: [B, F] carried state.
    Returns (h [B, S, F] in b's dtype, h_out [B, F] f32)."""
    h = h0.float()
    out = torch.empty(b.shape, dtype=torch.float32, device=b.device)
    for t in range(b.shape[1]):
        h = torch.exp(log_a[:, t].float()) * h + b[:, t].float()
        out[:, t] = h
    return out.to(b.dtype), h


def rglru_ref(log_a, b):
    """log_a, b: [B, S, F] -> h [B, S, F], with h_{-1} = 0."""
    h0 = torch.zeros(b.shape[0], b.shape[2], dtype=torch.float32,
                     device=b.device)
    return rglru_ref_state(log_a, b, h0)[0]
