"""Plain PyTorch oracle for the RWKV-6 recurrence (the time mix core).

    y_t[j]  = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
    S[i, j] <- exp(logw_t[i]) * S[i, j] + k_t[i] * v_t[j]

``rwkv6_ref_state`` is the state-in/state-out form behind chunked and
packed prefill: ``S`` starts from the caller's carried matrix and the
state after the last step comes back beside the per-step outputs.  A plain
f32 loop over time, one step per time index.
"""

from __future__ import annotations

import torch


def rwkv6_ref_state(r, k, v, logw, u, s0):
    """r, k, v, logw: [BH, S, N]; u: [BH, N]; s0: [BH, N, N] carried state
    (row i indexes k and w, column j indexes v).
    Returns (y [BH, S, N] in r's dtype, s_out [BH, N, N] f32)."""
    rf, kf, vf, lwf = (t.float() for t in (r, k, v, logw))
    uf = u.float()[:, :, None]
    state = s0.float()
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    for t in range(r.shape[1]):
        kv = kf[:, t, :, None] * vf[:, t, None, :]               # [BH, N, N]
        y[:, t] = torch.einsum("bi,bij->bj", rf[:, t], state + uf * kv)
        state = torch.exp(lwf[:, t])[:, :, None] * state + kv
    return y.to(r.dtype), state


def rwkv6_ref(r, k, v, logw, u):
    """r, k, v, logw: [BH, S, N]; u: [BH, N] -> y [BH, S, N], from a zero
    state."""
    bh, _, n = r.shape
    s0 = torch.zeros(bh, n, n, dtype=torch.float32, device=r.device)
    return rwkv6_ref_state(r, k, v, logw, u, s0)[0]
