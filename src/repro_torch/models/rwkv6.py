"""RWKV-6 "Finch" block (arXiv:2404.05892): rwkv6-7b's attention-free time
mix with data-dependent decay, plus its channel mix.

State per head: S in R^{N x N} (N = head dim, 64).  Per-token recurrence:

    S_t[i, j] = w_t[i] * S_{t-1}[i, j] + k_t[i] * v_t[j]
    y_t[j]    = sum_i r_t[i] * (S_{t-1}[i, j] + u[i] * k_t[i] * v_t[j])

with w_t = exp(-exp(w0 + lora_w(x_t))) the Finch data-dependent decay.
Heads are ``d // 64``, whatever ``cfg.num_heads`` says.  Whole sequences
(training, the one-shot prefill) run :func:`time_mix_chunked`, the
reference's chunked closed form in plain torch that autograd
differentiates.  Prefill chunks (and packed streams, scattered to
per-slot rows) advance the recurrence through
``kernels.rwkv6.rwkv6_state_op``, carrying ``S`` and both token shifts
across chunk boundaries; decode is the one-token step in plain
torch, as in the reference.  Rounding follows the reference: projections
in the model's dtype, the decay, the recurrence and the group norm in f32,
the gate's SiLU in the model's dtype.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import A

from .layers import dense_init, torch_dtype

HEAD_DIM = 64
LORA_DIM = 64
CHUNK = 32  # the closed form's decay kernel D is O(B * L^2 * d)


def rwkv6_init(cfg, dtype, device, generator, lead: tuple[int, ...] = ()):
    """The reference's parameters: ``w0`` and ``u`` are f32 in any model
    dtype; ``lead`` prepends stacking dims."""
    d = cfg.d_model
    h = d // HEAD_DIM

    def dense(shape):
        return dense_init(lead + shape, dtype, device, generator)

    def full(shape, value, dt=dtype):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    return {
        # token-shift mixing coefficients (static per channel)
        "mu_r": full((d,), 0.5), "mu_k": full((d,), 0.5),
        "mu_v": full((d,), 0.5), "mu_g": full((d,), 0.5),
        "mu_w": full((d,), 0.5),
        "wr": dense((d, d)), "wk": dense((d, d)), "wv": dense((d, d)),
        "wg": dense((d, d)), "wo": dense((d, d)),
        # data-dependent decay: w0 + tanh(x A) B (LoRA, Finch eq. 6)
        "w0": full((d,), -6.0, torch.float32),
        "w_lora_a": dense((d, LORA_DIM)), "w_lora_b": dense((LORA_DIM, d)),
        "u": full((h, HEAD_DIM), 0.0, torch.float32),       # bonus
        "ln_scale": full((d,), 1.0),                        # group norm
        # channel mix
        "cm_mu": full((d,), 0.5),
        "cm_k": dense((d, cfg.d_ff)), "cm_v": dense((cfg.d_ff, d)),
    }


def rwkv6_axes() -> dict:
    """The logical dim names of :func:`rwkv6_init`'s leaves."""
    return {
        "mu_r": A("embed"), "mu_k": A("embed"), "mu_v": A("embed"),
        "mu_g": A("embed"), "mu_w": A("embed"),
        "wr": A("embed", "ff"), "wk": A("embed", "ff"),
        "wv": A("embed", "ff"), "wg": A("embed", "ff"),
        "wo": A("ff", "embed"),
        "w0": A("embed"),
        "w_lora_a": A("embed", None), "w_lora_b": A(None, "embed"),
        "u": A("heads", None),
        "ln_scale": A("embed"),
        "cm_mu": A("embed"),
        "cm_k": A("embed", "ff"), "cm_v": A("ff", "embed"),
    }


def init_state(cfg, batch: int, device) -> dict:
    """``S [B, H, N, N]`` f32 and the two token shifts ``[B, d]`` in the
    model's dtype."""
    h = cfg.d_model // HEAD_DIM
    dt = torch_dtype(cfg.dtype)
    return {"S": torch.zeros(batch, h, HEAD_DIM, HEAD_DIM,
                             dtype=torch.float32, device=device),
            "tm_last": torch.zeros(batch, cfg.d_model, dtype=dt,
                                   device=device),
            "cm_last": torch.zeros(batch, cfg.d_model, dtype=dt,
                                   device=device)}


def _mix(x, x_prev, mu):
    """Token shift: lerp between the current and the previous token."""
    return x + (x_prev - x) * mu


def _shifted(x, x_last):
    """The previous token of every position of x [B,C,d]: ``x_last`` [B,d]
    first, then x without its last position."""
    return torch.cat([x_last[:, None, :], x[:, :-1, :]], dim=1)


def _projections(params, x, x_prev):
    """r, k, v, g in the model's dtype and logw (f32) from the shifted
    inputs.  x, x_prev: [..., d]."""
    r = _mix(x, x_prev, params["mu_r"]) @ params["wr"]
    k = _mix(x, x_prev, params["mu_k"]) @ params["wk"]
    v = _mix(x, x_prev, params["mu_v"]) @ params["wv"]
    g = _mix(x, x_prev, params["mu_g"]) @ params["wg"]
    xw = _mix(x, x_prev, params["mu_w"])
    lora = torch.tanh(xw @ params["w_lora_a"]) @ params["w_lora_b"]
    logw = -torch.exp(params["w0"] + lora.float())          # log(w) < 0
    return r, k, v, g, logw


def _heads(x, h: int):
    return x.unflatten(-1, (h, HEAD_DIM))


def _groupnorm(y, scale):
    """Per-head RMS normalisation of the time mix's output [..., H, N]
    (eps 1e-5), flattened to [..., d] and scaled, in y's dtype."""
    dt = y.dtype
    y32 = y.float()
    var = y32.square().mean(dim=-1, keepdim=True)
    flat = (y32 * torch.rsqrt(var + 1e-5)).flatten(-2)
    return (flat * scale.float()).to(dt)


def _out(params, y, g, dtype):
    """The gated output: group norm, times SiLU(g) (each op rounded in g's
    dtype, as ``jax.nn.silu`` does), then ``wo``."""
    y = _groupnorm(y, params["ln_scale"])
    return (y * (g * torch.sigmoid(g))).to(dtype) @ params["wo"]


def chunk_lengths(s: int) -> list[int]:
    """How :func:`time_mix_chunked` cuts a sequence of ``s`` steps: ``n =
    max(1, s // CHUNK)`` chunks of ``s // n`` steps (the reference's own
    split, wherever its ``L * n_chunks == s`` holds), then one last chunk
    of the remainder, where the reference rejects the length (97 ->
    32, 32, 32, 1)."""
    n = max(1, s // CHUNK)
    size, rest = divmod(s, n)
    return [size] * n + ([rest] if rest else [])


def _chunk_closed_form(state, r, k, v, logw, u):
    """One chunk of the reference's closed form, term for term.  r, k, v,
    logw: [B,L,H,N] f32; state: S [B,H,N,N] f32 before the chunk; u:
    [H,N].  Returns (S after the chunk, y [B,L,H,N])."""
    length = logw.shape[1]
    cum = torch.cumsum(logw, dim=1)                          # inclusive
    ecum = cum - logw                                        # exclusive
    # D[t,s,i] = prod_{s<u<t} w_u = exp(ecum_t - cum_s), strictly s < t;
    # the exponent is masked before exp (exp(-inf) = 0, the reference's
    # where), so no overflow above the diagonal reaches the gradient
    strict = torch.ones(length, length, dtype=torch.bool,
                        device=logw.device).tril(-1)[None, :, :, None, None]
    decay = torch.exp(torch.where(strict, ecum[:, :, None] - cum[:, None],
                                  float("-inf")))            # [B,L,L,H,N]
    # the reference's einsums blhi,blshi,bshi,bshj->blhj and
    # blhi,hi,blhi,blhj->blhj, with the sums over i taken first: products
    # a GPU batches well, where a four-operand einsum lowers to many tiny
    # batched products
    att = (r[:, :, None] * decay * k[:, None]).sum(-1)       # [B,L,L,H]
    y_intra = torch.einsum("blsh,bshj->blhj", att, v)
    y_diag = (r * u * k).sum(-1, keepdim=True) * v
    y_cross = torch.einsum("blhi,bhij->blhj", r * torch.exp(ecum), state)
    # S' = diag(A_total) S + sum_s (A_total / A_s) k_s v_s^T
    decay_k = torch.exp(cum[:, -1:] - cum) * k
    state = (torch.exp(cum[:, -1])[..., None] * state
             + torch.einsum("blhi,blhj->bhij", decay_k, v))
    return state, y_intra + y_diag + y_cross


def time_mix_chunked(params, x, state, x_last):
    """The one-shot time mix over a whole sequence (training, the one-shot
    prefill).  x: [B,S,d] ln1-normalised; state: S [B,H,N,N]; x_last:
    [B,d], the token before x.  A Python loop over :func:`chunk_lengths`
    carries S through :func:`_chunk_closed_form` (the reference's
    ``lax.scan``).  Returns (y [B,S,d], S' [B,H,N,N] f32, x_last' [B,d]);
    the caller's state is not modified."""
    h = x.shape[-1] // HEAD_DIM
    r, k, v, g, logw = _projections(params, x, _shifted(x, x_last))
    r, k, v, logw = (_heads(t, h).float() for t in (r, k, v, logw))
    u = params["u"].float()
    state, ys, t0 = state.float(), [], 0
    for length in chunk_lengths(x.shape[1]):
        sl = slice(t0, t0 + length)
        state, y = _chunk_closed_form(state, r[:, sl], k[:, sl], v[:, sl],
                                      logw[:, sl], u)
        ys.append(y)
        t0 += length
    return _out(params, torch.cat(ys, dim=1), g, x.dtype), state, x[:, -1]


def _last_valid(seq, prev, lengths):
    """Per-row last valid timestep of ``seq`` [B,S,d]; rows with
    ``lengths == 0`` keep their carried ``prev`` [B,d]."""
    idx = (lengths - 1).clamp(0, seq.shape[1] - 1).long()
    picked = seq[torch.arange(seq.shape[0], device=seq.device), idx]
    return torch.where((lengths > 0)[:, None], picked, prev)


def time_mix_chunk(params, x, state, x_last, valid):
    """Padded-chunk time mix (the scan-state ABI).

    x: [B,C,d] ln1-normalised chunk, rows left-aligned; valid: [B,C] bool
    marks real tokens; state: S [B,H,N,N] f32; x_last: [B,d].  Pads are
    neutral — r, k, v = 0 and logw = 0 (decay 1) — so S passes through
    them unchanged and comes back as the state after each row's last valid
    token; outputs at pads are garbage (callers mask by position).  Rows
    with no valid token keep S and x_last.  The reference also pads time
    to a multiple of its kernel's 32-step chunk with more neutral steps;
    the CUDA kernel takes any length, so nothing is padded here.
    Returns (y [B,C,d], S' [B,H,N,N] f32, x_last' [B,d])."""
    from repro_torch.kernels.rwkv6 import rwkv6_state_op

    b, c, d = x.shape
    h = d // HEAD_DIM
    r, k, v, g, logw = _projections(params, x, _shifted(x, x_last))
    vm = valid[:, :, None, None]

    def to_bh(t):
        t = torch.where(vm, _heads(t, h), 0.0).float()      # [B,C,H,N]
        return t.transpose(1, 2).reshape(b * h, c, HEAD_DIM)

    u = params["u"].float()[None].expand(b, h, HEAD_DIM).reshape(
        b * h, HEAD_DIM)
    y, s_out = rwkv6_state_op(
        *(to_bh(t).contiguous() for t in (r, k, v, logw)), u.contiguous(),
        state.float().reshape(b * h, HEAD_DIM, HEAD_DIM).contiguous())
    y = y.reshape(b, h, c, HEAD_DIM).transpose(1, 2)         # [B,C,H,N]
    lengths = valid.sum(dim=1)
    return (_out(params, y, g, x.dtype),
            s_out.reshape(b, h, HEAD_DIM, HEAD_DIM),
            _last_valid(x, x_last, lengths))


def channel_mix_chunk(params, x, x_last, valid):
    """Padded-chunk channel mix: :func:`channel_mix` over [B,C,d], with the
    carried token shift advanced to each row's last valid position (pads
    and empty rows never touch it)."""
    out, _ = channel_mix(params, x, x_last)
    return out, _last_valid(x, x_last, valid.sum(dim=1))


def time_mix_step(params, x_t, state, x_last):
    """One decode token.  x_t: [B,d]; state: S [B,H,N,N] f32; x_last:
    [B,d] -> (y [B,d], S', x_t)."""
    h = x_t.shape[-1] // HEAD_DIM
    r, k, v, g, logw = _projections(params, x_t, x_last)
    r, k, v = (_heads(t, h).float() for t in (r, k, v))      # [B,H,N]
    w = torch.exp(_heads(logw, h))
    kv = k[..., :, None] * v[..., None, :]                   # [B,H,N,N]
    y = torch.einsum("bhi,bhij->bhj", r,
                     state + params["u"][..., None] * kv)
    state = w[..., None] * state + kv
    return _out(params, y, g, x_t.dtype), state, x_t


def channel_mix(params, x, x_last):
    """RWKV channel mix (the FFN analogue) over [B,S,d] or [B,d]; returns
    (out, the new token shift: the last position)."""
    if x.dim() == 3:
        x_prev, new_last = _shifted(x, x_last), x[:, -1, :]
    else:
        x_prev, new_last = x_last, x
    xk = _mix(x, x_prev, params["cm_mu"])
    hidden = torch.relu(xk @ params["cm_k"]).square()
    return hidden @ params["cm_v"], new_last
