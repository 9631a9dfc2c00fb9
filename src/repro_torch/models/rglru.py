"""RG-LRU recurrent block (Griffin, arXiv:2402.19427): recurrentgemma's
recurrent unit, paired 2:1 with local attention.

    r_t = sigmoid(x W_a + b_a)                  # recurrence gate
    i_t = sigmoid(x W_x + b_x)                  # input gate
    a_t = exp(c * softplus(Lambda) * (-r_t))    # a^{c r_t}, a = sigmoid(Lambda)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Wrapped in the Griffin recipe: linear in, a short causal conv, a gated
GeLU branch, linear out.  Whole sequences (training, the one-shot
prefill) run :func:`rglru_block`, a log-depth parallel prefix in plain
torch that autograd differentiates, as the reference's
``associative_scan``; prefill chunks (and packed streams, scattered to
per-slot rows) advance the recurrence through
``kernels.rglru.rglru_state_op``, carrying ``h`` and the conv window across
chunk boundaries; decode is the one-token step.  Rounding follows the
reference: matrix products in the model's dtype, gates and the recurrence
in f32, the conv as a left-to-right sum over its taps in the model's dtype.

A tensor-parallel training step (``tp``, its placement splitting the
RG-LRU's ``ff`` dim, ``dr``, over ``model``: ``tp.split["rglru"]``)
runs :func:`rglru_block` on this rank's ``dr / M``
channels: ``w_in``, ``w_gate_branch`` and ``conv_w`` hold its columns,
``wa``, ``wx`` and ``w_out`` its rows.  The gates' products ``u @ wa``
and ``u @ wx`` contract over ``dr``, so each rank's is a part of the
whole gate input; one :func:`~repro_torch.distributed.collectives
.sum_to_slice` of both sums them over ``model`` and keeps this rank's
channels.  ``ba``, ``bx`` and ``lam`` stay whole and are used in part
(:data:`TP_PARTIAL`).  Where ``model`` does not divide ``dr`` the block
runs whole on every rank, as one process runs it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import (copy_to_model,
                                                 reduce_from_model,
                                                 sum_to_slice)
from repro_torch.distributed.sharding import A

from .layers import dense_init
from .remat import dot

CONV_WIDTH = 4
C_FACTOR = 8.0


def rglru_init(cfg, dtype, device, generator, lead: tuple[int, ...] = ()):
    """The reference's parameters: ``ba``, ``bx`` and ``lam`` are f32 in
    any model dtype; ``lead`` prepends stacking dims."""
    d = cfg.d_model
    dr = cfg.num_heads * cfg.resolved_head_dim     # recurrent width

    def dense(shape):
        return dense_init(lead + shape, dtype, device, generator)

    def full(value):
        return torch.full(lead + (dr,), value, dtype=torch.float32,
                          device=device)

    return {"w_in": dense((d, dr)), "w_gate_branch": dense((d, dr)),
            "conv_w": dense((CONV_WIDTH, dr)), "wa": dense((dr, dr)),
            "wx": dense((dr, dr)), "ba": full(0.0), "bx": full(0.0),
            "lam": full(3.0),                  # sigmoid(3) ~ 0.95 decay
            "w_out": dense((dr, d))}


def rglru_axes() -> dict:
    """The logical dim names of :func:`rglru_init`'s leaves."""
    return {"w_in": A("embed", "ff"), "w_gate_branch": A("embed", "ff"),
            "conv_w": A(None, "ff"),
            "wa": A("ff", None), "wx": A("ff", None),
            "ba": A("embed"), "bx": A("embed"), "lam": A("embed"),
            "w_out": A("ff", "embed")}


# the leaves a tensor-parallel rank uses only in part when ``dr`` is split:
# whole on every rank, narrowed to its channels
TP_PARTIAL = ("ba", "bx", "lam")


def _split(tp) -> bool:
    return tp is not None and tp.split["rglru"]


def init_state(cfg, batch: int, device, tp=None) -> dict:
    """Zero state ``{h: [B, dr], conv: [B, W-1, dr]}`` (f32); under a
    ``tp`` that splits ``dr``, of this rank's ``dr / M`` channels."""
    dr = cfg.num_heads * cfg.resolved_head_dim
    if _split(tp):
        dr //= tp.size
    return {"h": torch.zeros(batch, dr, dtype=torch.float32, device=device),
            "conv": torch.zeros(batch, CONV_WIDTH - 1, dr,
                                dtype=torch.float32, device=device)}


def _gates(params, u, pre=None):
    """u: [..., dr] -> (log_a, gated input), both f32.  ``pre``: the gate
    inputs ``(u @ wa, u @ wx)`` when the caller has them."""
    ga, gx = pre if pre is not None else (dot(u, params["wa"]),
                                          dot(u, params["wx"]))
    r = torch.sigmoid(ga.float() + params["ba"])
    i = torch.sigmoid(gx.float() + params["bx"])
    # jax.nn.softplus is exact: logaddexp, not torch's thresholded one
    softplus = torch.logaddexp(params["lam"], torch.zeros_like(params["lam"]))
    log_a = -C_FACTOR * softplus * r                 # log a_t < 0
    a2 = torch.exp(2.0 * log_a)
    scaled_in = torch.sqrt(torch.clamp(1.0 - a2, min=1e-9)) * (i * u.float())
    return log_a, scaled_in


def _conv_taps(ext, w, length: int):
    """The reference's ``sum(ext[:, i:i + C] * w[i])``: left to right,
    each product and partial sum rounded in the model's dtype."""
    out = ext[:, 0:length] * w[0]
    for i in range(1, CONV_WIDTH):
        out = out + ext[:, i:i + length] * w[i]
    return out


def _gate_out(params, x, h):
    """The gated GeLU branch times the recurrence, then ``w_out``."""
    gate = F.gelu(dot(x, params["w_gate_branch"]).float(), approximate="tanh")
    return dot((h.float() * gate).to(x.dtype), params["w_out"])


def _doubling_scan(log_a, b):
    """Inclusive scan of ``h_t = exp(log_a_t) h_{t-1} + b_t`` along dim 1
    ([B, T, F] f32, element 0 the seed), by doubling: at k = 1, 2, 4, ...
    element t takes in element t - k under the reference's combine
    ``(a1 + a2, exp(a2) b1 + b2)``.  Every partial sum of ``log_a`` is
    <= 0, so ``exp`` never overflows; each level is out of place, so
    autograd differentiates it.  Returns the scanned ``b`` (= h)."""
    t, k = log_a.shape[1], 1
    while k < t:
        b = torch.cat([b[:, :k], torch.exp(log_a[:, k:]) * b[:, :-k]
                       + b[:, k:]], dim=1)
        if 2 * k < t:           # the last level needs no more log_a
            log_a = torch.cat([log_a[:, :k], log_a[:, :-k] + log_a[:, k:]],
                              dim=1)
        k *= 2
    return b


def rglru_block(params, x, state, tp=None):
    """The one-shot form over a whole sequence (training, the one-shot
    prefill).  x: [B,S,d]; state {h: [B,dr] f32, conv: [B,W-1,dr]}
    carried in.  The recurrence is seeded with ``(0, h)`` at t = -1, as
    the reference seeds its ``associative_scan``; the doubling scan
    combines in another tree, so results agree with it to f32 rounding.
    Returns (y [B,S,d], {h: h at the last step (f32), conv: the last W-1
    entries of [conv ++ u] in u's dtype}); the caller's state is not
    modified.

    Under ``tp`` (a tensor-parallel training step's ``ModelParallel``)
    whose placement splits ``dr``: ``x`` enters through
    ``copy_to_model``; ``u``, the conv, the gates and the scan run on
    this rank's channels, from ``state`` of that width
    (:func:`init_state` with ``tp``); the two gate products, stacked
    ``[B, S, 2, dr]``, pass one ``sum_to_slice``; ``w_out``'s partial
    output is summed by ``reduce_from_model``.  With ``dr`` replicated
    the block runs whole, as on one device."""
    split = _split(tp)
    p = params
    if split:
        dr = params["ba"].shape[-1]
        if params["w_in"].shape[-1] * tp.size != dr:
            raise ValueError(f"w_in holds {params['w_in'].shape[-1]} "
                             f"channels, not {dr} / {tp.size}")
        x = copy_to_model(x, tp)
        p = dict(params, **{k: tp.own(params[k]) for k in TP_PARTIAL})
    s = x.shape[1]
    u = dot(x, params["w_in"])
    ext = torch.cat([state["conv"].to(u.dtype), u], dim=1)
    u_conv = _conv_taps(ext, params["conv_w"], s)
    pre = None
    if split:
        pre = sum_to_slice(torch.stack([dot(u_conv, params["wa"]),
                                        dot(u_conv, params["wx"])], dim=-2),
                           tp).unbind(-2)
    log_a, inp = _gates(p, u_conv, pre)
    h = _doubling_scan(
        torch.cat([torch.zeros_like(log_a[:, :1]), log_a], dim=1),
        torch.cat([state["h"].float()[:, None, :], inp], dim=1))[:, 1:]
    new_state = {"h": h[:, -1], "conv": ext[:, -(CONV_WIDTH - 1):]}
    y = _gate_out(params, x, h)
    return (reduce_from_model(y, tp) if split else y), new_state


def rglru_chunk(params, x, state, valid):
    """Padded-chunk RG-LRU (the scan-state ABI).

    x: [B,C,d], rows left-aligned; valid: [B,C] bool marks real tokens;
    state {h: [B,dr] f32, conv: [B,W-1,dr]} carried in from the previous
    chunk.  Pads are neutral — log_a = 0 and gated input 0 — so ``h``
    passes through them unchanged, and the conv carry advances to each
    row's last W-1 valid inputs.  Returns (y [B,C,d], new state); the
    caller's state is not modified."""
    from repro_torch.kernels.rglru import rglru_state_op
    c = x.shape[1]
    u = x @ params["w_in"]
    ext = torch.cat([state["conv"].to(u.dtype), u], dim=1)
    u_conv = _conv_taps(ext, params["conv_w"], c)
    log_a, inp = _gates(params, u_conv)
    vm = valid[:, :, None]
    log_a = torch.where(vm, log_a, 0.0)
    inp = torch.where(vm, inp, 0.0)
    h_seq, h_out = rglru_state_op(log_a.contiguous(), inp.contiguous(),
                                  state["h"].float().contiguous())
    # conv carry: the last W-1 entries of [old conv ++ valid inputs] per row
    lengths = valid.sum(dim=1)
    idx = lengths[:, None] + torch.arange(CONV_WIDTH - 1,
                                          device=x.device)[None, :]
    new_conv = torch.gather(ext, 1, idx[:, :, None].expand(
        -1, -1, ext.shape[2]))
    new_state = {"h": h_out.to(state["h"].dtype),
                 "conv": new_conv.to(state["conv"].dtype)}
    return _gate_out(params, x, h_seq), new_state


def rglru_step(params, x_t, state):
    """One decode token.  x_t: [B,d] -> (y [B,d], new state)."""
    u = x_t @ params["w_in"]
    xs = torch.cat([state["conv"].to(u.dtype), u[:, None, :]], dim=1)
    u_conv = _conv_taps(xs, params["conv_w"], 1)[:, 0]
    log_a, inp = _gates(params, u_conv)
    h = torch.exp(log_a) * state["h"].float() + inp
    return _gate_out(params, x_t, h), {"h": h, "conv": xs[:, 1:, :]}
