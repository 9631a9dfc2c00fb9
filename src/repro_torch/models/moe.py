"""Fine-grained Mixture-of-Experts layer (DeepSeekMoE / Llama-4 style).

The reference's single-device dispatch (``moe_apply``), step for step:

  * shared experts always on, routed experts top-k over softmax router
    probabilities (f32), renormalised over the k picked;
  * tokens are processed in fixed GROUPS along the sequence (up to
    :data:`GROUP_TOKENS`) and capacity is per group, ``C = ceil(group *
    top_k / E * capacity_factor)``; each assignment's position inside its
    expert is a token-major cumsum, assignments at or past ``C`` drop to
    the shared path only;
  * token ids are scattered into ``[G, E, C]`` slot tables, tokens
    gathered into expert slots, the expert products run batched
    (``[E, G*C, d] x [E, d, m]``, library matrix products, as the
    reference computes them in XLA outside any kernel), and each
    assignment's slot output is gathered back and weighted.

Nothing reads the device: the drop-mode scatter into the slot table is a
``scatter_`` whose dropped assignments land in one extra trash cell that
is sliced away, the valid-aware capacity is a device ``clamp``, and the
top-k order among equal probabilities is the reference's (lower expert
index first) through a stable sort.  The expert-parallel bodies (a mesh)
are not ported: with no mesh the reference falls back to this function.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import dense_init

GROUP_TOKENS = 512


def moe_init(cfg, dtype, device, generator,
             lead: tuple[int, ...] = ()) -> dict:
    """The reference's leaves: ``router`` [d, E] f32 in any model dtype,
    ``w_gate``/``w_up`` [E, d, m], ``w_down`` [E, m, d] and, with shared
    experts, ``shared.{w_gate, w_up, w_down}`` at width ``moe_d_ff x
    num_shared_experts``; fan-in is ``shape[-2]``.  ``lead`` prepends
    stacking dims.  Each leaf is drawn one matrix at a time (a layer's
    expert at a time), so the f32 draw never holds more than one matrix:
    a whole leaf of deepseek-moe-16b's would be 19.9 GB in f32."""
    d, e, m = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def dense(shape, dt=dtype):
        out = torch.empty(lead + shape, dtype=dt, device=device)
        flat = out.view((-1,) + shape[-2:])
        for i in range(flat.shape[0]):
            flat[i] = dense_init(shape[-2:], dt, device, generator)
        return out

    params = {"router": dense((d, e), torch.float32),
              "w_gate": dense((e, d, m)), "w_up": dense((e, d, m)),
              "w_down": dense((e, m, d))}
    if cfg.num_shared_experts:
        ms = m * cfg.num_shared_experts
        params["shared"] = {"w_gate": dense((d, ms)), "w_up": dense((d, ms)),
                            "w_down": dense((ms, d))}
    return params


def _group_shape(batch: int, seq: int) -> tuple[int, int]:
    g_tokens = min(GROUP_TOKENS, seq)
    while seq % g_tokens:
        g_tokens -= 1
    return batch * (seq // g_tokens), g_tokens


def _valid_cap(nv, cap: int, cfg):
    """Drop threshold for groups of ``nv`` ([G]) real tokens: capacity
    scales with the valid-token count so padding can neither steal nor
    inflate expert capacity; ``cap`` (over the padded group) stays the
    slot-table shape and upper bound."""
    cap_v = torch.ceil(nv.float() * cfg.top_k / cfg.num_experts
                       * cfg.capacity_factor)
    return cap_v.int().clamp(1, cap)


def route(probs, k: int):
    """Top-k of the router probabilities (``[..., E]``), ties broken as
    ``jax.lax.top_k`` breaks them, lower expert index first:
    ``(top_p, top_i)``."""
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_p[..., :k], top_i[..., :k]


def assign(probs, cfg, cap: int, valid=None):
    """Routing and capacity for router probabilities ``probs`` [G, T, E]
    of groups of T tokens: ``(top_p [G,T,K] renormalised, top_i [G,T,K],
    pos [G,T*K] each assignment's place in its expert, keep [G,T*K])``,
    token-major: assignment ``t*K + j`` is token t's j-th pick."""
    g, gt, e = probs.shape
    k = cfg.top_k
    top_p, top_i = route(probs, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)

    # position of each assignment inside its expert (token-major priority)
    flat_i = top_i.reshape(g, gt * k)
    onehot = (flat_i[..., None]
              == torch.arange(e, device=probs.device)).int()     # [G,TK,E]
    if valid is not None:
        # token-major repeat matches flat_i's [T, K] -> [T*K] layout
        valid_flat = valid.reshape(g, gt).repeat_interleave(k, dim=1)
        onehot = onehot * valid_flat[..., None].int()
    pos = onehot.cumsum(dim=1, dtype=torch.int32) - onehot
    pos = pos.gather(2, flat_i[..., None])[..., 0]                # [G,TK]
    if valid is None:
        return top_p, top_i, pos, pos < cap
    cap_v = _valid_cap(valid.reshape(g, gt).sum(dim=1), cap, cfg)
    return top_p, top_i, pos, valid_flat & (pos < cap_v[:, None])


def capacity(cfg, group_tokens: int) -> int:
    """Slots per expert in a group of ``group_tokens`` tokens."""
    return max(1, math.ceil(group_tokens * cfg.top_k / cfg.num_experts
                            * cfg.capacity_factor))


def moe_apply(params: dict, x, cfg, *, return_aux: bool = False,
              valid=None):
    """x: [B, S, d] -> [B, S, d] (and the Switch-style load-balancing aux
    loss, an f32 scalar, with ``return_aux``).

    ``valid`` ([B, S] bool, optional) marks real tokens in a padded chunk,
    a packed stream or a decode batch: invalid tokens are left out of the
    position-in-expert count and never kept, and each group's capacity is
    clamped to ``ceil(n_valid * k / E * capacity_factor)``.  The drop
    pattern depends on the grouping (:func:`_group_shape` of ``(B, S)``),
    as in the reference."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    g, gt = _group_shape(b, s)
    cap = capacity(cfg, gt)
    dev = x.device

    xg = x.reshape(g, gt, d)
    probs = torch.softmax(xg.float() @ params["router"], dim=-1)  # [G,T,E]
    top_p, top_i, pos, keep = assign(probs, cfg, cap, valid)

    # slot tables: token index per (expert, capacity) slot, gt = no token;
    # a dropped assignment writes the trash cell (E, C), sliced away
    row = cap + 1
    cell = torch.where(keep, top_i.reshape(g, gt * k) * row + pos,
                       e * row + cap)
    token_ids = torch.arange(gt, device=dev).repeat_interleave(k)
    slot_tok = torch.full((g, (e + 1) * row), gt, dtype=torch.long,
                          device=dev)
    slot_tok.scatter_(1, cell, token_ids.expand(g, gt * k))
    slot_tok = slot_tok.view(g, e + 1, row)[:, :e, :cap]          # [G,E,C]

    # gather tokens into expert slots; the sentinel row reads zeros
    xg_pad = torch.cat([xg, xg.new_zeros(g, 1, d)], dim=1)
    groups = torch.arange(g, device=dev)
    expert_in = xg_pad[groups[:, None, None], slot_tok]           # [G,E,C,d]

    # batched expert products over the expert axis
    ein = expert_in.permute(1, 0, 2, 3).reshape(e, g * cap, d)
    act = F.silu(ein @ params["w_gate"]) * (ein @ params["w_up"])
    expert_out = (act @ params["w_down"]).view(e, g, cap, d) \
        .permute(1, 0, 2, 3)                                      # [G,E,C,d]

    # combine: gather each assignment's slot output, weight, sum over k
    flat_pos = pos.view(g, gt, k)
    flat_keep = keep.view(g, gt, k)
    gather_idx = (top_i * cap + flat_pos).clamp(0, e * cap - 1)   # [G,T,K]
    eo_flat = expert_out.reshape(g, e * cap, d)
    picked = eo_flat[groups[:, None, None], gather_idx]           # [G,T,K,d]
    w = (top_p * flat_keep).to(picked.dtype)[..., None]
    out = (picked * w).sum(dim=2)                                 # [G,T,d]

    if "shared" in params:
        sh = params["shared"]
        hs = F.silu(xg @ sh["w_gate"]) * (xg @ sh["w_up"])
        out = out + hs @ sh["w_down"]

    out = out.reshape(b, s, d)
    if not return_aux:
        return out
    # load-balance aux loss (Switch style): E * sum_e f_e * p_e
    frac_tokens = (top_i[..., 0, None] == torch.arange(e, device=dev)) \
        .float().mean(dim=(0, 1))
    aux = e * (frac_tokens * probs.mean(dim=(0, 1))).sum()
    return out, aux


def moe_reference(params: dict, x, cfg):
    """Oracle: per-token loop over the selected experts, no capacity
    drops.  Used by tests only."""
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    top_p, top_i = route(probs, cfg.top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    out = torch.zeros_like(x)
    for kk in range(cfg.top_k):
        idx = top_i[..., kk]                                      # [B,S]
        wg = params["w_gate"][idx]                                # [B,S,d,m]
        wu = params["w_up"][idx]
        wd = params["w_down"][idx]
        h = F.silu(torch.einsum("bsd,bsdm->bsm", x, wg)) * \
            torch.einsum("bsd,bsdm->bsm", x, wu)
        y = torch.einsum("bsm,bsmd->bsd", h, wd)
        out = out + y * top_p[..., kk, None].to(x.dtype)
    if "shared" in params:
        sh = params["shared"]
        hs = F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])
        out = out + hs @ sh["w_down"]
    return out
