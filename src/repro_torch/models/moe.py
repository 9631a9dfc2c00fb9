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
index first) through a stable sort.

The reference's expert-parallel bodies run under a serving mesh
(:func:`moe_apply_ep` on the packed tick, :func:`moe_apply_ep_serve` on
decode); without one, or where the experts do not divide the model axis,
they fall back to :func:`moe_apply`.  A rank holds the weights of its
``E / M`` experts (:func:`place_experts`), routes every token with the
full router, runs only the assignments its experts take, and one sum
over the mesh (``dist.all_reduce``) combines the ranks' contributions.
That sum adds the experts' outputs in another order than one device, so
the result agrees with :func:`moe_apply` to rounding, not bit for bit.

A tensor-parallel training step runs :func:`moe_apply_tp`, the same body
with gradients: the sum is ``collectives.reduce_from_model``, the router
is made whole by ``collectives.gather_from_slice``, and the aux loss is
counted once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import (all_reduce, copy_to_model,
                                                 gather_from_slice,
                                                 reduce_from_model)
from repro_torch.distributed.sharding import A, current_mesh

from .layers import dense_init, mlp
from .remat import dot

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
        if out.is_meta:
            return out
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


def moe_axes(cfg) -> dict:
    """The logical dim names of :func:`moe_init`'s leaves."""
    axes = {"router": A("embed", "experts"),
            "w_gate": A("experts", "embed", "moe_ff"),
            "w_up": A("experts", "embed", "moe_ff"),
            "w_down": A("experts", "moe_ff", "embed")}
    if cfg.num_shared_experts:
        axes["shared"] = {"w_gate": A("embed", "ff"), "w_up": A("embed", "ff"),
                          "w_down": A("ff", "embed")}
    return axes


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
              valid=None, one_group: bool = False):
    """x: [B, S, d] -> [B, S, d] (and the Switch-style load-balancing aux
    loss, an f32 scalar, with ``return_aux``).

    ``valid`` ([B, S] bool, optional) marks real tokens in a padded chunk,
    a packed stream or a decode batch: invalid tokens are left out of the
    position-in-expert count and never kept, and each group's capacity is
    clamped to ``ceil(n_valid * k / E * capacity_factor)``.  The drop
    pattern depends on the grouping (:func:`_group_shape` of ``(B, S)``),
    as in the reference; ``one_group`` takes all of x's tokens as one
    group, the capacity over them all, as the expert-parallel body over
    all ``E`` experts counts it."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    g, gt = (1, b * s) if one_group else _group_shape(b, s)
    cap = capacity(cfg, gt)
    dev = x.device

    xg = x.reshape(g, gt, d)
    probs = torch.softmax(dot(xg.float(), params["router"]),
                          dim=-1)                                 # [G,T,E]
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
        out = out + mlp(params["shared"], xg, "swiglu")

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


# ---------------------------------------------------------------------------
# Expert-parallel dispatch over a serving mesh
# ---------------------------------------------------------------------------
#
# Tokens stay replicated on every rank, experts split over 'model'; each
# rank runs only its local experts over the tokens and ONE sum over the
# mesh combines the top-k contributions.  Unlike moe_apply, the capacity
# is over all of the tokens at once (no groups), as in the reference's
# shard bodies: the two drop different assignments once an expert is
# over its capacity (dropped_assignments counts both).

_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def dropped_assignments(router, x, cfg, valid=None, *,
                        grouped: bool = True) -> int:
    """How many of x's ([B, S, d]) valid top-k assignments the capacity
    drops: :func:`moe_apply`'s, per :func:`_group_shape` group, or with
    ``grouped=False`` the expert-parallel bodies', one group over all the
    tokens.  Reads the device (a count, for diagnostics)."""
    b, s, d = x.shape
    g, gt = _group_shape(b, s) if grouped else (1, b * s)
    probs = torch.softmax(x.reshape(g, gt, d).float() @ router, dim=-1)
    keep = assign(probs, cfg, capacity(cfg, gt), valid)[3]
    n = b * s if valid is None else int(valid.sum())
    return n * cfg.top_k - int(keep.sum())


def _own_experts(params: dict, cfg, mesh) -> tuple:
    """This rank's ``(w_gate, w_up, w_down)`` of its ``E / M`` experts:
    views of full leaves, or the leaves themselves where the rank holds
    only its own (:func:`place_experts`)."""
    e_local = cfg.num_experts // mesh.shape["model"]
    e0 = mesh.model_index * e_local
    return tuple(params[n] if params[n].shape[0] == e_local
                 else params[n].narrow(0, e0, e_local)
                 for n in _EXPERT_LEAVES)


def _full_experts(params: dict, cfg) -> dict:
    """``params`` for :func:`moe_apply`, which needs every expert."""
    if params["w_gate"].shape[0] != cfg.num_experts:
        raise ValueError(f"{params['w_gate'].shape[0]} of {cfg.num_experts} "
                         "experts held: moe_apply needs them all")
    return params


def ep_applies(cfg, mesh, batch: int) -> bool:
    """Whether both expert-parallel paths run for a decode batch of
    ``batch`` rows under ``mesh`` (the packed tick's ``[1, P]`` stream
    always does when the experts divide the model axis)."""
    return (mesh is not None and "model" in mesh.axis_names
            and not cfg.num_experts % mesh.shape["model"]
            and not cfg.moe_d_ff % mesh.shape["data"]
            and not batch % mesh.shape["data"])


def place_experts(params, cfg, mesh, batch: int):
    """``params`` with every MoE layer's expert weights cut to this rank's
    ``E / M`` experts (new tensors; the rest is freed with the caller's
    tree), where both expert-parallel paths run (:func:`ep_applies`);
    else ``params`` itself.  Routers and shared experts stay whole."""
    if not ep_applies(cfg, mesh, batch) or mesh.shape["model"] == 1:
        return params
    e_local = cfg.num_experts // mesh.shape["model"]
    e0 = mesh.model_index * e_local

    def walk(tree):
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if not isinstance(tree, dict):
            return tree
        out = {k: walk(v) for k, v in tree.items()}
        if "moe" in tree:
            moe = tree["moe"]
            out["moe"] = dict(moe, **{
                n: moe[n].narrow(moe[n].dim() - 3, e0, e_local).clone()
                for n in _EXPERT_LEAVES})
        return out

    return walk(params)


def _moe_local(router, w_gate, w_up, w_down, x, valid, *, cfg, e_local,
               shard: int):
    """Shard body: this rank's experts ``[shard * e_local, ...)`` over the
    tokens of x [B, S, d] (valid [B, S] bool); returns the rank's partial
    routed output [B, S, d] (its experts' weighted contributions), to be
    summed over the ranks that share the tokens."""
    b, s, d = x.shape
    k = cfg.top_k
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)
    probs = torch.softmax(dot(xt.float(), router), dim=-1)  # full router
    top_p, top_i = route(probs, k)                        # global expert ids
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = capacity(cfg, t)

    # assignments targeting LOCAL experts only (invalid/pad tokens excluded
    # from the slot count so they cannot steal capacity)
    local_i = top_i.reshape(t * k) - shard * e_local      # [TK]
    is_local = (local_i >= 0) & (local_i < e_local)
    is_local &= valid.reshape(t).repeat_interleave(k)
    onehot = (torch.where(is_local, local_i, e_local)[:, None]
              == torch.arange(e_local, device=dev)).int()
    pos = onehot.cumsum(dim=0, dtype=torch.int32) - onehot
    pos = pos.gather(1, local_i.clamp(0, e_local - 1)[:, None])[:, 0]
    # the drop threshold scales with the REAL token count (see _valid_cap)
    keep = is_local & (pos < _valid_cap(valid.sum(), cap, cfg))

    # slot tables; a dropped assignment writes the trash cell, sliced away
    row = cap + 1
    cell = torch.where(keep, local_i * row + pos, e_local * row + cap)
    slot_tok = torch.full(((e_local + 1) * row,), t, dtype=torch.long,
                          device=dev)
    slot_tok.scatter_(0, cell.long(),
                      torch.arange(t, device=dev).repeat_interleave(k))
    slot_tok = slot_tok.view(e_local + 1, row)[:e_local, :cap]
    expert_in = torch.cat([xt, xt.new_zeros(1, d)])[slot_tok]  # [E_l,C,d]
    act = F.silu(expert_in @ w_gate) * (expert_in @ w_up)
    expert_out = act @ w_down                             # [E_l, C, d]

    gather_idx = (local_i.clamp(0, e_local - 1) * cap
                  + pos.clamp(0, cap - 1))
    picked = expert_out.reshape(e_local * cap, d)[gather_idx]   # [TK, d]
    w = (top_p.reshape(t * k) * keep).to(picked.dtype)
    return (picked * w[:, None]).view(t, k, d).sum(dim=1).view(b, s, d)


def moe_apply_ep(params: dict, x, cfg, *, return_aux: bool = False,
                 valid=None):
    """Expert-parallel MoE under the active serving mesh; :func:`moe_apply`
    when there is none or the experts do not divide the model axis.

    Every rank holds all of x's tokens (the serve engine's packed stream,
    one ``[1, P]`` row) and routes them all; only the experts shard, their
    contributions summed over ``model``.  The reference splits a batch
    its data axes divide over them; no port path passes one under a
    mesh, so that split is not ported.  ``valid`` masks pad tokens out
    of the capacity count."""
    mesh = current_mesh()
    if (mesh is None or "model" not in mesh.axis_names
            or cfg.num_experts % mesh.shape["model"]):
        return moe_apply(_full_experts(params, cfg), x, cfg,
                         return_aux=return_aux, valid=valid)
    e_local = cfg.num_experts // mesh.shape["model"]
    if valid is None:
        valid = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    out = _moe_local(params["router"], *_own_experts(params, cfg, mesh),
                     x, valid, cfg=cfg, e_local=e_local,
                     shard=mesh.model_index)
    out = all_reduce(out, mesh, "model")

    if "shared" in params:
        out = out + mlp(params["shared"], x, "swiglu")
    if not return_aux:
        return out
    return out, _router_aux(params["router"], x, cfg)


def _router_aux(router, x, cfg):
    """The load-balancing aux loss of the expert-parallel bodies, computed
    on the (cheap, replicated) router pass over x [B, S, d]: ``E * sum_e
    f_e * p_e``, ``f_e`` the share of tokens whose top pick is ``e``,
    ``p_e`` its mean probability."""
    probs = torch.softmax(dot(x.float(), router), dim=-1)
    top1 = probs.argmax(dim=-1)
    frac = (top1[..., None] == torch.arange(cfg.num_experts,
                                            device=x.device)).float() \
        .mean(dim=(0, 1))
    return cfg.num_experts * (frac * probs.mean(dim=(0, 1))).sum()


def moe_apply_tp(params: dict, x, cfg, tp, *, return_aux: bool = False):
    """The MoE layer in a tensor-parallel training step: the training
    counterpart of :func:`moe_apply_ep`, as the reference's mesh training
    runs that body under ``shard_map``.  x: [B, S, d], this rank's rows,
    replicated over ``model``; ``tp`` the step's
    ``collectives.ModelParallel``.

    Where the placement splits ``experts`` over ``model``
    (``tp.split``), a rank holds its ``E / M`` experts and its ``E / M``
    columns of the router: x enters through ``copy_to_model``; the
    router is made whole by ``gather_from_slice`` (its gradient summed
    over ``model``, then cut back to the rank's columns);
    :func:`_moe_local` runs the rank's experts over all of its tokens,
    the capacity over them all (no groups of :data:`GROUP_TOKENS`, as the
    reference's body); ``reduce_from_model`` sums the ranks' routed
    partial outputs.  Where ``model`` does not divide the experts,
    :func:`moe_apply` runs whole on every rank, as the reference falls
    back.  The shared experts go through ``layers.mlp`` under their own
    entry, ``shared``: split, or whole.  At ``M = 1`` the one rank holds
    every expert, and the shard body is :func:`moe_apply` over one group
    of all its tokens (``one_group``): the reference's capacity over the
    rank's rows, and one process's step bit for bit where the rank's
    rows are one of its groups (one row of at most
    :data:`GROUP_TOKENS`).

    The aux loss (``return_aux``) is the replicated router pass's
    (:func:`_router_aux`), alike on every rank.  Its gradient is each
    rank's whole, so it must not be summed over ``model``: it reads x
    itself, not the copy, and a router whose other ranks' columns are
    the gathered values without gradient, so a rank's router gradient
    from it is its own columns'.  It counts once."""
    if tp.size == 1:
        return moe_apply(_full_experts(params, cfg), x, cfg,
                         return_aux=return_aux, one_group=True)
    routed = {k: v for k, v in params.items() if k != "shared"}
    if not tp.split["experts"]:
        out, aux = moe_apply(_full_experts(routed, cfg), x, cfg,
                             return_aux=True)
    else:
        e_local = cfg.num_experts // tp.size
        if routed["w_gate"].shape[0] != e_local:
            raise ValueError(f"{routed['w_gate'].shape[0]} experts held, "
                             f"not {cfg.num_experts} / {tp.size}")
        mine = routed["router"]
        router = gather_from_slice(mine, tp)
        valid = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        out = reduce_from_model(_moe_local(
            router, routed["w_gate"], routed["w_up"], routed["w_down"],
            copy_to_model(x, tp), valid, cfg=cfg, e_local=e_local,
            shard=tp.index), tp)
        aux = None
        if return_aux:
            lo, n = tp.index * mine.shape[-1], mine.shape[-1]
            aux = _router_aux(torch.cat([router[..., :lo].detach(), mine,
                                         router[..., lo + n:].detach()],
                                        -1), x, cfg)
    if "shared" in params:
        out = out + mlp(params["shared"], x, "swiglu", tp, owner="shared")
    return (out, aux) if return_aux else out


def _moe_local_serve(router, w_gate, w_up, w_down, x, valid, *, cfg,
                     e_local, mesh):
    """Decode-path shard body: the expert weights stay resident, 2D-sharded
    (experts over ``model``, ``moe_ff`` over the data axes: each rank runs
    its experts' ``moe_ff / D`` slice over every decode token), and one
    sum over ``("model",) + data`` adds the experts' contributions and the
    ``moe_ff`` partials.  The reference gathers the data-split batch
    first; here every rank already holds all of it."""
    m_loc = cfg.moe_d_ff // mesh.shape["data"]
    f0 = mesh.data_index * m_loc
    out = _moe_local(router, w_gate.narrow(2, f0, m_loc),
                     w_up.narrow(2, f0, m_loc), w_down.narrow(1, f0, m_loc),
                     x, valid, cfg=cfg, e_local=e_local,
                     shard=mesh.model_index)
    return all_reduce(out, mesh, ("model", "data"))


def moe_apply_ep_serve(params: dict, x, cfg, valid=None):
    """Decode-time EP: resident weights over ``(model, data)`` (see
    :func:`_moe_local_serve`); :func:`moe_apply` without a mesh, or when
    the experts, ``moe_d_ff`` or the batch do not divide it.  ``valid``
    ([B, S] bool) masks inactive decode slots out of the capacity count so
    a free slot's stale token can't steal an expert slot."""
    mesh = current_mesh()
    if not ep_applies(cfg, mesh, x.shape[0]):
        return moe_apply(_full_experts(params, cfg), x, cfg, valid=valid)
    e_local = cfg.num_experts // mesh.shape["model"]
    if valid is None:
        valid = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    out = _moe_local_serve(params["router"],
                           *_own_experts(params, cfg, mesh), x, valid,
                           cfg=cfg, e_local=e_local, mesh=mesh)
    if "shared" in params:
        out = out + mlp(params["shared"], x, "swiglu")
    return out
