"""Per-layer blocks: init / apply / cache, dispatched on block *kind*.

Kinds served so far (``ArchConfig.block_pattern`` entries):
  ``full``    causal full attention + FFN
  ``swa``     sliding-window attention (window = cfg.window)
  ``local``   same as swa (gemma3 local layers)
  ``global``  full attention with the long-context rope theta (gemma3)
  ``rglru``   RG-LRU recurrent block + FFN (recurrentgemma)
  ``rwkv6``   RWKV-6 time mix + channel mix (attention-free, rwkv6-7b)
A ``+moe`` suffix swaps the dense FFN for the MoE layer (``full+moe``:
deepseek-moe-16b, llama4-maverick-400b-a17b), which routes with each
path's mask of real tokens, as the reference passes it.

Attention K/V lives either in the paged block store ``[N, Kv, T, D]``
shared by all sequences through block tables, or in dense per-slot rings
``{k, v: [B, n, Kv, D], pos: [B, n]}`` (windowed kinds keep ``n =
window``).  Recurrent kinds keep per-slot scan state: ``{h, conv}`` for
rglru, ``{S, tm_last, cm_last}`` for rwkv6.  Apply
functions update caches and state **in place** (the reference donates and
returns them) and return the new activations.  Writes that the reference
drops (``mode="drop"``) are left out of a write plan the caller computes
once per step, so the device never selects lanes itself.

Whole sequences (:func:`block_apply_seq`) run on every kind: without a
cache in training, writing a dense ring or the recurrent state in the
one-shot prefill.  Padded per-slot prompt chunks (:func:`block_apply_chunk`,
the bucketed prefill) run on every kind too, and so do packed streams whose
decode segments carry speculative drafts (:func:`block_apply_spec`).

Under a serving mesh (``distributed.sharding.use_mesh``) the packed and
decode paths' attention goes through the head-parallel wrappers of
``distributed.collectives``, the caches hold this rank's chunk of the KV
heads (and only that chunk of each new K/V is written), and the MoE
layer goes through its expert-parallel entry points, as the reference
routes them.

A tensor-parallel training step passes its
``collectives.ModelParallel`` as ``tp`` to :func:`block_apply_seq`
(never through ``use_mesh``): the attention kinds then run the forms of
:func:`seq_attention` on this rank's heads and the dense FFN its
column- and row-parallel form (``layers.mlp``), each summed over
``model``; the recurrent kinds run their forms on this rank's channels
(``rglru.rglru_block``, ``rwkv6.time_mix_chunked`` and
``rwkv6.channel_mix`` with ``tp``), the leaves they use only in part
named by :func:`tp_partial`; the MoE layer runs expert-parallel on this
rank's experts (``moe.moe_apply_tp``).  Each form reads its own entry of
``tp.split``: a block whose dim ``model`` does not divide runs whole.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.collectives import (copy_to_model, own_heads,
                                                 reduce_from_model,
                                                 tp_paged_decode_attention,
                                                 tp_paged_segment_attention)

from . import layers
from . import moe as moe_lib
from . import rglru as rglru_lib
from . import rwkv6 as rwkv6_lib
from .layers import apply_norm, attn_output, norm_init, project, rope

ATTN_KINDS = ("full", "swa", "local", "global", "bidir")
RECURRENT_KINDS = ("rwkv6", "rglru")
# kinds the chunked/packed prefill serves (recurrent ones via scan state)
CHUNKABLE_KINDS = ATTN_KINDS + RECURRENT_KINDS


def split_kind(kind: str) -> tuple[str, bool]:
    if kind.endswith("+moe"):
        return kind[:-4], True
    return kind, False


def _check_ported(kind: str) -> str:
    base, _ = split_kind(kind)
    if base not in CHUNKABLE_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    return base


def block_init(cfg, kind: str, dtype, device, generator,
               lead: tuple[int, ...] = ()) -> dict:
    """Parameters of one block; ``lead`` prepends stacking dims (the
    group-stacked layers carry a leading layer axis)."""
    base = _check_ported(kind)
    is_moe = split_kind(kind)[1]

    def dense(shape):
        return layers.dense_init(lead + shape, dtype, device, generator)

    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads

    def norm():
        return {k: v.expand(lead + v.shape).clone()
                for k, v in norm_init(cfg.norm, d, dtype, device).items()}

    if base == "rwkv6":       # its own channel mix takes the FFN's place
        return {"ln1": norm(),
                "tm_cm": rwkv6_lib.rwkv6_init(cfg, dtype, device, generator,
                                              lead),
                "ln2": norm()}
    params = {"ln1": norm()}
    if base == "rglru":
        params["rglru"] = rglru_lib.rglru_init(cfg, dtype, device, generator,
                                               lead)
    else:
        params["attn"] = {"wq": dense((d, h, hd)), "wk": dense((d, kv, hd)),
                          "wv": dense((d, kv, hd)), "wo": dense((h, hd, d))}
    params["ln2"] = norm()
    if is_moe:
        params["moe"] = moe_lib.moe_init(cfg, dtype, device, generator, lead)
    elif cfg.mlp in ("swiglu", "geglu"):
        params["mlp"] = {"w_gate": dense((d, cfg.d_ff)),
                         "w_up": dense((d, cfg.d_ff)),
                         "w_down": dense((cfg.d_ff, d))}
    else:
        params["mlp"] = {"w_up": dense((d, cfg.d_ff)),
                         "w_down": dense((cfg.d_ff, d))}
    return params


def tp_partial(split: dict) -> tuple[str, ...]:
    """Key suffixes (``bridge.keyed_leaves``') of the recurrent blocks'
    leaves a tensor-parallel rank uses only in part under a placement
    that splits ``split`` (``sharding.model_split``'s): ``rglru.TP_PARTIAL``
    when the RG-LRU's ``ff`` dim is split, ``rwkv6.tp_partial`` when the
    RWKV-6 block's is.  The MoE layer has none: its router is split with
    the experts and made whole by a gather, and a block left whole runs
    replicated."""
    rg = rglru_lib.TP_PARTIAL if split.get("rglru") else ()
    return (tuple(f"['rglru'][{n!r}]" for n in rg)
            + tuple(f"['tm_cm'][{n!r}]" for n in rwkv6_lib.tp_partial(split)))


def block_axes(cfg, kind: str) -> dict:
    """The logical dim names of :func:`block_init`'s leaves (without a
    stacking dim)."""
    base = _check_ported(kind)
    norm = layers.norm_axes(cfg.norm)
    if base == "rwkv6":
        return {"ln1": norm, "tm_cm": rwkv6_lib.rwkv6_axes(), "ln2": norm}
    axes = {"ln1": norm, "ln2": norm}
    if base == "rglru":
        axes["rglru"] = rglru_lib.rglru_axes()
    else:
        axes["attn"] = layers.attention_axes()
    if split_kind(kind)[1]:
        axes["moe"] = moe_lib.moe_axes(cfg)
    else:
        axes["mlp"] = layers.mlp_axes(cfg.mlp)
    return axes


# ---------------------------------------------------------------------------
# dense caches: per-slot rings and recurrent state
# ---------------------------------------------------------------------------


def cache_len_for(cfg, kind: str, seq_len: int, margin: int = 0) -> int:
    """Ring length of one layer's dense cache: windowed kinds keep only
    ``cfg.window + margin`` entries.  ``margin`` widens windowed rings for
    speculative decode, which writes up to ``k`` draft positions past the
    pending token: a ring must hold ``window + k`` entries, or a rejected
    draft would overwrite a key the next tick still attends to."""
    base, _ = split_kind(kind)
    if base in ("swa", "local"):
        return min(cfg.window + margin, seq_len)
    return seq_len


def block_cache_init(cfg, kind: str, batch: int, seq_len: int, device,
                     lead: tuple[int, ...] = (),
                     ring_margin: int = 0) -> dict:
    """One layer's dense cache with ``lead`` stacking dims: ``{k, v:
    [B, n, Kv, D], pos: [B, n] int32 (-1 = unwritten)}`` for attention
    kinds (``n`` from :func:`cache_len_for` with ``ring_margin``), ``{h:
    [B, dr], conv: [B, W-1, dr]}`` (f32) for rglru, ``{S: [B, H, 64, 64]
    f32, tm_last, cm_last: [B, d]}`` for rwkv6."""
    base = _check_ported(kind)
    if base in RECURRENT_KINDS:
        lib = rglru_lib if base == "rglru" else rwkv6_lib
        return {k: v.expand(lead + v.shape).contiguous() for k, v in
                lib.init_state(cfg, batch, device).items()}
    n = cache_len_for(cfg, kind, seq_len, margin=ring_margin)
    shape = lead + (batch, n, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = layers.torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.full(lead + (batch, n), -1, dtype=torch.int32,
                              device=device)}


def dense_packed_plan(slot_id, pos, start, seg_len, ring: int):
    """Where a packed stream's K/V lands in rings of ``ring`` entries:
    ``(lanes, rows, cols)``.  Each segment keeps only its last
    ``min(seg_len, ring)`` positions, so a ring entry is written at most
    once per call; dead lanes are left out (the reference's drop-mode
    write-back)."""
    b = start.shape[0]
    seg = slot_id.long()
    last = (start + seg_len - 1).long()
    keep = (seg >= 0) & (pos.long() > last[seg.clamp(0, b - 1)] - ring)
    lanes = torch.nonzero(keep).squeeze(1)
    return lanes, seg[lanes], pos[lanes].long() % ring


def dense_step_plan(pos, active, ring: int):
    """Where each decoding row's K/V lands in rings of ``ring`` entries:
    ``(lanes, rows, cols)``; rows outside ``active`` are left out."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    if active is not None:
        rows = rows[active]
    return rows, rows, pos[rows].long() % ring


def _dense_write(cache: dict, k, v, pos, plan) -> None:
    """Write per-lane K/V ([L, Kv, D]) and positions into the rings in
    place, at the plan's (row, col) pairs (distinct by construction).
    Under a serving mesh the rings hold this rank's KV head chunk, and
    only that chunk of k and v is written."""
    lanes, rows, cols = plan
    k, v = (own_heads(t, cache["k"].shape[2]) for t in (k, v))
    cache["k"][rows, cols] = k[lanes].to(cache["k"].dtype)
    cache["v"][rows, cols] = v[lanes].to(cache["v"].dtype)
    cache["pos"][rows, cols] = pos[lanes].to(torch.int32)


# ---------------------------------------------------------------------------
# paged caches
# ---------------------------------------------------------------------------


def paged_cache_init(cfg, kind: str, num_blocks: int, block_tokens: int,
                     device, lead: tuple[int, ...] = ()) -> dict:
    """Physical block store for one attention layer: ``[N, Kv, T, D]``
    (the paged-attention kernels' layout), with ``lead`` stacking dims.
    There is no ``pos`` plane — positions are implied by block-table
    order — and no per-slot batch axis."""
    base, _ = split_kind(kind)
    if base not in ATTN_KINDS:
        raise ValueError(f"paged KV requires attention blocks, got {kind!r}")
    shape = lead + (num_blocks, cfg.num_kv_heads, block_tokens,
                    cfg.resolved_head_dim)
    dt = layers.torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def paged_write_plan(seg, pos, block_tables, block_tokens: int, valid=None):
    """Where each lane's K/V lands in the block store.

    seg, pos: [L] — the slot (table row) each lane belongs to (-1 = dead)
    and its logical position; ``valid`` ([L] bool, optional) drops further
    lanes.  Returns ``(lanes, phys, off)``: the lanes that are written, and
    their physical block and in-block offset.  A lane is dropped when it is
    dead, invalid, or its table entry is -1 — the reference's drop-mode
    scatter.  Computed once per step and shared by every layer; on a CUDA
    tensor the selection synchronises, so the engine builds the plan on the
    host (it knows the live lanes) and uploads it."""
    b, m = block_tables.shape
    seg = seg.long()
    pos = pos.long()
    blk = (pos // block_tokens).clamp(0, m - 1)
    entry = block_tables[seg.clamp(0, b - 1), blk]
    ok = (seg >= 0) & (entry >= 0)
    if valid is not None:
        ok &= valid
    lanes = torch.nonzero(ok).squeeze(1)
    return lanes, entry[lanes].long(), pos[lanes] % block_tokens


def _paged_scatter(cache: dict, k, v, plan) -> None:
    """Write per-lane K/V ([L, Kv, D]) into the block store in place.
    Distinct logical positions map to distinct (block, offset) pairs, so
    the scatter never collides.  Under a serving mesh the store holds this
    rank's KV head chunk, and only that chunk of k and v is written."""
    lanes, phys, off = plan
    k, v = (own_heads(t, cache["k"].shape[1]) for t in (k, v))
    cache["k"][phys, :, off] = k[lanes].to(cache["k"].dtype)
    cache["v"][phys, :, off] = v[lanes].to(cache["v"].dtype)


def paged_copy_blocks(cache: dict, src, dst, block_axis: int = 0) -> None:
    """Copy whole physical blocks ``src[i] -> dst[i]`` in place — the device
    side of ``KVLease.writable`` copy-on-write.  The gather happens before
    the scatter, so a source is read at its pre-copy value; duplicate pairs
    carry identical bytes."""
    for a in (cache["k"], cache["v"]):
        a.index_copy_(block_axis, dst, a.index_select(block_axis, src))


def _theta(cfg, base: str) -> float:
    if base == "global" and cfg.rope_theta_global:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _window(cfg, base: str) -> int:
    return cfg.window if base in ("swa", "local") else 0


def _attn_qkv(cfg, base, params, x, pos):
    """ln1, then the rope'd q, k and plain v: [B, S, heads, D] each."""
    theta = _theta(cfg, base)
    h = apply_norm(cfg.norm, params["ln1"], x)
    q = rope(project(h, params["attn"]["wq"]), pos, theta)
    k = rope(project(h, params["attn"]["wk"]), pos, theta)
    v = project(h, params["attn"]["wv"])
    return q, k, v


def seq_attention(cfg, attn: dict, h, kv_in, *, positions, theta, causal,
                  window, tp=None, cache=None):
    """One full-sequence attention's output projection (before the
    residual): q from ``h``, k and v from ``kv_in`` (``h`` itself for
    self-attention, the encoder's output for cross-attention), rope'd at
    ``positions`` unless ``theta`` is None.  With ``cache`` (the one-shot
    prefill, one device) k and v are written into its dense ring
    (:func:`_write_cache`).  Under a tensor-parallel step (``tp``, no
    cache) the form follows ``tp.split``, the step's placement:

    * heads split: ``h`` (and ``kv_in``) enter through ``copy_to_model``;
      q on this rank's ``H/M`` heads (``wq`` its slice); k and v on its
      ``Kv/M`` (``wk``/``wv`` split too), or, with the KV heads
      replicated, on the span of KV heads its query chunk reads
      (``tp.kv_span``: ``wk``/``wv`` narrowed to it, their gradients a
      part of the whole); ``layers.attention`` on those heads, the local
      ``wo``, ``reduce_from_model``;
    * heads replicated (``model`` does not divide them): the whole
      attention on every rank, as one device runs it, no collective,
      complete gradients."""
    a = attn
    split = tp is not None and tp.split["heads"]
    if not split:
        if tp is not None and tp.split["kv_heads"]:
            raise ValueError("KV heads split over model with the query "
                             "heads replicated")
    else:
        if a["wq"].shape[-2] * tp.size != cfg.num_heads:
            raise ValueError(f"wq holds {a['wq'].shape[-2]} heads, not "
                             f"{cfg.num_heads} / {tp.size}")
        h_in = h
        h = copy_to_model(h, tp)
        kv_in = h if kv_in is h_in else copy_to_model(kv_in, tp)
        if not tp.split["kv_heads"]:
            lo, n = tp.kv_span(cfg.num_heads, cfg.num_kv_heads)
            a = dict(a, wk=a["wk"].narrow(-2, lo, n),
                     wv=a["wv"].narrow(-2, lo, n))
    q = project(h, a["wq"])
    k = project(kv_in, a["wk"])
    v = project(kv_in, a["wv"])
    if theta is not None:
        q, k = rope(q, positions, theta), rope(k, positions, theta)
    if cache is not None:
        _write_cache(cache, k, v, positions)
    o = layers.attention(q, k, v, q_pos=positions, k_pos=positions,
                         causal=causal, window=window)
    out = attn_output(a, o)
    return reduce_from_model(out, tp) if split else out


def _ffn(cfg, params, x, valid=None, aux=False, step=False, tp=None):
    """ln2, then the dense FFN or the MoE layer, and the residual.  The
    MoE layer routes with ``valid`` ([B, S] bool: real tokens, or None for
    all), through the reference's expert-parallel entry points, which run
    ``moe_apply`` without a serving mesh: ``moe_apply_ep_serve`` on the
    decode ``step``, ``moe_apply_ep`` elsewhere.  With ``aux`` returns
    ``(x, its load-balancing loss)``, the loss 0 for a dense FFN.  Under
    ``tp`` (a mesh training step) the dense FFN takes its column- and
    row-parallel form where ``tp.split`` says so, and the MoE layer its
    expert-parallel one (``moe.moe_apply_tp``), at ``M = 1`` too."""
    h2 = apply_norm(cfg.norm, params["ln2"], x)
    if "moe" in params:
        if tp is not None:
            y = moe_lib.moe_apply_tp(params["moe"], h2, cfg, tp,
                                     return_aux=aux)
        elif step:
            return x + moe_lib.moe_apply_ep_serve(params["moe"], h2, cfg,
                                                  valid=valid)
        else:
            y = moe_lib.moe_apply_ep(params["moe"], h2, cfg,
                                     return_aux=aux, valid=valid)
        if aux:
            return x + y[0], y[1]
        return x + y
    x = x + layers.mlp(params["mlp"], h2, cfg.mlp, tp)
    if aux:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return x


# ---------------------------------------------------------------------------
# apply: full sequence (training, one-shot prefill)
# ---------------------------------------------------------------------------


def block_apply_seq(cfg, kind: str, params: dict, x, positions, cache=None,
                    tp=None):
    """x: [B,S,d]; positions: [S] absolute (``arange(S)``).  With ``cache``
    (the one-shot prefill) this layer's cache is written in place: the
    computed K/V into its dense ring (:func:`_write_cache`), or the
    recurrent state after the last position into its state leaves.
    Without (training) the recurrent kinds start from zero state.  The
    recurrent kinds run their one-shot forms (``rglru_block``,
    ``time_mix_chunked``).  ``tp``: a tensor-parallel training step's
    ``ModelParallel`` (no cache).  Returns ``(x,
    aux)`` with ``aux`` the f32 load-balancing loss (0 for a dense
    FFN)."""
    base = _check_ported(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if tp is not None and cache is not None:
        raise ValueError(f"{kind}: no tensor-parallel form with a cache")
    if base in RECURRENT_KINDS:
        lib = rglru_lib if base == "rglru" else rwkv6_lib
        st = (cache if cache is not None
              else lib.init_state(cfg, x.shape[0], x.device, tp))
        h = apply_norm(cfg.norm, params["ln1"], x)
        if base == "rglru":
            y, new = rglru_lib.rglru_block(params["rglru"], h, st, tp)
            x, aux = _ffn(cfg, params, x + y, aux=True, tp=tp)
        else:
            p = params["tm_cm"]
            y, s_new, tm_last = rwkv6_lib.time_mix_chunked(
                p, h, st["S"], st["tm_last"], tp)
            x = x + y
            h2 = apply_norm(cfg.norm, params["ln2"], x)
            cm_out, cm_last = rwkv6_lib.channel_mix(p, h2, st["cm_last"],
                                                    tp)
            x = x + cm_out
            new = {"S": s_new, "tm_last": tm_last, "cm_last": cm_last}
        if cache is not None:
            _store_state(cache, new)
        return x, aux
    h = apply_norm(cfg.norm, params["ln1"], x)
    x = x + seq_attention(cfg, params["attn"], h, h, positions=positions,
                          theta=_theta(cfg, base), causal=base != "bidir",
                          window=_window(cfg, base), tp=tp, cache=cache)
    return _ffn(cfg, params, x, aux=True, tp=tp)


def _write_cache(cache: dict, k, v, positions) -> None:
    """Write a whole sequence's K/V ([B,S,Kv,D]) into a ring of ``n``
    entries in place: with ``S >= n`` the last ``n`` positions, each at
    its ring slot ``p % n`` (the reference's ``argsort(slots)`` order),
    else positions ``[0, S)`` at the front."""
    n = cache["k"].shape[1]
    b, s = k.shape[:2]
    if s >= n:
        tail = positions[-n:]
        slots = (tail % n).long()
        cache["k"][:, slots] = k[:, -n:].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, -n:].to(cache["v"].dtype)
        cache["pos"][:, slots] = tail.to(torch.int32).expand(b, n)
        return
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    cache["pos"][:, :s] = positions.to(torch.int32).expand(b, s)


# ---------------------------------------------------------------------------
# apply: padded per-slot chunk (bucketed prefill)
# ---------------------------------------------------------------------------


def block_apply_chunk(cfg, kind: str, params: dict, x, pos, valid, cache,
                      block_tables=None, plan=None):
    """x: [B,C,d] chunk, rows left-aligned; pos: [B,C] positions; valid:
    [B,C] bool marks real tokens (False = pad or inactive row); cache:
    this layer's dense ring, paged block store or per-slot scan state,
    updated in place.

    * Attention, paged (``block_tables`` [B,M] given; ``plan`` is the
      chunk's :func:`paged_write_plan` over its flattened ``[B*C]`` lanes,
      see ``transformer.chunk_plan``): write-then-gather — the chunk's K/V
      go into the store first, then queries attend to each row's logical
      view (``paged_gather``), exact because rows prefill front to back.
    * Attention, dense (``plan`` maps each ring length to the chunk's
      :func:`dense_packed_plan`, each row one segment): queries attend to
      the ring followed by the chunk's own keys under one softmax; ring
      entries at or after a row's chunk start are stale (an earlier
      occupant) and masked.  Then each row's last ``min(len, ring)``
      valid K/V are written back.
    * Recurrent: a row whose chunk starts at position 0 begins a prompt in
      a (possibly reused) slot, so its state restarts from zero (recurrent
      state has no positions to mask by); pads leave the state alone.

    The attention over the chunk is plain torch (``layers.chunk_attention``),
    as the reference computes it in XLA."""
    base = _check_ported(kind)
    if base in ATTN_KINDS:
        return _chunk_attention_block(cfg, base, params, x, pos, valid,
                                      cache, block_tables, plan)
    fresh = (pos[:, 0] == 0) & valid[:, 0]                       # [B]
    state = {n: torch.where(fresh.view((-1,) + (1,) * (a.dim() - 1)),
                            torch.zeros_like(a), a)
             for n, a in cache.items()}
    h = apply_norm(cfg.norm, params["ln1"], x)
    if base == "rglru":
        y, new = rglru_lib.rglru_chunk(params["rglru"], h, state, valid)
        _store_state(cache, new)
        return _ffn(cfg, params, x + y, valid)
    p = params["tm_cm"]
    y, s_new, tm_last = rwkv6_lib.time_mix_chunk(p, h, state["S"],
                                                 state["tm_last"], valid)
    x = x + y
    h2 = apply_norm(cfg.norm, params["ln2"], x)
    cm_out, cm_last = rwkv6_lib.channel_mix_chunk(p, h2, state["cm_last"],
                                                  valid)
    _store_state(cache, {"S": s_new, "tm_last": tm_last, "cm_last": cm_last})
    return x + cm_out


def _chunk_attention_block(cfg, base, params, x, pos, valid, cache,
                           block_tables, plan):
    """The attention branches of :func:`block_apply_chunk`."""
    q, k, v = _attn_qkv(cfg, base, params, x, pos)
    window = _window(cfg, base)
    b, c, kvh, hd = k.shape
    k_lanes, v_lanes = k.reshape(b * c, kvh, hd), v.reshape(b * c, kvh, hd)
    if block_tables is not None:
        from repro_torch.kernels.paged_attention import paged_gather
        _paged_scatter(cache, k_lanes, v_lanes, plan)
        k_eff, v_eff, kpos_eff = paged_gather(cache["k"], cache["v"],
                                              block_tables)
        o = layers.chunk_attention(q, k_eff.transpose(1, 2),
                                   v_eff.transpose(1, 2), k_pos=kpos_eff,
                                   q_pos=pos, window=window)
    else:
        kpos_cache = torch.where(cache["pos"] < pos[:, :1], cache["pos"], -1)
        k_eff = torch.cat([cache["k"], k.to(cache["k"].dtype)], dim=1)
        v_eff = torch.cat([cache["v"], v.to(cache["v"].dtype)], dim=1)
        kpos_eff = torch.cat([kpos_cache, torch.where(valid, pos, -1)], dim=1)
        o = layers.chunk_attention(q, k_eff, v_eff, k_pos=kpos_eff, q_pos=pos,
                                   window=window)
        _dense_write(cache, k_lanes, v_lanes, pos.reshape(-1),
                     plan[cache["k"].shape[1]])
    x = x + layers.attn_output(params["attn"], o)
    return _ffn(cfg, params, x, valid)


def _store_state(cache: dict, new: dict, active=None) -> None:
    """Write a recurrent layer's new state into its cache in place, cast to
    each leaf's dtype; with ``active`` ([B] bool) the other rows keep
    theirs."""
    for n, a in new.items():
        if active is not None:
            a = torch.where(active.view((-1,) + (1,) * (a.dim() - 1)),
                            a.to(cache[n].dtype), cache[n])
        cache[n].copy_(a)


# ---------------------------------------------------------------------------
# apply: token-packed ragged stream (prefill chunks + decode segments)
# ---------------------------------------------------------------------------


def block_apply_packed(cfg, kind: str, params: dict, x, pos, slot_id, start,
                       seg_len, cache, block_tables=None, plan=None):
    """One block over a token-packed ragged stream.

    x: [1,P,d] — one flat stream of contiguous segments from up to B
    requests; pos: [P] int32 position of each token in its own request;
    slot_id: [P] int32 owning slot (-1 = dead pad); start / seg_len: [B]
    each slot's segment start and length this call.

    * Paged attention (``block_tables`` [B,M] given; ``plan`` is the
      stream's :func:`paged_write_plan`): write-then-attend — the stream's
      K/V go into the store first (every same-segment position <= q_pos is
      then live), and queries attend through the paged segment kernel.
    * Dense attention (``plan`` maps each ring length to the stream's
      :func:`dense_packed_plan`): queries attend through the flat segment
      kernel to every slot's ring, flattened to one key axis, followed by
      the stream's own keys; ring entries at or after a slot's segment
      start are stale (an earlier occupant) and masked.  Then each
      segment's last ``min(seg_len, ring)`` K/V are written to its ring.
    * Recurrent kinds: each segment is scattered to its slot's
      left-aligned row, the rows advance through :func:`block_apply_chunk`
      (B x P rows, as in the reference), and the outputs are gathered
      back to their stream positions.

    Segment masking means no token sees another request."""
    base = _check_ported(kind)
    if base in RECURRENT_KINDS:
        return _packed_recurrent(cfg, kind, params, x, pos, slot_id, start,
                                 seg_len, cache)
    q, k, v = _attn_qkv(cfg, base, params, x, pos[None, :])
    window = _window(cfg, base)
    if block_tables is not None:
        _paged_scatter(cache, k[0], v[0], plan)
        o = tp_paged_segment_attention(q[0], cache["k"], cache["v"],
                                       block_tables, pos, slot_id,
                                       window=window)[None]
    else:
        # under a serving mesh the rings hold this rank's KV head chunk;
        # the stream's own keys join them as that chunk too
        b, n, kvh, hd = cache["k"].shape
        kpos_cache = torch.where(cache["pos"] < start[:, None], cache["pos"],
                                 -1)
        k_eff = torch.cat([cache["k"].reshape(b * n, kvh, hd),
                           own_heads(k[0], kvh).to(cache["k"].dtype)])
        v_eff = torch.cat([cache["v"].reshape(b * n, kvh, hd),
                           own_heads(v[0], kvh).to(cache["v"].dtype)])
        kpos_eff = torch.cat([kpos_cache.reshape(b * n),
                              torch.where(slot_id >= 0, pos, -1)])
        kseg_eff = torch.cat([
            torch.arange(b, dtype=torch.int32,
                         device=x.device).repeat_interleave(n), slot_id])
        o = layers.segment_attention(q, k_eff[None], v_eff[None],
                                     q_pos=pos[None], k_pos=kpos_eff[None],
                                     q_seg=slot_id[None],
                                     k_seg=kseg_eff[None], window=window)
        _dense_write(cache, k[0], v[0], pos, plan[n])
    x = x + layers.attn_output(params["attn"], o)
    return _ffn(cfg, params, x, (slot_id >= 0)[None, :])


def _rows_layout(x, pos, slot_id, start, seg_len):
    """A packed stream scattered to the per-slot left-aligned row layout:
    ``(xs [B,P,d], row_pos [B,P], row_valid [B,P], gather)`` where
    ``gather(y)`` takes row outputs back to the stream (dead lanes keep
    ``x``).  Dead lanes are scattered into a spare row past the slots that
    nothing reads."""
    nslots, p_len = start.shape[0], x.shape[1]
    live = slot_id >= 0
    safe = slot_id.clamp(0, nslots - 1).long()
    off = (pos - start[safe]).clamp(0, p_len - 1).long()
    xs = x.new_zeros((nslots + 1, p_len, x.shape[2]))
    xs[torch.where(live, slot_id, nslots).long(), off] = x[0]
    t = torch.arange(p_len, dtype=torch.int32, device=x.device)[None, :]

    def gather(y):
        return torch.where(live[None, :, None], y[safe, off][None], x)

    return xs[:nslots], start[:, None] + t, t < seg_len[:, None], gather


def _packed_recurrent(cfg, kind, params, x, pos, slot_id, start, seg_len,
                      cache):
    """The recurrent branch of :func:`block_apply_packed`."""
    xs, row_pos, row_valid, gather = _rows_layout(x, pos, slot_id, start,
                                                  seg_len)
    return gather(block_apply_chunk(cfg, kind, params, xs, row_pos,
                                    row_valid, cache))


# ---------------------------------------------------------------------------
# apply: packed stream with speculative (length 1 + d) decode segments
# ---------------------------------------------------------------------------


def block_apply_spec(cfg, kind: str, params: dict, x, pos, slot_id, start,
                     seg_len, spec_rows, l_max: int, cache,
                     block_tables=None, plan=None):
    """:func:`block_apply_packed` for a stream whose decode segments carry
    speculative drafts (segments of ``1 + d`` lanes; ``spec_rows`` [B]
    bool marks them; ``l_max`` the longest segment a spec row may have).
    Returns ``(x, stack)``.

    Attention kinds need nothing new: the segment predicate (same segment
    and ``k_pos <= q_pos``) verifies every draft offset exactly, and a
    rejected suffix's K/V heals itself — stale ring entries are masked by
    position on the next tick, stale paged entries are overwritten before
    the next gather.  They delegate unchanged; ``stack`` is None.

    Recurrent kinds (rwkv6, rglru) change state at every token, so a
    rejected draft must be rolled back.  The layer's state is cloned
    before the tick; one full-chunk :func:`block_apply_chunk` advances the
    non-spec (prefill) rows in place with the spec rows masked out (their
    state stays the pre-tick state); then ``l_max`` width-1 column calls
    advance the spec rows on the clone, one offset each, and ``stack``
    keeps the state after every offset (leaves ``[l, B, ...]``).  Pads are
    neutral in the chunk scans, so width-1 calls compose exactly.  Once
    acceptance is known on the device the caller writes snapshot
    ``accept[b]`` into each spec row (``transformer._resolve_pending``):
    the reference returns the pending pair and selects from it instead."""
    base = _check_ported(kind)
    if base not in RECURRENT_KINDS:
        return block_apply_packed(cfg, kind, params, x, pos, slot_id, start,
                                  seg_len, cache, block_tables, plan), None
    xs, row_pos, row_valid, gather = _rows_layout(x, pos, slot_id, start,
                                                  seg_len)
    st = {n: a.clone() for n, a in cache.items()}      # the pre-tick state
    y_full = block_apply_chunk(cfg, kind, params, xs, row_pos,
                               row_valid & ~spec_rows[:, None], cache)
    l_eff = min(int(l_max), xs.shape[1])
    stack = {n: a.new_empty((l_eff,) + a.shape) for n, a in st.items()}
    cols = []
    for j in range(l_eff):
        col_valid = spec_rows[:, None] & row_valid[:, j:j + 1]
        cols.append(block_apply_chunk(cfg, kind, params, xs[:, j:j + 1],
                                      row_pos[:, j:j + 1], col_valid, st))
        for n, a in st.items():
            stack[n][j].copy_(a)
    y_spec = torch.zeros_like(y_full)
    y_spec[:, :l_eff] = torch.cat(cols, dim=1)
    y = torch.where(spec_rows[:, None, None], y_spec, y_full)
    return gather(y), stack


# ---------------------------------------------------------------------------
# apply: single decode step
# ---------------------------------------------------------------------------


def block_apply_step(cfg, kind: str, params: dict, x, pos, cache,
                     block_tables=None, plan=None, active=None):
    """x: [B,1,d]; pos: [B] int32 position of this token; cache: this
    layer's paged store, dense ring or recurrent state.  Paged (with
    ``block_tables``): ``plan`` is the rows' :func:`paged_write_plan` and
    attention runs through the paged decode kernel.  Dense: ``plan`` maps
    each ring length to the rows' :func:`dense_step_plan`, and attention
    runs through the dense decode kernel, which reads the ring in place
    (the reference computes it in XLA; its Pallas kernel was written for
    this step).  Either plan leaves out rows that are not decoding this
    tick; for the recurrent kinds, ``active`` ([B] bool) keeps those rows'
    state untouched."""
    base = _check_ported(kind)
    if base == "rglru":
        h = apply_norm(cfg.norm, params["ln1"], x)[:, 0]
        y, new = rglru_lib.rglru_step(params["rglru"], h, cache)
        _store_state(cache, new, active)
        return _ffn(cfg, params, x + y[:, None, :],
                    None if active is None else active[:, None], step=True)
    if base == "rwkv6":
        p = params["tm_cm"]
        h = apply_norm(cfg.norm, params["ln1"], x)[:, 0]
        y, s_new, tm_last = rwkv6_lib.time_mix_step(p, h, cache["S"],
                                                    cache["tm_last"])
        x = x + y[:, None, :]
        h2 = apply_norm(cfg.norm, params["ln2"], x)[:, 0]
        cm_out, cm_last = rwkv6_lib.channel_mix(p, h2, cache["cm_last"])
        _store_state(cache, {"S": s_new, "tm_last": tm_last,
                             "cm_last": cm_last}, active)
        return x + cm_out[:, None, :]
    q, k, v = _attn_qkv(cfg, base, params, x, pos[:, None])
    window = _window(cfg, base)
    if block_tables is not None:
        _paged_scatter(cache, k[:, 0], v[:, 0], plan)
        o = tp_paged_decode_attention(q[:, 0], cache["k"], cache["v"],
                                      block_tables, pos,
                                      window=window)[:, None]
    else:
        _dense_write(cache, k[:, 0], v[:, 0], pos, plan[cache["k"].shape[1]])
        o = layers.decode_attention(q, cache["k"], cache["v"],
                                    k_pos=cache["pos"], q_pos=pos,
                                    window=window)
    x = x + layers.attn_output(params["attn"], o)
    return _ffn(cfg, params, x, None if active is None else active[:, None],
                step=True)
