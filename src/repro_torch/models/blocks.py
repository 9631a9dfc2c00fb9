"""Per-layer blocks: init / apply / cache, dispatched on block *kind*.

Kinds served so far (``ArchConfig.block_pattern`` entries):
  ``full``    causal full attention + FFN
  ``swa``     sliding-window attention (window = cfg.window)
  ``local``   same as swa (gemma3 local layers)
  ``global``  full attention with the long-context rope theta (gemma3)
  ``rglru``   RG-LRU recurrent block + FFN (recurrentgemma)
  ``rwkv6``   RWKV-6 time mix + channel mix (attention-free, rwkv6-7b)
The ``+moe`` FFN is not ported yet and raises ``NotImplementedError``.

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
the bucketed prefill) run on every kind too.
"""

from __future__ import annotations

import torch

from . import layers
from . import rglru as rglru_lib
from . import rwkv6 as rwkv6_lib
from .layers import apply_norm, norm_init, project, rope

ATTN_KINDS = ("full", "swa", "local", "global", "bidir")
RECURRENT_KINDS = ("rwkv6", "rglru")
# kinds the chunked/packed prefill serves (recurrent ones via scan state)
CHUNKABLE_KINDS = ATTN_KINDS + RECURRENT_KINDS


def split_kind(kind: str) -> tuple[str, bool]:
    if kind.endswith("+moe"):
        return kind[:-4], True
    return kind, False


def _check_ported(kind: str) -> str:
    base, is_moe = split_kind(kind)
    if is_moe:
        raise NotImplementedError(
            f"block kind {kind!r}: MoE is ROADMAP Queue 1 item 7 (not "
            "ported yet)")
    if base not in CHUNKABLE_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    return base


def block_init(cfg, kind: str, dtype, device, generator,
               lead: tuple[int, ...] = ()) -> dict:
    """Parameters of one block; ``lead`` prepends stacking dims (the
    group-stacked layers carry a leading layer axis)."""
    base = _check_ported(kind)

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
    if cfg.mlp in ("swiglu", "geglu"):
        params["mlp"] = {"w_gate": dense((d, cfg.d_ff)),
                         "w_up": dense((d, cfg.d_ff)),
                         "w_down": dense((cfg.d_ff, d))}
    else:
        params["mlp"] = {"w_up": dense((d, cfg.d_ff)),
                         "w_down": dense((cfg.d_ff, d))}
    return params


# ---------------------------------------------------------------------------
# dense caches: per-slot rings and recurrent state
# ---------------------------------------------------------------------------


def cache_len_for(cfg, kind: str, seq_len: int) -> int:
    """Ring length of one layer's dense cache: windowed kinds keep only
    ``cfg.window`` entries.  (The reference's ``margin`` for speculative
    drafts is not ported: speculation is not.)"""
    base, _ = split_kind(kind)
    if base in ("swa", "local"):
        return min(cfg.window, seq_len)
    return seq_len


def block_cache_init(cfg, kind: str, batch: int, seq_len: int, device,
                     lead: tuple[int, ...] = ()) -> dict:
    """One layer's dense cache with ``lead`` stacking dims: ``{k, v:
    [B, n, Kv, D], pos: [B, n] int32 (-1 = unwritten)}`` for attention
    kinds, ``{h: [B, dr], conv: [B, W-1, dr]}`` (f32) for rglru, ``{S:
    [B, H, 64, 64] f32, tm_last, cm_last: [B, d]}`` for rwkv6."""
    base = _check_ported(kind)
    if base in RECURRENT_KINDS:
        lib = rglru_lib if base == "rglru" else rwkv6_lib
        return {k: v.expand(lead + v.shape).contiguous() for k, v in
                lib.init_state(cfg, batch, device).items()}
    n = cache_len_for(cfg, kind, seq_len)
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
    place, at the plan's (row, col) pairs (distinct by construction)."""
    lanes, rows, cols = plan
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
    the scatter never collides."""
    lanes, phys, off = plan
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


def _ffn(cfg, params, x):
    h2 = apply_norm(cfg.norm, params["ln2"], x)
    return x + layers.mlp(params["mlp"], h2, cfg.mlp)


# ---------------------------------------------------------------------------
# apply: full sequence (training, one-shot prefill)
# ---------------------------------------------------------------------------


def block_apply_seq(cfg, kind: str, params: dict, x, positions, cache=None):
    """x: [B,S,d]; positions: [S] absolute (``arange(S)``).  With ``cache``
    (the one-shot prefill) this layer's cache is written in place: the
    computed K/V into its dense ring (:func:`_write_cache`), or the
    recurrent state after the last position into its state leaves.
    Without (training) the recurrent kinds start from zero state.  The
    recurrent kinds run their one-shot forms (``rglru_block``,
    ``time_mix_chunked``).  Returns ``(x, aux)`` with ``aux`` the f32
    load-balancing loss (0 for a dense FFN)."""
    base = _check_ported(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if base in RECURRENT_KINDS:
        lib = rglru_lib if base == "rglru" else rwkv6_lib
        st = (cache if cache is not None
              else lib.init_state(cfg, x.shape[0], x.device))
        h = apply_norm(cfg.norm, params["ln1"], x)
        if base == "rglru":
            y, new = rglru_lib.rglru_block(params["rglru"], h, st)
            x = _ffn(cfg, params, x + y)
        else:
            p = params["tm_cm"]
            y, s_new, tm_last = rwkv6_lib.time_mix_chunked(p, h, st["S"],
                                                           st["tm_last"])
            x = x + y
            h2 = apply_norm(cfg.norm, params["ln2"], x)
            cm_out, cm_last = rwkv6_lib.channel_mix(p, h2, st["cm_last"])
            x = x + cm_out
            new = {"S": s_new, "tm_last": tm_last, "cm_last": cm_last}
        if cache is not None:
            _store_state(cache, new)
        return x, aux
    q, k, v = _attn_qkv(cfg, base, params, x, positions)
    o = layers.attention(q, k, v, q_pos=positions, k_pos=positions,
                         causal=base != "bidir", window=_window(cfg, base))
    x = x + layers.attn_output(params["attn"], o)
    if cache is not None:
        _write_cache(cache, k, v, positions)
    return _ffn(cfg, params, x), aux


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
        return _ffn(cfg, params, x + y)
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
    return _ffn(cfg, params, x)


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
        from repro_torch.kernels.segment_attention import \
            paged_segment_attention_op
        _paged_scatter(cache, k[0], v[0], plan)
        o = paged_segment_attention_op(q[0], cache["k"], cache["v"],
                                       block_tables, pos, slot_id,
                                       window=window)[None]
    else:
        b, n, kvh, hd = cache["k"].shape
        kpos_cache = torch.where(cache["pos"] < start[:, None], cache["pos"],
                                 -1)
        k_eff = torch.cat([cache["k"].reshape(b * n, kvh, hd),
                           k[0].to(cache["k"].dtype)])
        v_eff = torch.cat([cache["v"].reshape(b * n, kvh, hd),
                           v[0].to(cache["v"].dtype)])
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
    return _ffn(cfg, params, x)


def _packed_recurrent(cfg, kind, params, x, pos, slot_id, start, seg_len,
                      cache):
    """The recurrent branch of :func:`block_apply_packed`.  Dead lanes are
    scattered into a spare row past the slots that nothing reads."""
    nslots, p_len = start.shape[0], x.shape[1]
    live = slot_id >= 0
    safe = slot_id.clamp(0, nslots - 1).long()
    off = (pos - start[safe]).clamp(0, p_len - 1).long()
    xs = x.new_zeros((nslots + 1, p_len, x.shape[2]))
    xs[torch.where(live, slot_id, nslots).long(), off] = x[0]
    t = torch.arange(p_len, dtype=torch.int32, device=x.device)[None, :]
    y = block_apply_chunk(cfg, kind, params, xs[:nslots], start[:, None] + t,
                          t < seg_len[:, None], cache)
    return torch.where(live[None, :, None], y[safe, off][None], x)


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
        return _ffn(cfg, params, x + y[:, None, :])
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
        from repro_torch.kernels.paged_attention import \
            paged_decode_attention_op
        _paged_scatter(cache, k[:, 0], v[:, 0], plan)
        o = paged_decode_attention_op(q[:, 0], cache["k"], cache["v"],
                                      block_tables, pos,
                                      window=window)[:, None]
    else:
        _dense_write(cache, k[:, 0], v[:, 0], pos, plan[cache["k"].shape[1]])
        o = layers.decode_attention(q, cache["k"], cache["v"],
                                    k_pos=cache["pos"], q_pos=pos,
                                    window=window)
    x = x + layers.attn_output(params["attn"], o)
    return _ffn(cfg, params, x)
