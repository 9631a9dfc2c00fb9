"""Per-layer blocks: init / apply / paged cache, dispatched on block *kind*.

Kinds served so far (``ArchConfig.block_pattern`` entries):
  ``full``    causal full attention + FFN
  ``swa``     sliding-window attention (window = cfg.window)
  ``local``   same as swa (gemma3 local layers)
  ``global``  full attention with the long-context rope theta (gemma3)
Recurrent kinds (``rwkv6``, ``rglru``) and the ``+moe`` FFN are not ported
yet and raise ``NotImplementedError``.

Only the paged-KV branches exist: the K/V cache is a physical block store
``[N, Kv, T, D]`` shared by all sequences through block tables.  Apply
functions update the store **in place** (the reference donates and
returns it) and return the new activations.
"""

from __future__ import annotations

import torch

from . import layers
from .layers import apply_norm, norm_init, project, rope

ATTN_KINDS = ("full", "swa", "local", "global", "bidir")
# kinds the reference's chunked/packed prefill serves (recurrent ones via
# scan state); the port serves the attention kinds among them
CHUNKABLE_KINDS = ATTN_KINDS + ("rwkv6", "rglru")


def split_kind(kind: str) -> tuple[str, bool]:
    if kind.endswith("+moe"):
        return kind[:-4], True
    return kind, False


def _check_ported(kind: str) -> str:
    base, is_moe = split_kind(kind)
    if base in ("rwkv6", "rglru"):
        raise NotImplementedError(
            f"block kind {kind!r}: recurrent families are ROADMAP Queue 1 "
            "item 8 (not ported yet)")
    if is_moe:
        raise NotImplementedError(
            f"block kind {kind!r}: MoE is ROADMAP Queue 1 item 7 (not "
            "ported yet)")
    if base not in ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    return base


def block_init(cfg, kind: str, dtype, device, generator,
               lead: tuple[int, ...] = ()) -> dict:
    """Parameters of one block; ``lead`` prepends stacking dims (the
    group-stacked layers carry a leading layer axis)."""
    _check_ported(kind)

    def dense(shape):
        return layers.dense_init(lead + shape, dtype, device, generator)

    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads

    def norm():
        return {k: v.expand(lead + v.shape).clone()
                for k, v in norm_init(cfg.norm, d, dtype, device).items()}

    params = {"ln1": norm()}
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


# ---------------------------------------------------------------------------
# apply: token-packed ragged stream (prefill chunks + decode segments)
# ---------------------------------------------------------------------------


def block_apply_packed(cfg, kind: str, params: dict, x, pos, slot_id, cache,
                       block_tables, plan):
    """One block over a token-packed ragged stream, paged KV.

    x: [1,P,d] — one flat stream of contiguous segments from up to B
    requests; pos: [P] int32 position of each token in its own request;
    slot_id: [P] int32 owning slot (-1 = dead pad); cache: this layer's
    block store; block_tables: [B,M] int32; plan: the stream's
    :func:`paged_write_plan`.  Write-then-attend: the stream's K/V are
    scattered into the store first (exact, since segments advance front to
    back, every same-segment position <= q_pos is then live), and queries
    attend through the paged segment-attention kernel, which masks by
    segment so no token sees another request."""
    from repro_torch.kernels.segment_attention import \
        paged_segment_attention_op
    base = _check_ported(kind)
    theta = _theta(cfg, base)
    h = apply_norm(cfg.norm, params["ln1"], x)
    pos2 = pos[None, :]
    q = rope(project(h, params["attn"]["wq"]), pos2, theta)
    k = rope(project(h, params["attn"]["wk"]), pos2, theta)
    v = project(h, params["attn"]["wv"])
    _paged_scatter(cache, k[0], v[0], plan)
    o = paged_segment_attention_op(q[0], cache["k"], cache["v"],
                                   block_tables, pos, slot_id,
                                   window=_window(cfg, base))
    x = x + layers.attn_output(params["attn"], o[None])
    h2 = apply_norm(cfg.norm, params["ln2"], x)
    return x + layers.mlp(params["mlp"], h2, cfg.mlp)


# ---------------------------------------------------------------------------
# apply: single decode step
# ---------------------------------------------------------------------------


def block_apply_step(cfg, kind: str, params: dict, x, pos, cache,
                     block_tables, plan):
    """x: [B,1,d]; pos: [B] int32 position of this token; cache: this
    layer's block store; plan: the rows' :func:`paged_write_plan` (it
    leaves out rows that are not decoding this tick).  The token's K/V is
    scattered into its block and attention runs through the paged decode
    kernel."""
    from repro_torch.kernels.paged_attention import paged_decode_attention_op
    base = _check_ported(kind)
    theta = _theta(cfg, base)
    h = apply_norm(cfg.norm, params["ln1"], x)
    pos2d = pos[:, None]
    q = rope(project(h, params["attn"]["wq"]), pos2d, theta)
    k_t = rope(project(h, params["attn"]["wk"]), pos2d, theta)
    v_t = project(h, params["attn"]["wv"])
    _paged_scatter(cache, k_t[:, 0], v_t[:, 0], plan)
    o = paged_decode_attention_op(q[:, 0], cache["k"], cache["v"],
                                  block_tables, pos,
                                  window=_window(cfg, base))
    x = x + layers.attn_output(params["attn"], o[:, None])
    h2 = apply_norm(cfg.norm, params["ln2"], x)
    return x + layers.mlp(params["mlp"], h2, cfg.mlp)
