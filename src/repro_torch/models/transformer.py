"""The model: decoder-only LM over the reference's parameter layout.

Layer stacking follows the reference: the repeating ``block_pattern``
becomes ``params["groups"]``, a list with one block dict per pattern
position whose leaves carry a leading layer axis (``[n_groups, ...]``);
``first_k_dense`` prefix layers and the pattern remainder are plain lists.
The reference scans over the stacked axis; here a Python loop indexes it,
so every layer's weights and cache are views into the stacked tensors,
and the caches are updated in place.  recurrentgemma's plan, for one, is
12 groups of (rglru, rglru, swa) and a 2-layer (rglru, rglru) remainder;
rwkv6-7b's is 32 groups of (rwkv6,).

The modality frontends follow the reference.  The vision prefix
(internvl2-1b): ``batch["patches"] [B,P,frontend_dim]`` pass through the
connector, ``gelu(patches @ w1) @ w2`` (tanh gelu), and go before the
token embeddings, so the backbone sees ``P + S`` positions and the loss
only the last ``S``.  The encoder-decoder (whisper-tiny): the frames
``batch["frames"] [B,Se,d]`` plus ``pos_emb[arange(Se)]`` run the
``enc_layers`` stacked ``bidir`` blocks and ``ln_enc``; the decoder input
adds ``pos_emb[positions]``, and after every decoder block a
cross-attention (``params["cross"]``, stacked over all layers: norm, q
from x, k and v from the encoder's output, attention without a mask)
adds its output.  ``pos_emb`` starts at zeros, as the reference's init
leaves it.  The caches keep the encoder's output as ``enc_out [B,Se,d]``
for decode.  Neither frontend has a chunked or packed form: the step
functions over streams and chunks raise ``ValueError`` for them.

Public entry points:
    init(cfg, generator, device)        -> params
    init_axes(cfg)                      -> the params' logical dim names
    init_cache(cfg, batch, cache_len, device, ring_margin=0) -> caches
                                        [dense rings and recurrent state,
                                        per slot]
    init_paged_cache(cfg, num_blocks, block_tokens, device) -> caches
    step_packed(cfg, params, caches, tokens, slot_id, pos, start, seg_len,
                block_tables=None)      -> last_logits [B, V]  [in place;
                                        one ragged stream of prefill
                                        chunks + length-1 decode segments]
    step_spec(cfg, params, caches, tokens, slot_id, pos, start, seg_len,
              spec_rows, spec_idx, draft_len, block_tables=None)
                                        -> (accept [B], toks [B, L])
                                        [in place; decode segments of
                                        1 + d lanes, drafts verified]
    decode_step(cfg, params, caches, token, pos, block_tables=None,
                active=None)            -> logits [B, V]       [in place]
    prefill_chunk(cfg, params, caches, tokens, start, lengths,
                  block_tables=None)    -> logits [B, V]       [in place;
                                        one padded chunk per slot]
    prefill(cfg, params, batch, cache_len=) -> (logits [B, V], caches)
                                        [one-shot, fresh dense caches]
    merge_slot(caches, one, slot)       [a one-row cache into a slot]
    forward(cfg, params, batch, remat="none") -> (hidden [B, S, d], aux)
    loss_fn(cfg, params, batch, remat="dots") -> (loss, {"ce", "aux"})
                                        [chunked cross-entropy; training]
With ``block_tables`` the attention caches are the paged block store;
without, the dense per-slot rings of :func:`init_cache`.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

import torch.nn.functional as F

from repro_torch.distributed.sharding import A

from . import blocks as B
from . import layers
from .layers import (apply_norm, attn_output, dense_init, norm_init, project,
                     torch_dtype)

LOSS_CHUNK = 512
# rows of the encoder-decoder's learned absolute positions (the reference's)
MAX_POS = 65536

# ---------------------------------------------------------------------------
# structure helpers
# ---------------------------------------------------------------------------


def _plan(cfg):
    """(prefix_kinds, pattern, n_groups, remainder_kinds) for the decoder."""
    pattern = tuple(cfg.block_pattern)
    n_prefix = cfg.first_k_dense
    n_rest = cfg.num_layers - n_prefix
    n_groups, rem = divmod(n_rest, len(pattern))
    prefix = tuple(B.split_kind(pattern[i % len(pattern)])[0]
                   for i in range(n_prefix))
    return prefix, pattern, n_groups, pattern[:rem]


def _all_kinds(cfg) -> set:
    return set(cfg.block_pattern) | set(_plan(cfg)[0])


def _index(tree, i: int):
    """Layer ``i`` of a group-stacked tree: views, not copies."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _layers(cfg, params, caches):
    """Yield (kind, layer params, layer block store) in layer order."""
    prefix, pattern, n_groups, rem = _plan(cfg)
    for j, kind in enumerate(prefix):
        yield kind, params["prefix"][j], caches["prefix"][j]
    for i in range(n_groups):
        for j, kind in enumerate(pattern):
            yield (kind, _index(params["groups"][j], i),
                   _index(caches["groups"][j], i))
    for j, kind in enumerate(rem):
        yield kind, params["rem"][j], caches["rem"][j]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    something else; asking for CUDA without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain versions on "
                               "the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _check_supported(cfg) -> None:
    for kind in _all_kinds(cfg):
        B._check_ported(kind)


def _check_chunkable(cfg) -> None:
    """The stream and chunk steps need a chunked prefill: a modality
    frontend, whose prefix or encoder output has no chunk form, raises."""
    _check_supported(cfg)
    if not supports_chunked_prefill(cfg):
        raise ValueError(f"{cfg.name}: a modality frontend serves only the "
                         "one-shot prefill and decode_step")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(cfg, generator: torch.Generator, device=None) -> dict:
    """Random weights in ``cfg.dtype`` on ``device`` (default CUDA), drawn
    from ``generator`` (which must live on that device): uniform
    +-1/sqrt(fan_in), the reference's distribution, not its bits."""
    device = resolve_device(device)
    _check_supported(cfg)
    dtype = torch_dtype(cfg.dtype)
    prefix, pattern, n_groups, rem = _plan(cfg)
    params: dict = {
        "embed": dense_init((cfg.vocab_size, cfg.d_model), dtype, device,
                            generator)}
    if not cfg.tie_embeddings:
        params["head"] = dense_init((cfg.d_model, cfg.vocab_size), dtype,
                                    device, generator)
    params["ln_f"] = norm_init(cfg.norm, cfg.d_model, dtype, device)
    if prefix:
        params["prefix"] = [B.block_init(cfg, k, dtype, device, generator)
                            for k in prefix]
    if n_groups:
        params["groups"] = [B.block_init(cfg, k, dtype, device, generator,
                                         lead=(n_groups,))
                            for k in pattern]
    if rem:
        params["rem"] = [B.block_init(cfg, k, dtype, device, generator)
                         for k in rem]
    d = cfg.d_model
    if cfg.frontend == "vision":
        params["connector"] = {
            "w1": dense_init((cfg.frontend_dim, d), dtype, device, generator),
            "w2": dense_init((d, d), dtype, device, generator)}
    if cfg.encoder_decoder:
        params["pos_emb"] = torch.zeros((MAX_POS, d), dtype=dtype,
                                        device=device)
        params["encoder"] = B.block_init(cfg, "bidir", dtype, device,
                                         generator, lead=(cfg.enc_layers,))
        params["ln_enc"] = norm_init(cfg.norm, d, dtype, device)
        params["cross"] = _cross_init(cfg, dtype, device, generator)
    return params


def _stack_axes(tree):
    """Stacked leaves gain a leading layer dim: unsharded."""
    if isinstance(tree, dict):
        return {k: _stack_axes(v) for k, v in tree.items()}
    return A(None, *tree.names)


def init_axes(cfg) -> dict:
    """The axes tree of :func:`init`'s params: each leaf's logical dim
    names (``distributed.sharding.Axes``), the reference's ``init``
    annotations, group-stacked and encoder and cross leaves with a
    leading ``None``."""
    _check_supported(cfg)
    prefix, pattern, n_groups, rem = _plan(cfg)
    axes: dict = {"embed": A("vocab", "embed")}
    if not cfg.tie_embeddings:
        axes["head"] = A("embed", "vocab")
    axes["ln_f"] = layers.norm_axes(cfg.norm)
    if prefix:
        axes["prefix"] = [B.block_axes(cfg, k) for k in prefix]
    if n_groups:
        axes["groups"] = [_stack_axes(B.block_axes(cfg, k)) for k in pattern]
    if rem:
        axes["rem"] = [B.block_axes(cfg, k) for k in rem]
    if cfg.frontend == "vision":
        axes["connector"] = {"w1": A(None, "embed"), "w2": A("embed", "embed")}
    if cfg.encoder_decoder:
        axes["pos_emb"] = A(None, "embed")
        axes["encoder"] = _stack_axes(B.block_axes(cfg, "bidir"))
        axes["ln_enc"] = layers.norm_axes(cfg.norm)
        axes["cross"] = _stack_axes({"attn": layers.attention_axes(),
                                     "ln": layers.norm_axes(cfg.norm)})
    return axes


def _cross_init(cfg, dtype, device, generator) -> dict:
    """One cross-attention ``{"attn": {wq, wk, wv, wo}, "ln"}`` per decoder
    layer, stacked over all ``num_layers``."""
    lead = (cfg.num_layers,)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads

    def dense(shape):
        return dense_init(lead + shape, dtype, device, generator)

    attn = {"wq": dense((d, h, hd)), "wk": dense((d, kv, hd)),
            "wv": dense((d, kv, hd)), "wo": dense((h, hd, d))}
    ln = {k: v.expand(lead + v.shape).clone()
          for k, v in norm_init(cfg.norm, d, dtype, device).items()}
    return {"attn": attn, "ln": ln}


# ---------------------------------------------------------------------------
# capability checks and the caches
# ---------------------------------------------------------------------------


def supports_chunked_prefill(cfg) -> bool:
    """The reference's predicate: every block position-maskable or
    scan-state threaded, and no modality frontend."""
    if cfg.encoder_decoder or cfg.frontend == "vision":
        return False
    return all(B.split_kind(k)[0] in B.CHUNKABLE_KINDS
               for k in _all_kinds(cfg))


def supports_paged_kv(cfg) -> bool:
    """Paged KV needs every block to be an attention kind and prefill to
    go through the chunked path."""
    if not supports_chunked_prefill(cfg):
        return False
    return all(B.split_kind(k)[0] in B.ATTN_KINDS for k in _all_kinds(cfg))


def _cache_tree(cfg, make) -> dict:
    """``make(kind, lead)`` for every layer, in the params' layout: group
    layers stacked with ``lead = (n_groups,)``."""
    prefix, pattern, n_groups, rem = _plan(cfg)
    caches = {}
    if prefix:
        caches["prefix"] = [make(k, ()) for k in prefix]
    if n_groups:
        caches["groups"] = [make(k, (n_groups,)) for k in pattern]
    if rem:
        caches["rem"] = [make(k, ()) for k in rem]
    return caches


def init_cache(cfg, batch: int, cache_len: int, device,
               ring_margin: int = 0) -> dict:
    """Dense per-slot caches: a ``[batch, n, Kv, D]`` ring (``n`` the
    window plus ``ring_margin`` for windowed kinds, ``cache_len``
    otherwise) with its position plane for attention layers, ``{h, conv}``
    scan state for rglru layers, ``{S, tm_last, cm_last}`` for rwkv6
    layers; group layers stacked ``[n_groups, batch, ...]``.
    ``ring_margin`` is what speculative drafts need: up to ``k`` rejected
    positions past the pending token (:func:`blocks.cache_len_for`).  The
    encoder-decoder adds ``enc_out [batch, enc_seq, d]`` (zeros until a
    prefill writes it)."""
    _check_supported(cfg)
    caches = _cache_tree(cfg, lambda k, lead: B.block_cache_init(
        cfg, k, batch, cache_len, device, lead, ring_margin=ring_margin))
    if cfg.encoder_decoder:
        caches["enc_out"] = torch.zeros(
            (batch, cfg.enc_seq, cfg.d_model), dtype=torch_dtype(cfg.dtype),
            device=device)
    return caches


def ring_lens(caches: dict) -> set[int]:
    """The ring lengths of a dense cache tree's attention layers."""
    return {c["k"].shape[-3] for key in ("prefix", "groups", "rem")
            for c in caches.get(key, ()) if "pos" in c}


def dense_packed_plans(caches, slot_id, pos, start, seg_len) -> dict:
    """One :func:`~repro_torch.models.blocks.dense_packed_plan` per ring
    length, for :func:`step_packed` on dense caches."""
    return {n: B.dense_packed_plan(slot_id, pos, start, seg_len, n)
            for n in ring_lens(caches)}


def chunk_plan(caches, pos, valid, block_tables=None):
    """A padded chunk's K/V write plan over its flattened ``[B*C]`` lanes
    (pos, valid: [B,C]), for :func:`prefill_chunk`: each row's real tokens
    are one segment of a packed stream, pads and inactive rows dead lanes
    — :func:`~repro_torch.models.blocks.paged_write_plan` with
    ``block_tables``, else :func:`dense_packed_plans`."""
    b, c = pos.shape
    rows = torch.arange(b, device=pos.device).repeat_interleave(c)
    seg = torch.where(valid.reshape(-1), rows, -1)
    if block_tables is not None:
        return B.paged_write_plan(seg, pos.reshape(-1), block_tables,
                                  _block_tokens(caches))
    return dense_packed_plans(caches, seg, pos.reshape(-1), pos[:, 0],
                              valid.sum(dim=1))


def dense_step_plans(caches, pos, active=None) -> dict:
    """One :func:`~repro_torch.models.blocks.dense_step_plan` per ring
    length, for :func:`decode_step` on dense caches."""
    return {n: B.dense_step_plan(pos, active, n) for n in ring_lens(caches)}


def merge_slot(caches: dict, one: dict, slot: int) -> None:
    """Copy a one-row dense cache tree (:func:`prefill`'s, batch 1) into
    row ``slot`` of the engine's caches in place: every leaf of the slot,
    so whatever an earlier occupant left there is overwritten (the
    reference's ``merge_fn``), the encoder's output ``enc_out`` too."""
    for key, axis in (("prefix", 0), ("groups", 1), ("rem", 0)):
        for c, o in zip(caches.get(key, ()), one.get(key, ())):
            for n, a in c.items():
                a.select(axis, slot).copy_(o[n].select(axis, 0))
    if "enc_out" in caches:
        caches["enc_out"][slot].copy_(one["enc_out"][0])


def init_paged_cache(cfg, num_blocks: int, block_tokens: int, device) -> dict:
    """Per-layer physical block stores ``[num_blocks, Kv, T, D]`` (group
    layers stacked ``[n_groups, num_blocks, Kv, T, D]``)."""
    if not supports_paged_kv(cfg):
        raise ValueError(f"{cfg.name}: block pattern {cfg.block_pattern} "
                         "does not support paged KV")
    return _cache_tree(cfg, lambda k, lead: B.paged_cache_init(
        cfg, k, num_blocks, block_tokens, device, lead))


def map_paged_caches(caches: dict, fn) -> dict:
    """Apply ``fn(tensor, block_axis)`` to every store plane (block axis 0
    for prefix/rem layers, 1 for the group-stacked ones) and return the new
    tree.  The engine uses it to resize the block store physically when
    ``serve.kv_block_budget`` moves; the old tensors are released once the
    caller drops the old tree."""
    out = dict(caches)
    for key, axis in (("prefix", 0), ("groups", 1), ("rem", 0)):
        if key in caches:
            out[key] = [{n: fn(a, axis) for n, a in c.items()}
                        for c in caches[key]]
    return out


def copy_paged_blocks(caches: dict, src, dst) -> None:
    """Block-level copy-on-write across every layer, in place: physical
    blocks ``src[i] -> dst[i]`` in each store plane."""
    for key, axis in (("prefix", 0), ("groups", 1), ("rem", 0)):
        for c in caches.get(key, ()):
            B.paged_copy_blocks(c, src, dst, block_axis=axis)


def _block_tokens(caches: dict) -> int:
    for key in ("prefix", "groups", "rem"):
        if key in caches:
            return caches[key][0]["k"].shape[-2]
    raise ValueError("empty cache tree")


def _logits(cfg, params, x):
    # a head in another dtype than x (the f32 head of
    # ``serve.speculation.markov_params``) promotes the product, as in JAX
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (x.to(head.dtype) @ head).float()


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def step_packed(cfg, params, caches, tokens, slot_id, pos, start, seg_len,
                block_tables=None, plan=None):
    """Advance the engine by ONE token-packed ragged stream, in place —
    prefill chunks AND decode tokens ride the same call.

    tokens: [1,P] — contiguous segments from up to B requests back to back
    (a prefilling request's next prompt chunk, a running request's decode
    token as a length-1 segment); slot_id: [P] int32 owning slot (-1 =
    dead pad); pos: [P] int32 position within its own request; start /
    seg_len: [B] int32 per-slot segment start and length.  block_tables:
    [B,M] int32 for paged caches, None for dense ones.  ``plan`` is the
    stream's write plan — :func:`~repro_torch.models.blocks
    .paged_write_plan` (paged) or :func:`dense_packed_plans` (dense) —
    computed here when not given (which synchronises on a CUDA stream).
    Returns the next-token logits [B,V] at each slot's last packed token
    (garbage for slots with no tokens this call); caches are updated in
    place."""
    _check_chunkable(cfg)
    if plan is None:
        plan = (dense_packed_plans(caches, slot_id, pos, start, seg_len)
                if block_tables is None else
                B.paged_write_plan(slot_id, pos, block_tables,
                                   _block_tokens(caches)))
    x = params["embed"][tokens]
    for kind, p, c in _layers(cfg, params, caches):
        x = B.block_apply_packed(cfg, kind, p, x, pos, slot_id, start,
                                 seg_len, c, block_tables, plan)
    x = apply_norm(cfg.norm, params["ln_f"], x)
    nslots = start.shape[0]
    t_idx = torch.arange(tokens.shape[1], device=x.device)
    own = slot_id[None, :] == torch.arange(nslots, device=x.device)[:, None]
    last_idx = torch.where(own, t_idx[None, :], -1).amax(dim=1)      # [B]
    xl = x[0, last_idx.clamp(min=0)]                                 # [B,d]
    return _logits(cfg, params, xl)


def _resolve_pending(cache: dict, stack: dict, accept, spec_rows) -> None:
    """Write the post-acceptance recurrent snapshot into each spec row of
    one layer's state, in place: ``stack`` leaves are ``[l, B, ...]``,
    snapshot ``j`` the state after consuming offsets ``0..j`` of the spec
    segment, so ``accept[b]`` names the state after the last emitted and
    consumed token.  Non-spec rows keep the full-chunk result.  Index and
    select only: nothing waits for the device."""
    rows = torch.arange(accept.shape[0], device=accept.device)
    for n, a in cache.items():
        st = stack[n]
        sel = st[accept.long().clamp(0, st.shape[0] - 1), rows]
        m = spec_rows.view((-1,) + (1,) * (a.dim() - 1))
        a.copy_(torch.where(m, sel.to(a.dtype), a))


def step_spec(cfg, params, caches, tokens, slot_id, pos, start, seg_len,
              spec_rows, spec_idx, draft_len, block_tables=None, plan=None):
    """One packed stream whose decode segments carry speculative drafts,
    in place.

    The layout is :func:`step_packed`'s, except that a running slot's
    segment is ``[pending, d1..dd]`` (length ``1 + d``, ``start = pos``):
    the pending token — the slot's last sampled, not yet consumed token —
    followed by ``d`` drafted continuations.  Extra inputs: spec_rows [B]
    bool marks the draft-carrying rows; spec_idx [B, L] int the stream
    index of each segment offset (rows with shorter segments repeat their
    last index, masked by draft_len); draft_len [B] int drafted tokens per
    row (0 for prefill rows, whose spec_idx[:, 0] names their last packed
    prompt token).

    Verification is the per-offset argmax of the same call: ``toks[b, j]``
    is the model's next token after consuming offsets ``0..j``.  Greedy
    acceptance keeps the longest matching draft prefix: ``accept[b]`` is
    the number of leading drafts equal to the argmax before them, so the
    emitted tokens ``toks[b, :accept[b]+1]`` are what ``accept + 1``
    sequential steps without drafts would give.  Returns (accept [B]
    int32, toks [B, L] int32), both on the device; nothing here waits for
    it.  A rejected suffix's attention K/V needs no undo (see
    :func:`blocks.block_apply_spec`); recurrent state is rolled back: each
    recurrent layer's snapshots are resolved into its state once
    ``accept`` is computed (:func:`_resolve_pending`).  ``plan`` is
    :func:`step_packed`'s."""
    _check_chunkable(cfg)
    if plan is None:
        plan = (dense_packed_plans(caches, slot_id, pos, start, seg_len)
                if block_tables is None else
                B.paged_write_plan(slot_id, pos, block_tables,
                                   _block_tokens(caches)))
    l_max = spec_idx.shape[1]
    x = params["embed"][tokens]
    pending = []
    for kind, p, c in _layers(cfg, params, caches):
        x, stack = B.block_apply_spec(cfg, kind, p, x, pos, slot_id, start,
                                      seg_len, spec_rows, l_max, c,
                                      block_tables, plan)
        if stack is not None:
            pending.append((c, stack))
    x = apply_norm(cfg.norm, params["ln_f"], x)
    idx = spec_idx.long()
    toks = _logits(cfg, params, x[0, idx]).argmax(dim=-1).to(torch.int32)
    drafted = tokens[0, idx]                                         # [B,L]
    offs = torch.arange(1, l_max, device=x.device)[None, :]
    match = ((drafted[:, 1:] == toks[:, :-1])
             & (offs <= draft_len[:, None]))
    accept = match.int().cumprod(dim=1).sum(dim=1).to(torch.int32)
    for c, stack in pending:
        _resolve_pending(c, stack, accept, spec_rows)
    return accept, toks


def prefill_chunk(cfg, params, caches, tokens, start, lengths,
                  block_tables=None, plan=None):
    """Advance prefill by one padded chunk per slot, in place.

    tokens: [B,C] int32, rows left-aligned and zero-padded; start: [B]
    int32 position of each row's first chunk token; lengths: [B] int32
    real tokens this chunk (0 = inactive row: no cache or state writes,
    garbage logits).  block_tables: [B,M] int32 for paged caches, None
    for dense ones.  ``plan`` is the chunk's write plan over the flattened
    ``[B*C]`` lanes, :func:`chunk_plan`, computed here when not given
    (which synchronises on a CUDA stream).  Returns the next-token
    logits [B,V] at each row's last real token.  Attention chunks attend
    to earlier chunks through the caches, recurrent layers thread their
    scan state, so calling this over a long prompt is exact chunked
    prefill."""
    _check_chunkable(cfg)
    b, c = tokens.shape
    t = torch.arange(c, dtype=torch.int32, device=tokens.device)[None, :]
    pos = start[:, None] + t                                         # [B,C]
    valid = t < lengths[:, None]
    if plan is None:
        plan = chunk_plan(caches, pos, valid, block_tables)
    x = params["embed"][tokens]
    for kind, p, cache in _layers(cfg, params, caches):
        x = B.block_apply_chunk(cfg, kind, p, x, pos, valid, cache,
                                block_tables, plan)
    x = apply_norm(cfg.norm, params["ln_f"], x)
    last = (lengths.long() - 1).clamp(0, c - 1)
    xl = x[torch.arange(b, device=x.device), last]                   # [B,d]
    return _logits(cfg, params, xl)


def decode_step(cfg, params, caches, token, pos, block_tables=None,
                active=None, plan=None):
    """token: [B] int32; pos: [B] int32.  ``active`` ([B] bool) leaves
    non-decoding rows' caches and state untouched; ``plan`` is the rows'
    write plan — :func:`~repro_torch.models.blocks.paged_write_plan`
    (paged, ``block_tables`` given) or :func:`dense_step_plans` (dense) —
    computed here when not given.  Returns logits [B,V]; caches are
    updated in place.  The encoder-decoder adds ``pos_emb[pos]`` to the
    token's embedding and attends, after every block, to the slot's
    ``caches["enc_out"]`` (:func:`cross_attend`, K/V projected from it
    again at every step, as in the reference)."""
    _check_supported(cfg)
    if plan is None:
        if block_tables is None:
            plan = dense_step_plans(caches, pos, active)
        else:
            rows = torch.arange(token.shape[0], device=token.device)
            plan = B.paged_write_plan(rows, pos, block_tables,
                                      _block_tokens(caches), valid=active)
    x = params["embed"][token][:, None, :]                           # [B,1,d]
    if "pos_emb" in params:
        x = x + params["pos_emb"][pos][:, None, :]
    enc_out = caches.get("enc_out") if cfg.encoder_decoder else None
    for li, (kind, p, c) in enumerate(_layers(cfg, params, caches)):
        x = B.block_apply_step(cfg, kind, p, x, pos, c, block_tables, plan,
                               active)
        if enc_out is not None:
            x = cross_attend(cfg, _index(params["cross"], li), x, enc_out,
                             step=True)
    x = apply_norm(cfg.norm, params["ln_f"], x)
    return _logits(cfg, params, x)[:, 0]


# ---------------------------------------------------------------------------
# training: full-sequence forward and loss
# ---------------------------------------------------------------------------


def _grad_checkpoint(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass when a
    gradient is being taken (``torch.utils.checkpoint``, non-reentrant)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def _inputs_embeds(cfg, params, batch):
    """Token embeddings, after the connector's patch embeddings for the
    vision prefix -> (x [B,P+S,d], positions [P+S] int32)."""
    x = params["embed"][batch["tokens"]]
    if cfg.frontend == "vision":
        c = params["connector"]
        pe = F.gelu(batch["patches"].to(c["w1"].dtype) @ c["w1"],
                    approximate="tanh") @ c["w2"]
        x = torch.cat([pe, x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return x, positions


def _run_encoder(cfg, params, frames):
    """The encoder over precomputed frame embeddings [B,Se,d]: plus
    ``pos_emb[arange(Se)]``, the stacked ``bidir`` blocks, then
    ``ln_enc``."""
    x = frames.to(torch_dtype(cfg.dtype))
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x = x + params["pos_emb"][positions]
    for i in range(cfg.enc_layers):
        x, _ = B.block_apply_seq(cfg, "bidir", _index(params["encoder"], i),
                                 x, positions)
    return apply_norm(cfg.norm, params["ln_enc"], x)


def _decoder_inputs(cfg, params, batch):
    """(x [B,S',d], positions [S'], the encoder's output or None): the
    embeddings of :func:`_inputs_embeds`, for the encoder-decoder plus
    ``pos_emb[positions]``, and its encoder run over the frames."""
    enc_out = None
    if cfg.encoder_decoder:
        enc_out = _run_encoder(cfg, params, batch["frames"])
    x, positions = _inputs_embeds(cfg, params, batch)
    if cfg.encoder_decoder:
        x = x + params["pos_emb"][positions]
    return x, positions, enc_out


def cross_attend(cfg, cp, x, enc_out, *, step: bool = False):
    """One decoder layer's cross-attention and its residual: ``x +
    attn_output(attention(q(norm(x)), k(enc_out), v(enc_out)))`` with
    every frame admitted.  ``cp``: the layer's ``{"attn", "ln"}``;
    x [B,S,d]; enc_out [B,Se,d].  A sequence takes the flash kernels at
    Sq = S and Sk = Se (:func:`layers.attention`, causal off, no window);
    a decode step (``step``, S = 1) the dense decode kernel over the
    frames (:func:`layers.cross_decode_attention`)."""
    h = apply_norm(cfg.norm, cp["ln"], x)
    q = project(h, cp["attn"]["wq"])
    k = project(enc_out, cp["attn"]["wk"])
    v = project(enc_out, cp["attn"]["wv"])
    if step:
        o = layers.cross_decode_attention(q, k, v)
    else:
        o = layers.attention(q, k, v, q_pos=None, k_pos=None, causal=False,
                             window=0)
    return x + attn_output(cp["attn"], o)


def _run_blocks_seq(cfg, params, x, positions, *, remat: str = "none",
                    caches=None, enc_out=None):
    """prefix -> groups -> remainder over the whole sequence, each layer
    followed by its cross-attention to ``enc_out`` when one is given (the
    encoder-decoder).  ``caches`` is None in training; in the one-shot
    prefill it is a dense cache tree from :func:`init_cache`, which every
    layer fills in place.  With ``remat`` other than ``"none"`` every
    group layer, its cross-attention with it, recomputes its activations
    in the backward pass; the reference rematerialises the scanned group
    body under its ``remat`` policy, and the flash kernels' outputs are
    not among what ``"dots"`` saves, so there too the attention forward
    runs again in the backward pass.  Returns ``(x, aux_total)``."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    prefix, pattern, n_groups, rem = _plan(cfg)
    layer_caches = (_layers(cfg, params, caches) if caches is not None
                    else None)
    layer_index = iter(range(cfg.num_layers))

    def run(kind, p, x, grouped):
        cache = None if layer_caches is None else next(layer_caches)[2]
        li = next(layer_index)
        cp = None if enc_out is None else _index(params["cross"], li)

        def fn(p, cp, x, enc_out):
            x, aux = B.block_apply_seq(cfg, kind, p, x, positions, cache)
            if cp is not None:
                x = cross_attend(cfg, cp, x, enc_out)
            return x, aux
        if grouped and remat != "none":
            return _grad_checkpoint(fn, p, cp, x, enc_out)
        return fn(p, cp, x, enc_out)

    for j, kind in enumerate(prefix):
        x, aux = run(kind, params["prefix"][j], x, False)
        aux_total = aux_total + aux
    for i in range(n_groups):
        for j, kind in enumerate(pattern):
            x, aux = run(kind, _index(params["groups"][j], i), x, True)
            aux_total = aux_total + aux
    for j, kind in enumerate(rem):
        x, aux = run(kind, params["rem"][j], x, False)
        aux_total = aux_total + aux
    return x, aux_total


def forward(cfg, params, batch, *, remat: str = "none"):
    """batch: ``{"tokens": [B,S] int}``, with ``"patches" [B,P,
    frontend_dim]`` for the vision prefix or ``"frames" [B,Se,d]`` for the
    encoder-decoder -> (final-norm hidden states [B,P+S,d], aux)."""
    _check_supported(cfg)
    x, positions, enc_out = _decoder_inputs(cfg, params, batch)
    x, aux = _run_blocks_seq(cfg, params, x, positions, remat=remat,
                             enc_out=enc_out)
    return apply_norm(cfg.norm, params["ln_f"], x), aux


@torch.no_grad()
def prefill(cfg, params, batch, *, cache_len: int):
    """One-shot prefill of whole prompts: batch ``{"tokens": [B,S] int}``
    (and a frontend's ``patches`` or ``frames``, as :func:`forward`) ->
    (next-token logits [B,V] at the last position, fresh dense caches of
    ``cache_len`` filled with the prompts' K/V, the patch positions' too,
    the recurrent state after their last position and the encoder's
    output).  Without gradients the attention takes the flash forward
    kernel without its LSE output; the recurrent kinds run their one-shot
    forms."""
    _check_supported(cfg)
    x, positions, enc_out = _decoder_inputs(cfg, params, batch)
    caches = init_cache(cfg, x.shape[0], cache_len, x.device)
    if enc_out is not None:
        caches["enc_out"] = enc_out
    x, _ = _run_blocks_seq(cfg, params, x, positions, caches=caches,
                           enc_out=enc_out)
    x = apply_norm(cfg.norm, params["ln_f"], x[:, -1])
    return _logits(cfg, params, x), caches


def _chunk_loss(x_i, labels_i, head):
    """Summed cross-entropy of one chunk; the logits are f32."""
    logits = (x_i @ head).float()
    gold = torch.gather(logits, -1, labels_i[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def loss_fn(cfg, params, batch, *, remat: str = "dots",
            aux_weight: float = 0.01):
    """Mean next-token cross-entropy of ``batch["labels"]`` [B,S], chunked
    over the sequence in pieces of at most :data:`LOSS_CHUNK` tokens whose
    logits are recomputed in the backward pass, so the [B,S,V] logits
    never materialise; the vision prefix's positions carry no loss.
    Returns ``(loss + aux_weight * aux, {"ce", "aux"})`` as 0-d f32
    tensors."""
    x, aux = forward(cfg, params, batch, remat=remat)
    labels = batch["labels"].long()
    if cfg.frontend == "vision":
        x = x[:, -labels.shape[1]:]
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    b, s, _ = x.shape
    chunk = min(LOSS_CHUNK, s)
    while s % chunk:
        chunk -= 1
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        total = total + _grad_checkpoint(_chunk_loss, x[:, c0:c0 + chunk],
                                         labels[:, c0:c0 + chunk], head)
    loss = total / (b * s)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}
