"""The port's split serve path against the JAX package's, on the CPU.

The one-shot ``prefill`` (logits and the filled dense caches, rings that
wrap included; the recurrent archs' state through their one-shot forms),
the padded ``prefill_chunk`` on dense rings and on the paged block store
(ragged rows, chunks that do not divide the prompts, rows going
inactive), the step factories, and the engine in
``prefill_mode="bucketed"`` (dense and paged KV) and ``"legacy"`` (dense;
also on recurrentgemma-9b and rwkv6-7b, and with prompts longer than the
reduced swa window): greedy tokens identical to the JAX engine in the
same mode and to the port's own packed engine, with the same dispatch,
program and prefill-call counts.  ``reduced()`` configs in f32; weights and caches are the JAX
package's, carried across with ``params_from_numpy``.  Logits and caches
agree to ``atol=1e-4, rtol=1e-5``: the two packages sum in other orders
(the port's one-shot attention is the flash route's plain version, the
JAX default is XLA), so f32 rounding differs at ~1e-6 of these values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import transformer as jtransformer
from repro.models import zoo as jzoo
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import train_step as jtrain_step
from repro_torch.configs import get_config, reduced
from repro_torch.models import zoo
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import train_step

ARCHS = ["yi-6b", "h2o-danube-3-4b", "gemma3-4b", "starcoder2-15b"]
RECURRENT_ARCHS = ["recurrentgemma-9b", "rwkv6-7b"]
ATOL, RTOL = 1e-4, 1e-5
PROMPT_LENS = (5, 19, 33)
MAX_NEW = 4
# rwkv6 has d // 64 heads: two at d 128, where plain reduced() gives one
OVERRIDES = {"rwkv6-7b": {"d_model": 128}}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _weights(arch, seed=0):
    extra = OVERRIDES.get(arch, {})
    jcfg = jax_reduced(jax_get_config(arch), **extra)
    params, _ = jzoo.init(jcfg, jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, reduced(get_config(arch), **extra), tp


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_caches(jc, tc):
    jl, tl = jax.tree.leaves(jc), jax.tree.leaves(tc)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=ATOL,
                                   rtol=RTOL)


# ------------------------------------------------------- one-shot prefill
@pytest.mark.parametrize("arch", ARCHS + RECURRENT_ARCHS)
def test_prefill_matches_jax(arch):
    """Two 40-token prompts into 64-entry caches: the full-attention rings
    fill their front, the windowed ones (32 reduced) keep the last 32
    positions in ring order; recurrent layers hold the state after the
    last position (rwkv6: one chunk of 40, as the reference cuts it)."""
    jcfg, params, cfg, tp = _weights(arch, seed=1)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, jc = jzoo.prefill(jcfg, params, {"tokens": jnp.asarray(tokens)},
                            cache_len=64)
    got, tc = zoo.prefill(cfg, tp, {"tokens": torch.from_numpy(tokens)},
                          cache_len=64)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    _assert_caches(jc, tc)


def test_prefill_and_serve_steps_match_jax():
    """``make_prefill_step`` then ``make_serve_step`` (decode on the
    filled dense caches) against the JAX step factories."""
    jcfg, params, cfg, tp = _weights("gemma3-4b", seed=2)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    want, jc = jtrain_step.make_prefill_step(jcfg, cache_len=48)(
        params, {"tokens": jnp.asarray(tokens)})
    got, tc = train_step.make_prefill_step(cfg, cache_len=48)(
        tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    tok = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
    pos = np.array([37, 37], np.int32)
    want, jc = jtrain_step.make_serve_step(jcfg)(
        params, jc, jnp.asarray(tok), jnp.asarray(pos))
    got = train_step.make_serve_step(cfg)(tp, tc, torch.from_numpy(tok),
                                          torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    _assert_caches(jc, tc)


def test_merge_slot_overwrites_an_earlier_occupant():
    """A one-row prefill cache merged into a slot replaces the whole row,
    an earlier occupant's ring entries included, and no other row."""
    _, _, cfg, tp = _weights("gemma3-4b")
    caches = zoo.init_cache(cfg, 3, 48, "cpu")
    gen = torch.Generator().manual_seed(0)
    for c in (caches["groups"] + caches.get("rem", [])):
        for n, a in c.items():
            a.copy_(torch.randint(0, 40, a.shape, generator=gen)
                    if n == "pos" else torch.randn(a.shape, generator=gen))
    before = [a.clone() for c in caches["groups"] for a in c.values()]
    tokens = torch.randint(0, cfg.vocab_size, (1, 9), generator=gen)
    _, one = zoo.prefill(cfg, tp, {"tokens": tokens}, cache_len=48)
    zoo.merge_slot(caches, one, 1)
    after = [a for c in caches["groups"] for a in c.values()]
    ones = [a for c in one["groups"] for a in c.values()]
    for b, a, o in zip(before, after, ones):
        assert torch.equal(a[:, 1], o[:, 0])
        assert torch.equal(a[:, 0], b[:, 0]) and torch.equal(a[:, 2], b[:, 2])
    assert (one["groups"][0]["pos"][:, 0, 9:] == -1).all()


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_merge_slot_carries_the_recurrent_leaves(arch):
    """On the recurrent archs a merged slot takes every leaf of the
    prefill's row: the RG-LRU's h and conv window and the swa ring, or the
    WKV state S and both token shifts; the other rows keep theirs."""
    _, _, cfg, tp = _weights(arch)
    caches = zoo.init_cache(cfg, 3, 48, "cpu")
    gen = torch.Generator().manual_seed(0)
    leaves = [(c, n) for c in caches["groups"] + caches.get("rem", [])
              for n in c]
    for c, n in leaves:
        c[n].copy_(torch.randint(0, 40, c[n].shape, generator=gen)
                   if n == "pos" else torch.randn(c[n].shape, generator=gen))
    names = {n for _, n in leaves}
    assert names >= ({"h", "conv"} if arch == "recurrentgemma-9b"
                     else {"S", "tm_last", "cm_last"})
    before = [c[n].clone() for c, n in leaves]
    tokens = torch.randint(0, cfg.vocab_size, (1, 9), generator=gen)
    _, one = zoo.prefill(cfg, tp, {"tokens": tokens}, cache_len=48)
    zoo.merge_slot(caches, one, 1)
    ones = [c[n] for c in one["groups"] + one.get("rem", []) for n in c]
    for (c, n), b, o in zip(leaves, before, ones):
        axis = 1 if any(c is g for g in caches["groups"]) else 0
        assert torch.equal(c[n].select(axis, 1), o.select(axis, 0)), n
        for row in (0, 2):
            assert torch.equal(c[n].select(axis, row), b.select(axis, row))
    assert not any(torch.equal(o, torch.zeros_like(o)) for o in ones
                   if o.dtype.is_floating_point)


# ------------------------------------------------------ padded chunk prefill
ROW_LENS = (50, 37, 11)     # none a multiple of the chunk; row 2 ends first
CHUNK = 13


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_jax(arch, kv):
    """Engine-shaped schedule: every call advances each unfinished row by
    up to ``CHUNK`` tokens, finished rows ride along with length 0.  Paged:
    block tables out of order.  Logits of every row that ran and every
    cache leaf after each call."""
    jcfg, params, cfg, tp = _weights(arch, seed=1)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in ROW_LENS]
    b, cache_len, t = len(prompts), 64, 8
    m = cache_len // t
    if kv == "paged":
        n_blocks = b * m + 3
        tables = rng.permutation(n_blocks)[:b * m].astype(np.int32) \
            .reshape(b, m)
        jc = jzoo.init_paged_cache(jcfg, n_blocks, t)
        tc = zoo.init_paged_cache(cfg, n_blocks, t, "cpu")
        bt_j, bt_t = jnp.asarray(tables), torch.from_numpy(tables)
    else:
        jc = jzoo.init_cache(jcfg, b, cache_len)
        tc = zoo.init_cache(cfg, b, cache_len, "cpu")
        bt_j = bt_t = None
    done = [0] * b
    while any(done[i] < len(p) for i, p in enumerate(prompts)):
        tok = np.zeros((b, CHUNK), np.int32)
        start = np.zeros(b, np.int32)
        lengths = np.zeros(b, np.int32)
        for i, p in enumerate(prompts):
            n = min(CHUNK, len(p) - done[i])
            tok[i, :n] = p[done[i]:done[i] + n]
            start[i], lengths[i] = done[i], n
        want, jc = jtransformer.prefill_chunk(
            jcfg, params, jc, *map(jnp.asarray, (tok, start, lengths)),
            block_tables=bt_j)
        got = zoo.prefill_chunk(cfg, tp, tc,
                                *map(torch.from_numpy, (tok, start, lengths)),
                                bt_t)
        ran = lengths > 0
        np.testing.assert_allclose(_np(got)[ran], np.asarray(want)[ran],
                                   atol=ATOL, rtol=RTOL)
        _assert_caches(jc, tc)
        for i in range(b):
            done[i] += int(lengths[i])


# ------------------------------------------------------------- the engine
def _serve(eng, req_cls, prompts, chunk=16, max_ticks=400):
    eng.prefill_chunk = chunk
    for i, p in enumerate(prompts):
        eng.submit(req_cls(i, p, MAX_NEW))
    stats = []
    while len(eng.finished) < len(prompts) and len(stats) < max_ticks:
        stats.append(eng.tick())
    assert len(eng.finished) == len(prompts)
    out = dict(tokens={r.req_id: list(r.generated) for r in eng.finished},
               ticks=len(stats), dispatches=eng.model_dispatches,
               per_tick=[st["dispatches"] for st in stats],
               programs=eng.model_programs, prefill_calls=eng.prefill_calls,
               pad_fraction=round(eng.pad_fraction, 9), paged=eng.paged,
               mode=eng.prefill_impl)
    eng.close()
    return out


def _both(arch, mode, kv_mode, prompts=None):
    jcfg, jp, cfg, tp = _weights(arch)
    if prompts is None:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in PROMPT_LENS]
    opts = dict(max_batch=2, cache_len=96, enable_smartconf=False,
                prefill_mode=mode, kv_mode=kv_mode)
    want = _serve(JServeEngine(jcfg, jp, **opts), JRequest, prompts)
    got = _serve(ServeEngine(cfg, tp, device="cpu", **opts), Request,
                 prompts)
    packed = _serve(ServeEngine(cfg, tp, device="cpu", max_batch=2,
                                cache_len=96, enable_smartconf=False),
                    Request, prompts)
    return want, got, packed


SPLIT_CASES = [(arch, mode, kv_mode) for arch in ARCHS
               for mode, kv_mode in (("bucketed", "dense"),
                                     ("bucketed", "paged"),
                                     ("legacy", "dense"))]
SPLIT_CASES += [(arch, "legacy", "dense") for arch in RECURRENT_ARCHS]


@pytest.mark.parametrize("arch,mode,kv_mode", SPLIT_CASES,
                         ids=["-".join(c) for c in SPLIT_CASES])
def test_split_modes_match_jax_engine(arch, mode, kv_mode):
    """Three requests through two slots (the third reuses a slot whose
    ring or state still holds its first occupant's): the same tokens,
    ticks, dispatches (per tick too), programs, prefill calls and padding
    as the JAX engine, and the same tokens as the port's packed engine."""
    want, got, packed = _both(arch, mode, kv_mode)
    assert got == want
    assert got["paged"] == (kv_mode == "paged") and got["mode"] == mode
    assert got["tokens"] == packed["tokens"]
    # bucketed: a prefill call and a decode step; legacy: both slots'
    # prefill calls in the first tick, then its decode step
    assert max(got["per_tick"]) == (2 if mode == "bucketed" else 3)


def test_legacy_prompts_past_the_window_match_jax_engine():
    """Legacy recurrentgemma with prompts longer than its reduced 32-entry
    swa window (the one-shot prefill keeps each ring's last 32 positions
    in ring order, then decode wraps them further): the JAX legacy
    engine's tokens, and the port's packed engine's."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (45, 70, 33)]
    want, got, packed = _both("recurrentgemma-9b", "legacy", "dense",
                              prompts)
    assert got == want
    assert got["tokens"] == packed["tokens"]


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_bucketed_recurrent_archs_match_jax_engine(arch):
    """Bucketed ticks on the hybrid and the all-recurrent arch (dense
    rings and scan state; the scan state restarts in a reused slot)."""
    want, got, packed = _both(arch, "bucketed", "auto")
    assert got == want
    assert not got["paged"]
    assert got["tokens"] == packed["tokens"]


def test_split_dispatch_counts():
    """Bucketed: one prefill call on each tick with a prefilling slot and
    one decode step on each tick with a running one (at most two).
    Legacy: one prefill call per admitted request, in its admission tick,
    then the decode step.  Programs: bucketed chunk widths (powers of two,
    at least 16) plus the decode step; legacy prompt lengths plus it."""
    _, _, cfg, tp = _weights("yi-6b")
    rng = np.random.default_rng(3)
    lens = (5, 40, 17, 17, 29)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    for mode in ("bucketed", "legacy"):
        eng = ServeEngine(cfg, tp, device="cpu", max_batch=3, cache_len=96,
                          enable_smartconf=False, prefill_mode=mode)
        eng.prefill_chunk = 16
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, MAX_NEW))
        calls = 0
        while len(eng.finished) < len(prompts):
            st = eng.tick()
            new_calls = eng.prefill_calls - calls
            calls = eng.prefill_calls
            decoded = st["decode_tokens"] > 0
            assert st["dispatches"] == new_calls + decoded
            assert new_calls <= (1 if mode == "bucketed" else 3)
        if mode == "bucketed":
            assert eng._prefill_shapes == {16}
            assert eng.model_programs == 2
        else:
            assert eng.prefill_calls == len(prompts)
            assert eng._prefill_shapes == set(lens)
            assert eng.model_programs == len(set(lens)) + 1
            assert eng.pad_fraction == 0.0
        assert not eng.paged if mode == "legacy" else eng.paged
        eng.close()
