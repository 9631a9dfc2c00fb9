"""The port's model against the JAX package, on the CPU (plain kernels).

Layers (norms, RoPE, MLPs, attention over positioned keys) and the two
serve-path steps — ``step_packed`` over one packed stream of prefill
chunks plus length-1 decode segments, then ``decode_step`` — at
``reduced()`` sizes in f32: paged KV for the four attention-only, non-MoE
archs (block tables out of order), dense per-slot rings for the same four
and for the hybrid recurrentgemma (rings that wrap, RG-LRU scan state),
and per-slot WKV state for the all-recurrent rwkv6-7b.
Weights and caches are the JAX package's, carried across with
``params_from_numpy``.  Logits and caches after each step must agree to
``atol=1e-4`` (recurrentgemma's logits to ``atol=1e-4, rtol=1e-5``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as jl
from repro.models import zoo as jzoo
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as tl
from repro_torch.models import zoo
from repro_torch.models.bridge import params_from_numpy

ARCHS = ["yi-6b", "h2o-danube-3-4b", "gemma3-4b", "starcoder2-15b"]
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms_match_jax(rng, kind, dtype):
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3
    scale = rng.standard_normal(24).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = {"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias, jdt)}
    tp = {"scale": torch.from_numpy(scale).to(tdt),
          "bias": torch.from_numpy(bias).to(tdt)}
    want = jl.apply_norm(kind, jp, jnp.asarray(x, jdt)).astype(jnp.float32)
    got = tl.apply_norm(kind, tp, torch.from_numpy(x).to(tdt)).float()
    # bf16: both cast the normalised value to bf16 before the scale, so
    # they agree to the last bit but for rounding ties in the scale product
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
def test_rope_matches_jax(rng, theta):
    x = rng.standard_normal((1, 9, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 2000, (1, 9)).astype(np.int32)
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(rng, kind):
    d, f = 16, 40
    names = ["w_up", "w_down"] if kind == "gelu" else \
        ["w_gate", "w_up", "w_down"]
    w = {n: (rng.standard_normal((f, d) if n == "w_down" else (d, f))
             .astype(np.float32) / 4) for n in names}
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    want = jl.mlp({n: jnp.asarray(a) for n, a in w.items()}, jnp.asarray(x),
                  kind)
    got = tl.mlp({n: torch.from_numpy(a) for n, a in w.items()},
                 torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_attn_output_matches_jax(rng):
    o = rng.standard_normal((1, 5, 4, 8)).astype(np.float32)
    wo = rng.standard_normal((4, 8, 12)).astype(np.float32)
    want = jl.attn_output({"wo": jnp.asarray(wo)}, jnp.asarray(o))
    got = tl.attn_output({"wo": torch.from_numpy(wo)}, torch.from_numpy(o))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------------ init
def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_jax_layout(arch):
    """Same tree, same shapes, same dtype: the bridge needs no
    transposes, and the port's own init draws the same distribution."""
    params, _ = jzoo.init(jax_reduced(jax_get_config(arch)),
                          jax.random.key(0))
    cfg = reduced(get_config(arch))
    mine = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(mine) == _shapes(params)
    wq = mine["groups"][0]["attn"]["wq"]
    bound = 1 / np.sqrt(wq.shape[-2])     # the reference's fan_in axis
    assert wq.dtype == torch.float32
    assert float(wq.abs().max()) <= bound
    assert float(wq.std()) == pytest.approx(bound / np.sqrt(3), rel=0.1)


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = reduced(get_config("yi-6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.init(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-tiny",
                                  "deepseek-moe-16b"])
def test_unported_block_kinds_raise(arch):
    cfg = reduced(get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")


# ------------------------------------------------------------ the steps
def _stream(rng, cfg, segs, width, b):
    tokens = np.zeros((1, width), np.int32)
    slot = np.full(width, -1, np.int32)
    pos = np.zeros(width, np.int32)
    start = np.zeros(b, np.int32)
    seg_len = np.zeros(b, np.int32)
    c = 0
    for s, st, n in segs:
        tokens[0, c:c + n] = rng.integers(0, cfg.vocab_size, n)
        slot[c:c + n] = s
        pos[c:c + n] = np.arange(st, st + n)
        start[s], seg_len[s] = st, n
        c += n
    return tokens, slot, pos, start, seg_len


def _assert_stores(jc, tc):
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_match_jax(arch):
    """Two packed ticks (prefill chunks, then chunks beside decode
    riders), then a decode step with one inactive row; logits at every
    slot that ran, and every block store, after each step."""
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    params, _ = jzoo.init(jcfg, jax.random.key(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(0)
    b, t, m = 3, 8, 8
    n = b * m + 4
    tables = rng.permutation(n)[:b * m].astype(np.int32).reshape(b, m)
    jc = jzoo.init_paged_cache(jcfg, n, t)
    tc = zoo.init_paged_cache(cfg, n, t, "cpu")
    bt_j, bt_t = jnp.asarray(tables), torch.from_numpy(tables)
    ticks = [[(0, 0, 13), (1, 0, 30), (2, 0, 4)],
             [(1, 30, 1), (0, 13, 20), (2, 4, 1)]]
    for segs in ticks:
        arrays = _stream(rng, cfg, segs, 64, b)
        jl_, jc = jzoo.step_packed(jcfg, params, jc,
                                   *map(jnp.asarray, arrays),
                                   block_tables=bt_j)
        tl_ = zoo.step_packed(cfg, tp, tc, *map(torch.from_numpy, arrays),
                              bt_t)
        np.testing.assert_allclose(_np(tl_), np.asarray(jl_), atol=ATOL,
                                   rtol=0)
        _assert_stores(jc, tc)
    tok = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
    pos = np.array([33, 31, 5], np.int32)
    active = np.array([True, False, True])
    jl_, jc = jzoo.decode_step(jcfg, params, jc, jnp.asarray(tok),
                               jnp.asarray(pos), active=jnp.asarray(active),
                               block_tables=bt_j)
    tl_ = zoo.decode_step(cfg, tp, tc, torch.from_numpy(tok),
                          torch.from_numpy(pos), bt_t,
                          active=torch.from_numpy(active))
    np.testing.assert_allclose(_np(tl_)[active], np.asarray(jl_)[active],
                               atol=ATOL, rtol=0)
    _assert_stores(jc, tc)


def test_store_resize_and_block_copy_match_jax(rng):
    """map_paged_caches (the physical budget resize) and copy_paged_blocks
    (copy-on-write) on stacked and unstacked stores."""
    jcfg = jax_reduced(jax_get_config("gemma3-4b"))
    cfg = reduced(get_config("gemma3-4b"))
    jc = jzoo.init_paged_cache(jcfg, 6, 4)
    jc = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), jc)
    tc = params_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    src, dst = np.array([0, 4], np.int32), np.array([5, 1], np.int32)
    jc = jzoo.copy_paged_blocks(jc, jnp.asarray(src), jnp.asarray(dst))
    zoo.copy_paged_blocks(tc, torch.from_numpy(src).long(),
                          torch.from_numpy(dst).long())
    _assert_stores(jc, tc)
    keep = np.array([5, 0, 2], np.int32)
    jc = jzoo.map_paged_caches(jc, lambda a, ax: jnp.take(a, keep, axis=ax))
    tc = zoo.map_paged_caches(
        tc, lambda a, ax: a.index_select(ax, torch.from_numpy(keep).long()))
    _assert_stores(jc, tc)


# ------------------------------------------------- dense rings, recurrent
def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("h,kv,window", [(4, 1, 0), (4, 2, 6)])
def test_chunk_and_decode_attention_match_jax(rng, h, kv, window):
    """Positioned keys with unwritten (-1) and future entries; decode is
    the one-query case."""
    q = rng.standard_normal((2, 5, h, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, kv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, kv, 16)).astype(np.float32)
    k_pos = rng.integers(-1, 12, (2, 9)).astype(np.int32)
    q_pos = np.array([[3, 4, 5, 6, 7], [7, 8, 9, 10, 11]], np.int32)
    want = jl.chunk_attention(*map(jnp.asarray, (q, k, v)),
                              k_pos=jnp.asarray(k_pos),
                              q_pos=jnp.asarray(q_pos), window=window)
    got = tl.chunk_attention(*map(torch.from_numpy, (q, k, v)),
                             k_pos=torch.from_numpy(k_pos),
                             q_pos=torch.from_numpy(q_pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    want = jl.decode_attention(*map(jnp.asarray, (q[:, :1], k, v)),
                               k_pos=jnp.asarray(k_pos),
                               q_pos=jnp.asarray(q_pos[:, 0]), window=window)
    got = tl.decode_attention(*map(torch.from_numpy, (q[:, :1], k, v)),
                              k_pos=torch.from_numpy(k_pos),
                              q_pos=torch.from_numpy(q_pos[:, 0]),
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_recurrent_init_has_the_jax_layout():
    """recurrentgemma's hybrid plan (groups of rglru, rglru, swa and a
    2-layer rglru remainder) with the reference's dtypes: ba, bx and lam
    stay f32 in a bf16 model, and the bridge keeps them so."""
    jcfg = jax_reduced(jax_get_config("recurrentgemma-9b"), num_layers=5,
                       dtype="bfloat16")
    params, _ = jzoo.init(jcfg, jax.random.key(0))
    cfg = reduced(get_config("recurrentgemma-9b"), num_layers=5,
                  dtype="bfloat16")
    mine = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    bridged = params_from_numpy(_np_tree(params), "cpu")

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [layout(v) for v in tree]
        return tuple(tree.shape), str(tree.dtype).split(".")[-1]

    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), params)
    assert layout(mine) == layout(bridged) == want
    assert len(mine["groups"]) == 3 and len(mine["rem"]) == 2
    for name in ("ba", "bx", "lam"):
        assert mine["rem"][0]["rglru"][name].dtype == torch.float32
    assert mine["rem"][0]["rglru"]["wa"].dtype == torch.bfloat16
    assert float(mine["groups"][0]["rglru"]["lam"].min()) == 3.0


def _dense_ticks(cfg, jcfg, params, tp, ticks, b=3, cache_len=96):
    """Packed ticks then a decode step with one inactive row, JAX and port
    side by side on dense caches; asserts logits and caches after each."""
    jc = jzoo.init_cache(jcfg, b, cache_len)
    tc = zoo.init_cache(cfg, b, cache_len, "cpu")
    rng = np.random.default_rng(0)
    for segs in ticks:
        arrays = _stream(rng, cfg, segs, 64, b)
        jl_, jc = jzoo.step_packed(jcfg, params, jc,
                                   *map(jnp.asarray, arrays))
        tl_ = zoo.step_packed(cfg, tp, tc, *map(torch.from_numpy, arrays))
        used = sorted({s for s, _, _ in segs})
        np.testing.assert_allclose(_np(tl_)[used], np.asarray(jl_)[used],
                                   atol=ATOL, rtol=1e-5)
        _assert_stores(jc, tc)
    last = {s: st + n for segs in ticks for s, st, n in segs}
    tok = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
    pos = np.array([last[s] for s in range(b)], np.int32)
    active = np.array([True, False, True])
    jl_, jc = jzoo.decode_step(jcfg, params, jc, jnp.asarray(tok),
                               jnp.asarray(pos), active=jnp.asarray(active))
    tl_ = zoo.decode_step(cfg, tp, tc, torch.from_numpy(tok),
                          torch.from_numpy(pos),
                          active=torch.from_numpy(active))
    np.testing.assert_allclose(_np(tl_)[active], np.asarray(jl_)[active],
                               atol=ATOL, rtol=1e-5)
    _assert_stores(jc, tc)
    return tc


@pytest.mark.parametrize("arch", ARCHS + ["recurrentgemma-9b", "rwkv6-7b"])
def test_dense_steps_match_jax(arch):
    """Dense rings: a 40-token prompt wraps the windowed rings (window 32
    reduced), chunks ride beside decode segments, a third tick restarts
    slot 2 at position 0 over its own earlier entries (stale), then a
    decode step with one inactive row.  recurrentgemma runs 5 layers: one
    (rglru, rglru, swa) group and the 2-layer remainder.  rwkv6-7b (no
    rings: WKV state and token shifts only) runs at d 128, two heads;
    plain ``reduced()`` gives it one."""
    extra = {"recurrentgemma-9b": {"num_layers": 5},
             "rwkv6-7b": {"d_model": 128}}.get(arch, {})
    jcfg = jax_reduced(jax_get_config(arch), **extra)
    cfg = reduced(get_config(arch), **extra)
    params, _ = jzoo.init(jcfg, jax.random.key(1))
    tp = params_from_numpy(_np_tree(params), "cpu")
    _dense_ticks(cfg, jcfg, params, tp,
                 [[(0, 0, 13), (1, 0, 40), (2, 0, 4)],
                  [(1, 40, 1), (0, 13, 30), (2, 4, 1)],
                  [(0, 43, 1), (1, 41, 1), (2, 0, 7)]])


def test_packed_segment_restart_resets_recurrent_state():
    """A segment starting at position 0 in a reused slot begins from zero
    scan state and ignores the earlier occupant's ring: its logits equal
    a fresh cache's, and the JAX package's on a fresh cache."""
    arch = "recurrentgemma-9b"
    jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    params, _ = jzoo.init(jcfg, jax.random.key(1))
    tp = params_from_numpy(_np_tree(params), "cpu")
    rng = np.random.default_rng(4)
    first = _stream(rng, cfg, [(0, 0, 21)], 32, 1)
    second = _stream(rng, cfg, [(0, 0, 17)], 32, 1)
    reused = zoo.init_cache(cfg, 1, 64, "cpu")
    zoo.step_packed(cfg, tp, reused, *map(torch.from_numpy, first))
    got = zoo.step_packed(cfg, tp, reused, *map(torch.from_numpy, second))
    fresh = zoo.step_packed(cfg, tp, zoo.init_cache(cfg, 1, 64, "cpu"),
                            *map(torch.from_numpy, second))
    want, _ = jzoo.step_packed(jcfg, params, jzoo.init_cache(jcfg, 1, 64),
                               *map(jnp.asarray, second))
    np.testing.assert_allclose(_np(got), _np(fresh), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=1e-5)
