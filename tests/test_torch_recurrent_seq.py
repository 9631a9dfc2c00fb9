"""The recurrent one-shot forms against the JAX package, on the CPU.

``rglru_block`` (recurrentgemma's RG-LRU over a whole sequence, a doubling
scan where the reference runs ``associative_scan``) and
``time_mix_chunked`` (rwkv6's chunked closed form, a loop over chunks where
the reference runs ``lax.scan``) take the same numpy inputs and the JAX
package's own weights, bridged: outputs, carried state and f32 gradients
with respect to every parameter and the input.  ``reduced()`` configs;
rwkv6 at ``d_model=128`` (two heads), with a random bonus ``u``, decay
base ``w0`` and token-shift mixes, and the RG-LRU with random gate biases
and ``lam``, so that every term carries weight.

Lengths: the RG-LRU at 1, 2 and 5 (shorter than, equal to and longer
than its conv window's carry), 37 and 64, from a nonzero carried ``h`` and
conv window.  The time mix at every length where the reference's
``assert L * n_chunks == s`` holds (1, 31, 32, 48, 66, 96, 128); at 97
and 130, where it fails, the port cuts a remainder chunk and is held to
its own packed form (``time_mix_chunk`` with every token valid) and to a
loop of ``time_mix_step``.  Two calls that thread the state equal one.

Tolerances: outputs and state within ``atol=rtol=1e-5`` (f32; both sides
combine in other trees and orders, so results agree to f32 rounding, not
bit for bit); gradients within ``2e-5`` of each leaf's largest magnitude.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv6 as rwkv6_lib
from repro_torch.models.bridge import params_from_numpy

ATOL = RTOL = 1e-5
GRAD_REL = 2e-5
RGLRU_LENS = (1, 2, 5, 37, 64)
# every length at which the reference's max(1, s // 32) chunks divide s
REFERENCE_LENS = (1, 31, 32, 48, 66, 96, 128)
# lengths the reference rejects: the port's remainder chunk
REMAINDER_LENS = (97, 130)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", False)
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.models import rglru as jrglru
    from repro.models import rwkv6 as jrwkv6
    return jax, jax.numpy, jget, jreduced, jrglru, jrwkv6


def _np(t):
    return t.detach().numpy()


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        err = np.abs(_np(g) - w).max()
        assert err <= GRAD_REL * max(np.abs(w).max(), 1e-30), (name, err)


# ------------------------------------------------------------------ RG-LRU
def _rglru(jx, seed=0):
    jax, jnp, jget, jreduced, jrglru, _ = jx
    cfg = reduced(get_config("recurrentgemma-9b"))
    jp, _ = jrglru.rglru_init(jax.random.key(seed),
                              jreduced(jget("recurrentgemma-9b")))
    rng = np.random.default_rng(seed)
    for name, lo, hi in (("ba", -1, 1), ("bx", -1, 1), ("lam", -1, 4)):
        jp[name] = jnp.asarray(rng.uniform(lo, hi, jp[name].shape),
                               jnp.float32)
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _rglru_inputs(cfg, s, seed=1, b=2):
    rng = np.random.default_rng(seed)
    dr = cfg.num_heads * cfg.resolved_head_dim
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    h = rng.standard_normal((b, dr)).astype(np.float32)
    conv = rng.standard_normal((b, rglru_lib.CONV_WIDTH - 1, dr)).astype(
        np.float32)
    return x, {"h": h, "conv": conv}


@pytest.mark.parametrize("s", RGLRU_LENS)
def test_rglru_block_matches_jax(jx, s):
    """y, h and the conv window after the sequence, from a nonzero carried
    state: at S < W - 1 the new window still holds carried entries."""
    jnp, jrglru = jx[1], jx[4]
    cfg, jp, tp = _rglru(jx)
    x, st = _rglru_inputs(cfg, s)
    wy, wst = jrglru.rglru_block(jp, jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in st.items()})
    y, new = rglru_lib.rglru_block(tp, torch.from_numpy(x),
                                   {k: torch.from_numpy(v)
                                    for k, v in st.items()})
    _close(y, wy)
    _close(new["h"], wst["h"])
    _close(new["conv"], wst["conv"])
    assert new["h"].dtype == torch.float32


def test_rglru_block_threads_its_state(jx):
    """Two calls (23 then 18 steps) carrying h and the conv window equal
    one call over all 41."""
    cfg, _, tp = _rglru(jx)
    x, st = _rglru_inputs(cfg, 41)
    x = torch.from_numpy(x)
    st = {k: torch.from_numpy(v) for k, v in st.items()}
    y, one = rglru_lib.rglru_block(tp, x, st)
    y1, mid = rglru_lib.rglru_block(tp, x[:, :23], st)
    y2, two = rglru_lib.rglru_block(tp, x[:, 23:], mid)
    _close(torch.cat([y1, y2], dim=1), _np(y))
    for k in one:
        _close(two[k], _np(one[k]))


def test_rglru_block_matches_the_chunk_form(jx):
    """The one-shot form against the port's padded-chunk form with every
    token valid (the plain scan, one step at a time)."""
    cfg, _, tp = _rglru(jx)
    x, st = _rglru_inputs(cfg, 37)
    x = torch.from_numpy(x)
    st = {k: torch.from_numpy(v) for k, v in st.items()}
    y, new = rglru_lib.rglru_block(tp, x, st)
    yc, newc = rglru_lib.rglru_chunk(tp, x, st, torch.ones(x.shape[:2],
                                                           dtype=torch.bool))
    _close(y, _np(yc))
    for k in new:
        _close(new[k], _np(newc[k]))


def test_rglru_block_grads_match_jax(jx):
    """f32 gradients of a random projection of y and of the new state,
    with respect to every parameter and x, against ``jax.grad``."""
    jax, jnp, _, _, jrglru, _ = jx
    cfg, jp, tp = _rglru(jx)
    x, st = _rglru_inputs(cfg, 37)
    rng = np.random.default_rng(5)
    wy = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    wh = rng.standard_normal(st["h"].shape).astype(np.float32)
    wc = rng.standard_normal(st["conv"].shape).astype(np.float32)
    jst = {k: jnp.asarray(v) for k, v in st.items()}

    def jloss(p, xx):
        y, new = jrglru.rglru_block(p, xx, jst)
        return ((y * wy).sum() + (new["h"] * wh).sum()
                + (new["conv"] * wc).sum())

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, new = rglru_lib.rglru_block(tp, xt, {k: torch.from_numpy(v)
                                            for k, v in st.items()})
    loss = ((y * torch.from_numpy(wy)).sum()
            + (new["h"] * torch.from_numpy(wh)).sum()
            + (new["conv"] * torch.from_numpy(wc)).sum())
    loss.backward()
    _grads_close({k: v.grad for k, v in tp.items()}, jgp)
    _grads_close({"x": xt.grad}, {"x": jgx})


# ------------------------------------------------------------------ RWKV-6
def _rwkv6(jx, seed=0, w0=(-3, 1)):
    jax, jnp, jget, jreduced, _, jrwkv6 = jx
    cfg = reduced(get_config("rwkv6-7b"), d_model=128)
    jp, _ = jrwkv6.rwkv6_init(jax.random.key(seed),
                              jreduced(jget("rwkv6-7b"), d_model=128))
    rng = np.random.default_rng(seed)
    jp["u"] = jnp.asarray(rng.standard_normal(jp["u"].shape) * 0.5,
                          jnp.float32)
    jp["w0"] = jnp.asarray(rng.uniform(*w0, jp["w0"].shape), jnp.float32)
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "cm_mu"):
        jp[name] = jnp.asarray(rng.uniform(0, 1, jp[name].shape),
                               jp[name].dtype)
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _rwkv6_inputs(cfg, s, seed=1, b=2):
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    state = rng.standard_normal((b, d // 64, 64, 64)).astype(np.float32)
    x_last = rng.standard_normal((b, d)).astype(np.float32)
    return x, state, x_last


def _time_mix(tp, x, state, x_last):
    return rwkv6_lib.time_mix_chunked(tp, *map(torch.from_numpy,
                                               (x, state, x_last)))


@pytest.mark.parametrize("s", REFERENCE_LENS)
def test_time_mix_chunked_matches_jax(jx, s):
    """y, S' and x_last' at every length the reference accepts."""
    jnp, jrwkv6 = jx[1], jx[5]
    cfg, jp, tp = _rwkv6(jx)
    x, state, x_last = _rwkv6_inputs(cfg, s)
    wy, ws, wl = jrwkv6.time_mix_chunked(jp, *map(jnp.asarray,
                                                  (x, state, x_last)))
    y, s_new, last = _time_mix(tp, x, state, x_last)
    _close(y, wy)
    _close(s_new, ws)
    _close(last, wl, atol=0, rtol=0)
    assert s_new.dtype == torch.float32


def test_chunk_lengths_follow_the_reference_where_it_runs():
    """The reference's split wherever ``L * n_chunks == s``, and a
    remainder chunk where it asserts."""
    for s in REFERENCE_LENS:
        n = max(1, s // rwkv6_lib.CHUNK)
        assert rwkv6_lib.chunk_lengths(s) == [s // n] * n
    assert rwkv6_lib.chunk_lengths(97) == [32, 32, 32, 1]
    assert rwkv6_lib.chunk_lengths(130) == [32, 32, 32, 32, 2]
    assert all(sum(rwkv6_lib.chunk_lengths(s)) == s for s in range(1, 300))


@pytest.mark.parametrize("s", REMAINDER_LENS)
def test_time_mix_chunked_at_lengths_the_reference_rejects(jx, s):
    """At lengths the reference's assert rejects, the port's remainder
    chunk against its own packed form (``time_mix_chunk``, every token
    valid) and against a loop of ``time_mix_step``."""
    jnp, jrwkv6 = jx[1], jx[5]
    cfg, jp, tp = _rwkv6(jx)
    x, state, x_last = _rwkv6_inputs(cfg, s)
    with pytest.raises(AssertionError, match="not divisible"):
        jrwkv6.time_mix_chunked(jp, *map(jnp.asarray, (x, state, x_last)))
    y, s_new, last = _time_mix(tp, x, state, x_last)
    xt, st, lt = map(torch.from_numpy, (x, state, x_last))
    yc, sc, lc = rwkv6_lib.time_mix_chunk(
        tp, xt, st, lt, torch.ones(x.shape[:2], dtype=torch.bool))
    _close(y, _np(yc))
    _close(s_new, _np(sc))
    _close(last, _np(lc), atol=0, rtol=0)
    ys = []
    for t in range(s):
        yt, st, lt = rwkv6_lib.time_mix_step(tp, xt[:, t], st, lt)
        ys.append(yt)
    _close(y, _np(torch.stack(ys, dim=1)))
    _close(s_new, _np(st))


@pytest.mark.parametrize("cut", [17, 64])
def test_time_mix_chunked_threads_its_state(jx, cut):
    """Two calls carrying S and x_last equal one call over 97 steps (the
    chunks fall elsewhere, so to f32 rounding)."""
    cfg, _, tp = _rwkv6(jx)
    x, state, x_last = _rwkv6_inputs(cfg, 97)
    y, s_one, l_one = _time_mix(tp, x, state, x_last)
    y1, s_mid, l_mid = _time_mix(tp, x[:, :cut], state, x_last)
    y2, s_two, l_two = rwkv6_lib.time_mix_chunked(
        tp, torch.from_numpy(x[:, cut:]), s_mid, l_mid)
    _close(torch.cat([y1, y2], dim=1), _np(y))
    _close(s_two, _np(s_one))
    _close(l_two, _np(l_one), atol=0, rtol=0)


def _time_mix_grads(jx, jp, tp, cfg, s):
    """Gradients of a random projection of y and S' with respect to every
    parameter, x, the carried S and x_last: (JAX's, the port's), the
    port's without the channel mix's weights, which take no part."""
    jax, jnp, _, _, _, jrwkv6 = jx
    x, state, x_last = _rwkv6_inputs(cfg, s)
    rng = np.random.default_rng(6)
    wy = rng.standard_normal(x.shape).astype(np.float32)
    ws = rng.standard_normal(state.shape).astype(np.float32)

    def jloss(p, xx, ss, ll):
        y, s_new, _ = jrwkv6.time_mix_chunked(p, xx, ss, ll)
        return (y * wy).sum() + (s_new * ws).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jp, *map(jnp.asarray, (x, state, x_last)))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, state, x_last)]
    y, s_new, _ = rwkv6_lib.time_mix_chunked(tp, *ins)
    ((y * torch.from_numpy(wy)).sum()
     + (s_new * torch.from_numpy(ws)).sum()).backward()
    got = {k: v.grad for k, v in tp.items() if v.grad is not None}
    assert set(got) == set(tp) - {"cm_mu", "cm_k", "cm_v"}
    got.update(zip(("x", "S", "x_last"), (t.grad for t in ins)))
    want = {k: jg[0][k] for k in tp}
    want.update(zip(("x", "S", "x_last"), jg[1:]))
    return {k: want[k] for k in got}, got


@pytest.mark.parametrize("s", [48, 66])
def test_time_mix_chunked_grads_match_jax(jx, s):
    """f32 gradients against ``jax.grad`` (one chunk of 48; two of 33), at
    decays whose sums over a chunk stay inside f32's exp range (w0 in
    [-3, -1])."""
    cfg, jp, tp = _rwkv6(jx, w0=(-3, -1))
    want, got = _time_mix_grads(jx, jp, tp, cfg, s)
    _grads_close(got, want)


def test_time_mix_chunked_grads_stay_finite_at_strong_decays(jx):
    """Where a chunk's decays sum past f32's exp range (w0 up to 1), the
    reference's gradient is NaN: its ``where`` drops exp's inf above the
    diagonal in the forward pass only.  The port masks the exponent
    before exp, so its gradient is finite; the forward values are the
    same (``test_time_mix_chunked_matches_jax``)."""
    cfg, jp, tp = _rwkv6(jx)
    want, got = _time_mix_grads(jx, jp, tp, cfg, 48)
    assert any(np.isnan(np.asarray(w)).any() for w in want.values())
    assert all(torch.isfinite(g).all() for g in got.values())
