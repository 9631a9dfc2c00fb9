"""The port's RWKV-6 family against the JAX package.

The scan's plain version (what a CPU tensor runs) is held against the JAX
oracle and the JAX Pallas kernel in interpret mode on the same numpy
inputs, from a random non-symmetric carried state (a transposed state
would pass from a zero or symmetric one), with decays drawn as the
reference's own kernel tests draw them, strong decays, ``logw = 0`` pad
lanes, odd lengths, and state threaded across a chunk boundary.  The
model's ``time_mix_chunk`` / ``channel_mix_chunk`` (ragged rows, one
empty, over a carried state) and the one-token ``time_mix_step`` /
``channel_mix`` are held against the JAX package's with its own weights,
at ``d_model=128`` (two heads: plain ``reduced()`` leaves rwkv6 with one,
which cannot show a head-order fault), with a random bonus ``u`` and
decay base ``w0`` set on the JAX tree before bridging.

Tolerances: the scan as the reference's kernel tests hold it, f32
``atol=rtol=1e-4`` and ``5e-2`` for bf16 inputs (both sides run the same
f32 recurrence in another summation order); the model pieces
``atol=rtol=1e-5`` on f32 weights.

Tests marked ``cuda`` hold the CUDA kernel against the plain version on
the card and skip where there is none:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_rwkv6.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6 import (rwkv6_op, rwkv6_ref, rwkv6_ref_state,
                                       rwkv6_scan, rwkv6_scan_state,
                                       rwkv6_state_op)
from repro_torch.kernels.rwkv6.rwkv6 import (CHUNK, STAGES, THREADS,
                                             copy_bytes, smem_bytes)

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
MODEL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def jx():
    """The JAX package's RWKV-6 oracle, Pallas kernel and model module."""
    jnp = pytest.importorskip("jax.numpy")
    import jax
    from repro.kernels import rwkv6 as kernels
    from repro.models import rwkv6 as model
    return jax, jnp, kernels, model


def scan_case(rng, bh, s, n, decay="model"):
    """r, k, v, logw, u and a random non-symmetric s0, all f32.  ``decay``:
    ``model`` draws logw = -exp(N(0, 1) - 1) as the reference's kernel
    tests do; ``strong`` reaches down to -e^2; ``pads`` zeroes a third of
    the steps' logw, r and k, as ``time_mix_chunk`` does at pad lanes."""
    r, k, v = (rng.standard_normal((bh, s, n)).astype(np.float32) * 0.5
               for _ in range(3))
    z = rng.standard_normal((bh, s, n))
    if decay == "strong":
        z = np.clip(z + 2.0, None, 3.0)
    logw = -np.exp(z - 1.0).astype(np.float32)
    if decay == "pads":
        pad = rng.random((bh, s, 1)) < 1 / 3
        logw, r, k = (np.where(pad, 0.0, a).astype(np.float32)
                      for a in (logw, r, k))
    u = rng.standard_normal((bh, n)).astype(np.float32) * 0.3
    s0 = rng.standard_normal((bh, n, n)).astype(np.float32)
    return r, k, v, logw, u, s0


def t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# -------------------------------------------------------------- the scan
@pytest.mark.parametrize("bh,s,n", [(4, 64, 64), (2, 128, 64), (3, 96, 32),
                                    (1, 32, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_plain_matches_jax(jx, bh, s, n, dtype):
    """The reference's kernel-test shapes and tolerances, from a random
    s0: outputs and the final state against the JAX oracle and the Pallas
    kernel in interpret mode."""
    _, jnp, kernels, _ = jx
    r, k, v, logw, u, s0 = scan_case(np.random.default_rng(s + n), bh, s,
                                     n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = ([jnp.asarray(a, jdt) for a in (r, k, v)]
             + [jnp.asarray(a) for a in (logw, u, s0)])
    targs = ([a.to(tdt) for a in t(r, k, v)] + t(logw, u, s0))
    got_y, got_s = rwkv6_state_op(*targs)
    assert got_y.dtype == tdt and got_s.dtype == torch.float32
    for y, s_out in (kernels.rwkv6_ref_state(*jargs),
                     kernels.rwkv6_scan_state(*jargs, interpret=True)):
        _close(got_y.float().numpy(), y, TOL[dtype])
        _close(got_s.numpy(), s_out, TOL[dtype])
    _close(rwkv6_op(*targs[:5]).float().numpy(),
           kernels.rwkv6_ref(*jargs[:5]), TOL[dtype])


@pytest.mark.parametrize("s,decay", [(1, "model"), (7, "model"),
                                     (33, "model"), (40, "strong"),
                                     (40, "pads")])
def test_scan_plain_matches_jax_at_odd_lengths_and_decays(jx, s, decay):
    _, jnp, kernels, _ = jx
    args = scan_case(np.random.default_rng(s), 3, s, 64, decay)
    got_y, got_s = rwkv6_state_op(*t(*args))
    y, s_out = kernels.rwkv6_ref_state(*map(jnp.asarray, args))
    _close(got_y.numpy(), y, TOL["float32"])
    _close(got_s.numpy(), s_out, TOL["float32"])


@pytest.mark.parametrize("cut", [32, 19])
def test_scan_state_threads_across_a_chunk_boundary(jx, cut):
    """Two calls split at ``cut`` with the state carried between them give
    the one-shot run, outputs and final state alike (the scan-state ABI),
    also at a cut that is not a multiple of the reference's 32-step
    chunk."""
    _, jnp, kernels, _ = jx
    r, k, v, logw, u, s0 = scan_case(np.random.default_rng(cut), 2, 64, 64)
    first = [a[:, :cut] for a in (r, k, v, logw)]
    rest = [a[:, cut:] for a in (r, k, v, logw)]
    y1, s1 = rwkv6_state_op(*t(*first, u, s0))
    y2, s2 = rwkv6_state_op(*t(*rest, u), s1)
    want_y, want_s = kernels.rwkv6_ref_state(
        *map(jnp.asarray, (r, k, v, logw, u, s0)))
    _close(torch.cat([y1, y2], 1).numpy(), want_y, TOL["float32"])
    _close(s2.numpy(), want_s, TOL["float32"])


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    args = t(*scan_case(np.random.default_rng(0), 2, 5, 64))
    before = rwkv6_scan_state.launches
    got = rwkv6_state_op(*args)
    want = rwkv6_ref_state(*args)
    assert rwkv6_scan_state.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    torch.testing.assert_close(rwkv6_op(*args[:5]), rwkv6_ref(*args[:5]),
                               atol=0, rtol=0)


@pytest.mark.parametrize("wrapper,nargs", [(rwkv6_scan_state, 6),
                                           (rwkv6_scan, 5)])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper, nargs):
    args = t(*scan_case(np.random.default_rng(0), 2, 5, 64))[:nargs]
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args)


# ------------------------------------------------------------- the model
def _block(jx, seed=0, dtype="float32"):
    """The JAX package's rwkv6 weights at d 128 (two heads) on both sides,
    with a random bonus u and a spread of decay bases w0 in place of the
    constant initial ones."""
    jax, jnp, _, model = jx
    from repro.configs import get_config, reduced
    from repro_torch.models.bridge import params_from_numpy
    cfg = reduced(get_config("rwkv6-7b"), d_model=128, dtype=dtype)
    jp, _ = model.rwkv6_init(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    jp["u"] = jnp.asarray(rng.standard_normal(jp["u"].shape) * 0.5,
                          jnp.float32)
    jp["w0"] = jnp.asarray(rng.uniform(-3, 1, jp["w0"].shape), jnp.float32)
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "cm_mu"):
        jp[name] = jnp.asarray(rng.uniform(0, 1, jp[name].shape),
                               jp[name].dtype)
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _chunk_inputs(rng, b, c, d):
    x = rng.standard_normal((b, c, d)).astype(np.float32)
    valid = np.arange(c)[None, :] < np.array([0, c, 5, 1])[:b, None]
    state = rng.standard_normal((b, d // 64, 64, 64)).astype(np.float32)
    tm_last, cm_last = (rng.standard_normal((b, d)).astype(np.float32)
                        for _ in range(2))
    return x, valid, state, tm_last, cm_last


@pytest.mark.parametrize("c", [11, 32])
def test_time_and_channel_mix_chunk_match_jax(jx, c):
    """Ragged rows (one empty, one full, two partial) from a nonzero
    carried state; the reference pads time to its 32-step kernel chunk,
    the port does not (c = 11), and both give the same results."""
    _, jnp, _, model = jx
    from repro_torch.models import rwkv6 as tr
    cfg, jp, tp = _block(jx)
    x, valid, state, tm_last, cm_last = _chunk_inputs(
        np.random.default_rng(c), 4, c, cfg.d_model)
    wy, ws, wl = model.time_mix_chunk(jp, *map(jnp.asarray, (
        x, state, tm_last, valid)))
    gy, gs, gl = tr.time_mix_chunk(tp, *t(x, state, tm_last, valid))
    for got, want in ((gy, wy), (gs, ws), (gl, wl)):
        _close(got.numpy(), want, MODEL_TOL)
    # the empty row's state passes through unchanged, bit for bit
    assert (gs[0].numpy() == state[0]).all()
    assert (gl[0].numpy() == tm_last[0]).all()
    wo, wc = model.channel_mix_chunk(jp, *map(jnp.asarray, (
        x, cm_last, valid)))
    go, gc = tr.channel_mix_chunk(tp, *t(x, cm_last, valid))
    _close(go.numpy(), wo, MODEL_TOL)
    _close(gc.numpy(), wc, MODEL_TOL)
    assert (gc[0].numpy() == cm_last[0]).all()


def test_time_and_channel_mix_step_match_jax(jx):
    _, jnp, _, model = jx
    from repro_torch.models import rwkv6 as tr
    cfg, jp, tp = _block(jx, seed=2)
    rng = np.random.default_rng(2)
    d = cfg.d_model
    x = rng.standard_normal((3, d)).astype(np.float32)
    state = rng.standard_normal((3, d // 64, 64, 64)).astype(np.float32)
    last = rng.standard_normal((3, d)).astype(np.float32)
    wy, ws, wl = model.time_mix_step(jp, *map(jnp.asarray, (x, state, last)))
    gy, gs, gl = tr.time_mix_step(tp, *t(x, state, last))
    for got, want in ((gy, wy), (gs, ws), (gl, wl)):
        _close(got.numpy(), want, MODEL_TOL)
    wo, wc = model.channel_mix(jp, *map(jnp.asarray, (x, last)))
    go, gc = tr.channel_mix(tp, *t(x, last))
    _close(go.numpy(), wo, MODEL_TOL)
    _close(gc.numpy(), wc, MODEL_TOL)


def test_chunk_then_steps_equal_one_longer_chunk(jx):
    """Scan-state ABI at the block level: one chunk then decode steps
    through the state each returns gives the one-chunk run's outputs."""
    from repro_torch.models import rwkv6 as tr
    cfg, _, tp = _block(jx, seed=3)
    rng = np.random.default_rng(3)
    d = cfg.d_model
    x = torch.from_numpy(rng.standard_normal((2, 9, d)).astype(np.float32))
    state = torch.from_numpy(
        rng.standard_normal((2, d // 64, 64, 64)).astype(np.float32))
    last = torch.from_numpy(rng.standard_normal((2, d)).astype(np.float32))
    full = torch.ones(2, 9, dtype=torch.bool)
    want, want_s, _ = tr.time_mix_chunk(tp, x, state, last, full)
    got, s, lst = tr.time_mix_chunk(tp, x[:, :6], state, last, full[:, :6])
    outs = [got]
    for i in range(6, 9):
        y, s, lst = tr.time_mix_step(tp, x[:, i], s, lst)
        outs.append(y[:, None])
    torch.testing.assert_close(torch.cat(outs, 1), want, atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    torch.testing.assert_close(s, want_s, atol=MODEL_TOL, rtol=MODEL_TOL)


def test_init_has_the_jax_layout_and_dtypes(jx):
    """rwkv6-7b's plan (every layer one group-stacked rwkv6 block, no
    ``mlp``) with the reference's dtypes: w0 and u stay f32 in a bf16
    model, in the port's own init and through the bridge."""
    jax, _, _, _ = jx
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.models import zoo as jzoo
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import zoo
    from repro_torch.models.bridge import params_from_numpy
    over = dict(num_layers=3, d_model=128, dtype="bfloat16")
    params, _ = jzoo.init(jax_reduced(jax_get_config("rwkv6-7b"), **over),
                          jax.random.key(0))
    mine = zoo.init(reduced(get_config("rwkv6-7b"), **over),
                    torch.Generator().manual_seed(0), "cpu")
    bridged = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [layout(v) for v in tree]
        return tuple(tree.shape), str(tree.dtype).split(".")[-1]

    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), params)
    assert layout(mine) == layout(bridged) == want
    assert set(mine) == {"embed", "head", "ln_f", "groups"}
    block = mine["groups"][0]
    assert set(block) == {"ln1", "tm_cm", "ln2"}
    tm = block["tm_cm"]
    assert tm["u"].shape == (3, 2, 64)
    for name in ("w0", "u"):
        assert tm[name].dtype == torch.float32
        assert bridged["groups"][0]["tm_cm"][name].dtype == torch.float32
    assert tm["wr"].dtype == torch.bfloat16
    assert float(tm["w0"].max()) == float(tm["w0"].min()) == -6.0
    assert float(tm["u"].abs().max()) == 0.0
    assert float(tm["mu_k"].min()) == 0.5
    assert float(tm["ln_scale"].min()) == 1.0


def test_packed_segment_restart_resets_all_three_state_leaves(jx):
    """A segment starting at position 0 in a reused slot begins from zero
    S and zero token shifts: its logits equal a fresh cache's, and the JAX
    package's on a fresh cache."""
    jax, jnp, _, _ = jx
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.models import zoo as jzoo
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import zoo
    from repro_torch.models.bridge import params_from_numpy
    jcfg = jax_reduced(jax_get_config("rwkv6-7b"), d_model=128)
    cfg = reduced(get_config("rwkv6-7b"), d_model=128)
    params, _ = jzoo.init(jcfg, jax.random.key(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(4)

    def stream(n, width=32):
        tokens = np.zeros((1, width), np.int32)
        tokens[0, :n] = rng.integers(0, cfg.vocab_size, n)
        slot = np.where(np.arange(width) < n, 0, -1).astype(np.int32)
        pos = np.where(slot >= 0, np.arange(width), 0).astype(np.int32)
        return (tokens, slot, pos, np.zeros(1, np.int32),
                np.array([n], np.int32))

    first, second = stream(21), stream(17)
    reused = zoo.init_cache(cfg, 1, 64, "cpu")
    zoo.step_packed(cfg, tp, reused, *map(torch.from_numpy, first))
    assert float(reused["groups"][0]["tm_last"].abs().max()) > 0
    got = zoo.step_packed(cfg, tp, reused, *map(torch.from_numpy, second))
    fresh_cache = zoo.init_cache(cfg, 1, 64, "cpu")
    fresh = zoo.step_packed(cfg, tp, fresh_cache,
                            *map(torch.from_numpy, second))
    want, _ = jzoo.step_packed(jcfg, params, jzoo.init_cache(jcfg, 1, 64),
                               *map(jnp.asarray, second))
    np.testing.assert_allclose(got.numpy(), fresh.numpy(), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    for name in ("S", "tm_last", "cm_last"):
        torch.testing.assert_close(reused["groups"][0][name],
                                   fresh_cache["groups"][0][name],
                                   atol=1e-6, rtol=0)


# -------------------------------------------------- the kernel's launch
def test_launch_shape_of_the_scan():
    """A CTA of four warps a bh row, three stages of 16 steps of r, k,
    exp(logw) and v plus the steps' bonus and pair sums: 49,536 bytes, so
    four CTAs (every row of the 512 at rwkv6-7b's mixed tick on 132 SMs)
    fit an SM's 228 KB with 1 KB reserved each."""
    assert (THREADS, CHUNK, STAGES) == (128, 16, 3)
    assert smem_bytes() == 49_536
    assert 4 * (smem_bytes() + 1024) <= 233_472 < 5 * (smem_bytes() + 1024)
    assert 512 <= 4 * 132


@pytest.mark.parametrize("offset,want", [(0, 16), (2, 8), (4, 16), (6, 8)])
def test_copy_bytes_follows_the_inputs_alignment(offset, want):
    """Streams whose base address is 16-byte aligned take 16-byte copies;
    one that is only 8-byte aligned (the wrapper's floor) takes 8."""
    buf = torch.zeros(4 * 64 + 8)
    view = buf[offset:offset + 4 * 64].view(1, 4, 64)
    assert buf.data_ptr() % 16 == 0
    fresh = torch.zeros(1, 4, 64)
    assert copy_bytes(fresh, fresh, fresh, view) == want
    assert copy_bytes(fresh) == 16


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,decay", [(3, 1, "model"), (3, 7, "model"),
                                        (5, 33, "model"), (2, 129, "model"),
                                        (64, 100, "strong"),
                                        (64, 100, "pads"),
                                        (512, 300, "model"),
                                        # a stage's edges: 16 steps
                                        (1, 15, "model"), (3, 16, "model"),
                                        (1, 17, "strong"), (3, 33, "pads"),
                                        (1, 4096, "model"),
                                        (3, 4096, "strong"),
                                        (512, 4096, "model")])
def test_scan_kernel_matches_plain_on_card(cuda, bh, s, decay):
    args = t(*scan_case(np.random.default_rng(s), bh, s, 64, decay),
             device=cuda)
    before = rwkv6_scan_state.launches
    y, s_out = rwkv6_scan_state(*args)
    torch.cuda.synchronize()
    assert rwkv6_scan_state.launches == before + 1
    want_y, want_s = rwkv6_ref_state(*args)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s_out, want_s, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [17, 300])
def test_scan_kernel_takes_8_byte_aligned_inputs_on_card(cuda, s):
    """Inputs 8- but not 16-byte aligned (views 2 floats into a buffer)
    take the kernel's 8-byte copies and give what aligned copies give."""
    args = t(*scan_case(np.random.default_rng(s), 3, s, 64, "pads"),
             device=cuda)
    views = []
    for a in args[:4]:
        buf = torch.empty(a.numel() + 2, device=cuda)
        views.append(buf[2:].view_as(a).copy_(a))
    assert copy_bytes(*views) == 8 and copy_bytes(*args[:4]) == 16
    got = rwkv6_scan_state(*views, *args[4:])
    want = rwkv6_scan_state(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [19, 33, 147])
def test_scan_kernel_threads_state_on_card(cuda, cut):
    """Two launches split at a step off a stage edge (16 steps), threading
    s_out, equal one launch."""
    r, k, v, logw, u, s0 = t(*scan_case(np.random.default_rng(9), 8, 300,
                                        64), device=cuda)
    y, s_out = rwkv6_scan_state(r, k, v, logw, u, s0)
    y1, s1 = rwkv6_scan_state(*(a[:, :cut].contiguous()
                                for a in (r, k, v, logw)), u, s0)
    y2, s2 = rwkv6_scan_state(*(a[:, cut:].contiguous()
                                for a in (r, k, v, logw)), u, s1)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(s2, s_out, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_scan_kernel_refuses_other_dtypes_and_head_dims(cuda):
    args = t(*scan_case(np.random.default_rng(0), 2, 5, 64), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        rwkv6_scan_state(*(a.bfloat16() for a in args[:4]), *args[4:])
    args = t(*scan_case(np.random.default_rng(0), 2, 5, 32), device=cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        rwkv6_scan_state(*args)


@pytest.mark.cuda
def test_ops_launch_the_kernel_on_card(cuda):
    args = t(*scan_case(np.random.default_rng(0), 2, 5, 64), device=cuda)
    before = rwkv6_scan_state.launches
    rwkv6_state_op(*args)
    rwkv6_op(*args[:5])
    torch.cuda.synchronize()
    assert rwkv6_scan_state.launches == before + 2


@pytest.mark.cuda
def test_scan_kernel_at_one_step_threads_nine_launches(cuda):
    """A speculative row's column calls: nine launches of T = 1 at
    rwkv6-7b's 512 rows, each seeding the next, against one launch of
    T = 9 and the plain version.  Not bit for bit with T = 9: one launch
    runs its steps in pairs, within a few f32 ulps of the step order."""
    r, k, v, logw, u, s0 = t(*scan_case(np.random.default_rng(9), 512, 9,
                                        64), device=cuda)
    y, s_out = rwkv6_scan_state(r, k, v, logw, u, s0)
    ys, st = [], s0
    for j in range(9):
        yj, st = rwkv6_scan_state(*(a[:, j:j + 1].contiguous()
                                    for a in (r, k, v, logw)), u, st)
        ys.append(yj)
    torch.cuda.synchronize()
    y1 = torch.cat(ys, 1)
    torch.testing.assert_close(y1, y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(st, s_out, atol=1e-5, rtol=1e-5)
    want_y, want_s = rwkv6_ref_state(r, k, v, logw, u, s0)
    torch.testing.assert_close(y1, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, want_s, atol=1e-4, rtol=1e-4)

