"""The port's RG-LRU family against the JAX package.

The scan's plain version (what a CPU tensor runs) is held against the JAX
oracle and the JAX Pallas kernel in interpret mode on the same numpy
inputs: a nonzero carried state, odd sequence lengths, and state threaded
across a chunk boundary.  The model's ``rglru_chunk`` (ragged valid masks
over padded rows, with carried ``h`` and conv window) and ``rglru_step``
are held against the JAX package's with the JAX package's own weights.

Tolerances: the scan in f32, ``atol=rtol=1e-5`` (both sides run the same
f32 recurrence; the kernel may fuse the multiply-add); the model pieces
``atol=1e-5`` on f32 weights.

The kernel's launch shape (CTA width, copy width, shared memory) is
computed in Python from shapes and pointers; those helpers are pinned here
on the CPU.  Tests marked ``cuda`` hold the CUDA kernel against the plain
version on the card, every instance (reached through B, F and views
offset in their buffers) and the ring's edges (S around a stage, F off
the CTA width, inputs only 4-byte aligned, pad steps bit for bit, state
threaded across launches, nine launches of one step), and skip where
there is none:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_rglru.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.rglru import (rglru_op, rglru_ref, rglru_ref_state,
                                       rglru_scan, rglru_scan_state,
                                       rglru_state_op)
from repro_torch.kernels.rglru import rglru as kernel

TOL = 1e-5


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
    """The JAX package's RG-LRU oracle, Pallas kernel and model module."""
    jnp = pytest.importorskip("jax.numpy")
    import jax
    from repro.kernels import rglru as kernels
    from repro.models import rglru as model
    return jax, jnp, kernels, model


def scan_case(rng, b, s, f):
    """log_a < 0 as the model makes it, inputs and a nonzero h0."""
    return (-np.abs(rng.standard_normal((b, s, f))).astype(np.float32) * 0.5,
            rng.standard_normal((b, s, f)).astype(np.float32),
            rng.standard_normal((b, f)).astype(np.float32))


def t(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


# -------------------------------------------------------------- the scan
@pytest.mark.parametrize("s", [1, 7, 64, 128])
def test_scan_plain_matches_jax(jx, s):
    _, jnp, kernels, _ = jx
    la, b, h0 = scan_case(np.random.default_rng(s), 3, s, 256)
    got_h, got_out = rglru_state_op(*t(la, b, h0))
    for h, out in (kernels.rglru_ref_state(*map(jnp.asarray, (la, b, h0))),
                   kernels.rglru_scan_state(*map(jnp.asarray, (la, b, h0)),
                                            interpret=True)):
        np.testing.assert_allclose(got_h.numpy(), np.asarray(h), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(got_out.numpy(), np.asarray(out),
                                   atol=TOL, rtol=TOL)
    np.testing.assert_allclose(rglru_op(*t(la, b)).numpy(),
                               np.asarray(kernels.rglru_ref(
                                   jnp.asarray(la), jnp.asarray(b))),
                               atol=TOL, rtol=TOL)


def test_scan_state_threads_across_a_chunk_boundary(jx):
    """Two chunks with the state carried between them give the one-shot
    run, outputs and final state alike (the scan-state ABI)."""
    _, jnp, kernels, _ = jx
    la, b, h0 = scan_case(np.random.default_rng(3), 2, 96, 128)
    h1, s1 = rglru_state_op(*t(la[:, :37], b[:, :37], h0))
    h2, s2 = rglru_state_op(*t(la[:, 37:], b[:, 37:]), s1)
    want_h, want_s = kernels.rglru_ref_state(*map(jnp.asarray, (la, b, h0)))
    np.testing.assert_allclose(torch.cat([h1, h2], 1).numpy(),
                               np.asarray(want_h), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(want_s), atol=TOL,
                               rtol=TOL)


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    la, b, h0 = t(*scan_case(np.random.default_rng(0), 2, 5, 32))
    before = rglru_scan_state.launches
    got = rglru_state_op(la, b, h0)
    want = rglru_ref_state(la, b, h0)
    assert rglru_scan_state.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    torch.testing.assert_close(rglru_op(la, b), rglru_ref(la, b), atol=0,
                               rtol=0)


@pytest.mark.parametrize("wrapper,nargs", [(rglru_scan_state, 3),
                                           (rglru_scan, 2)])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper, nargs):
    args = t(*scan_case(np.random.default_rng(0), 2, 5, 32))[:nargs]
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args)


# ------------------------------------------------- the kernel's launch shape
@pytest.mark.parametrize("bsz,f,sms,want", [
    (8, 4096, 132, 64),     # a full-width mixed tick: 512 CTAs
    (5, 4096, 132, 64),     # 320 CTAs of 64, two or more an SM
    (4, 4096, 132, 32),     # 256 of 64 would be under two an SM
    (1, 4096, 132, 32),     # one slot's prompt: 128 CTAs of 32
    (3, 33, 132, 32),
    (300, 64, 132, 64)])
def test_cta_channels(bsz, f, sms, want):
    assert kernel.cta_channels(bsz, f, sms) == want


@pytest.mark.parametrize("f,offset,want", [
    (4096, 0, 16), (64, 0, 16), (100, 0, 16),
    (33, 0, 4),             # rows of 33 floats lose the 16-byte alignment
    (4096, 1, 4),           # base only 4-byte aligned
    (4096, 2, 4),           # base only 8-byte aligned
    (4096, 4, 16)])
def test_copy_bytes(f, offset, want):
    buf = torch.zeros(2 * f + 8)
    assert buf.data_ptr() % 16 == 0
    view = buf[offset:offset + 2 * f].view(1, 2, f)
    assert kernel.copy_bytes(f, view, buf[:2 * f].view(1, 2, f)) == want


@pytest.mark.parametrize("channels,stages", [(64, 3), (32, 4)])
def test_ring_shape(channels, stages):
    """Four CTAs of 64 channels or six of 32 fit an SM's 228 KB (1 KB
    reserved a CTA)."""
    assert kernel.stages(channels) == stages
    smem = kernel.smem_bytes(channels)
    assert smem == {64: 48 * 1024, 32: 32 * 1024}[channels]
    assert (228 * 1024) // (smem + 1024) >= {64: 4, 32: 6}[channels]


# (B, S, F, floats a view lies into its buffer) and the (channels, copy
# bytes) instance the wrapper plans for it on a card of 132 SMs: each
# instance with a full and with a part-filled last CTA
INSTANCE_CASES = [
    ((8, 40, 4096, 0), (64, 16)),
    ((5, 77, 4100, 0), (64, 16)),
    ((8, 40, 4096, 1), (64, 4)),    # bases 4 bytes off
    ((5, 77, 4098, 0), (64, 4)),    # F % 4 != 0
    ((2, 40, 4096, 0), (32, 16)),
    ((3, 77, 100, 0), (32, 16)),
    ((2, 40, 4096, 1), (32, 4)),
    ((3, 77, 33, 0), (32, 4))]


def offset_views(xs, offset):
    """Copies of ``xs``, each ``offset`` floats into a buffer of its own."""
    out = []
    for x in xs:
        buf = torch.empty(x.numel() + 4, device=x.device)
        out.append(buf[offset:offset + x.numel()].view_as(x).copy_(x))
    return out


@pytest.mark.parametrize("shape,want", INSTANCE_CASES, ids=str)
def test_instance_cases_take_their_instance(shape, want):
    """The card tests' shapes reach every instance through the plan."""
    b, s, f, offset = shape
    la, bb = offset_views(t(*scan_case(np.random.default_rng(0), b, 2, f))[:2],
                          offset)
    assert (kernel.cta_channels(b, f, 132), kernel.copy_bytes(f, la, bb)) \
        == want


# ------------------------------------------------------------- the model
def _block(jx, seed=0):
    """The JAX package's RG-LRU weights (f32, d 64, dr 64) on both sides."""
    jax, jnp, _, model = jx
    from repro.configs import get_config, reduced
    from repro_torch.models.bridge import params_from_numpy
    cfg = reduced(get_config("recurrentgemma-9b"))
    jp, _ = model.rglru_init(jax.random.key(seed), cfg)
    # a spread of decays instead of the constant initial one
    rng = np.random.default_rng(seed)
    jp["lam"] = jnp.asarray(rng.uniform(-1, 25, jp["lam"].shape), jnp.float32)
    jp["ba"] = jnp.asarray(rng.standard_normal(jp["ba"].shape), jnp.float32)
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_rglru_chunk_matches_jax(jx):
    """Ragged rows (one empty, one full, two partial) from a nonzero
    carried state: outputs, h and the conv carry of the valid inputs."""
    _, jnp, _, model = jx
    from repro_torch.models import rglru as tr
    cfg, jp, tp = _block(jx)
    rng = np.random.default_rng(1)
    b, c, d = 4, 11, cfg.d_model
    x = rng.standard_normal((b, c, d)).astype(np.float32)
    valid = np.arange(c)[None, :] < np.array([0, 11, 5, 1])[:, None]
    state = {"h": rng.standard_normal((b, d)).astype(np.float32),
             "conv": rng.standard_normal((b, 3, d)).astype(np.float32)}
    wy, ws = model.rglru_chunk(jp, jnp.asarray(x),
                               {k: jnp.asarray(v) for k, v in state.items()},
                               jnp.asarray(valid))
    gy, gs = tr.rglru_chunk(tp, torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in state.items()},
                            torch.from_numpy(valid))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=TOL,
                               rtol=TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gs[k].numpy(), np.asarray(ws[k]),
                                   atol=TOL, rtol=TOL)
    # the empty row's state passes through unchanged, bit for bit
    assert (gs["h"][0].numpy() == state["h"][0]).all()
    assert (gs["conv"][0].numpy() == state["conv"][0]).all()


def test_rglru_step_matches_jax(jx):
    _, jnp, _, model = jx
    from repro_torch.models import rglru as tr
    cfg, jp, tp = _block(jx, seed=2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    state = {"h": rng.standard_normal((3, cfg.d_model)).astype(np.float32),
             "conv": rng.standard_normal((3, 3, cfg.d_model))
             .astype(np.float32)}
    wy, ws = model.rglru_step(jp, jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in state.items()})
    gy, gs = tr.rglru_step(tp, torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in state.items()})
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=TOL,
                               rtol=TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gs[k].numpy(), np.asarray(ws[k]),
                                   atol=TOL, rtol=TOL)


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("b,s,f", [(3, 1, 300), (3, 7, 300), (2, 129, 4096),
                                   (1, 1000, 128)])
def test_scan_kernel_matches_plain_on_card(cuda, b, s, f):
    la, bb, h0 = t(*scan_case(np.random.default_rng(s), b, s, f),
                   device=cuda)
    before = rglru_scan_state.launches
    h, out = rglru_scan_state(la, bb, h0)
    torch.cuda.synchronize()
    assert rglru_scan_state.launches == before + 1
    want_h, want_out = rglru_ref_state(la, bb, h0)
    torch.testing.assert_close(h, want_h, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(out, want_out, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_scan_kernel_refuses_other_dtypes(cuda):
    la, b, h0 = t(*scan_case(np.random.default_rng(0), 2, 5, 32),
                  device=cuda)
    with pytest.raises(TypeError, match="float32"):
        rglru_scan_state(la.bfloat16(), b.bfloat16(), h0)


@pytest.mark.cuda
def test_ops_launch_the_kernel_on_card(cuda):
    la, b, h0 = t(*scan_case(np.random.default_rng(0), 2, 5, 32),
                  device=cuda)
    before = rglru_scan_state.launches
    rglru_state_op(la, b, h0)
    rglru_op(la, b)
    torch.cuda.synchronize()
    assert rglru_scan_state.launches == before + 2


def card_scan(cuda, b, s, f, seed=0):
    return t(*scan_case(np.random.default_rng(seed), b, s, f), device=cuda)


def assert_plain(h, out, la, bb, h0):
    want_h, want_out = rglru_ref_state(la, bb, h0)
    torch.testing.assert_close(h, want_h, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(out, want_out, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 7, kernel.STEPS - 1, kernel.STEPS,
                               kernel.STEPS + 1, 129, 4096])
def test_scan_kernel_at_stage_edges(cuda, s):
    la, bb, h0 = card_scan(cuda, 3, s, 4096, seed=s)
    assert_plain(*rglru_scan_state(la, bb, h0), la, bb, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,f", [(1, 4096), (3, 4096), (8, 4096), (3, 64),
                                 (8, 64), (3, 33), (1, 33)])
def test_scan_kernel_rows_and_widths(cuda, b, f):
    la, bb, h0 = card_scan(cuda, b, 300, f, seed=b * f)
    assert_plain(*rglru_scan_state(la, bb, h0), la, bb, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,want", INSTANCE_CASES, ids=str)
def test_scan_kernel_every_instance(cuda, shape, want):
    """Each (channels, copy) instance, with a full and a part-filled last
    CTA."""
    b, s, f, offset = shape
    la, bb, h0 = card_scan(cuda, b, s, f, seed=s)
    la, bb = offset_views((la, bb), offset)
    assert kernel.launch_plan(la, bb) == want
    before = rglru_scan_state.launches
    h, out = rglru_scan_state(la, bb, h0)
    torch.cuda.synchronize()
    assert rglru_scan_state.launches == before + 1
    assert_plain(h, out, la, bb, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2])
def test_scan_kernel_on_4_byte_aligned_views(cuda, offset):
    """Inputs 1 or 2 floats into their buffers take the 4-byte copies."""
    la, bb, h0 = card_scan(cuda, 3, 129, 4096, seed=offset)
    views = offset_views((la, bb), offset)
    assert kernel.launch_plan(*views)[1] == 4
    assert_plain(*rglru_scan_state(*views, h0), *views, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,want", [(3, 300, (32, 16)), (8, 4096, (64, 16)),
                                      (5, 4098, (64, 4)), (3, 33, (32, 4))])
def test_scan_kernel_pad_steps_pass_h_through(cuda, b, f, want):
    """Steps with log_a = b = 0 (the B x P rows' pads) leave h bit for
    bit, from the start (h0) and across a stage edge, in every instance."""
    la, bb, h0 = card_scan(cuda, b, 100, f, seed=5)
    for lo, hi in ((0, 10), (20, 70)):
        la[:, lo:hi] = 0
        bb[:, lo:hi] = 0
    assert kernel.launch_plan(la, bb) == want
    h, out = rglru_scan_state(la, bb, h0)
    torch.cuda.synchronize()
    assert torch.equal(h[:, :10], h0[:, None].expand(-1, 10, -1))
    assert torch.equal(h[:, 20:70], h[:, 19:20].expand(-1, 50, -1))
    assert_plain(h, out, la, bb, h0)


@pytest.mark.cuda
def test_scan_kernel_threads_state_across_launches(cuda):
    """Two launches split at step 45 (off a stage edge), the first's h_out
    seeding the second, give the one launch's outputs bit for bit: each
    channel runs the same f32 steps in the same order."""
    la, bb, h0 = card_scan(cuda, 8, 300, 4096, seed=7)
    h, out = rglru_scan_state(la, bb, h0)
    cut = 45
    h1, s1 = rglru_scan_state(la[:, :cut].contiguous(),
                              bb[:, :cut].contiguous(), h0)
    h2, s2 = rglru_scan_state(la[:, cut:].contiguous(),
                              bb[:, cut:].contiguous(), s1)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([h1, h2], 1), h)
    assert torch.equal(s2, out)
    assert_plain(h, out, la, bb, h0)


@pytest.mark.cuda
def test_scan_kernel_at_one_step_threads_nine_launches(cuda):
    """A speculative row's column calls: nine launches of T = 1 at
    recurrentgemma-9b's width, each seeding the next, give one launch of
    T = 9 bit for bit."""
    la, bb, h0 = card_scan(cuda, 8, 9, 4096, seed=9)
    h, out = rglru_scan_state(la, bb, h0)
    hs, st = [], h0
    for j in range(9):
        hj, st = rglru_scan_state(la[:, j:j + 1].contiguous(),
                                  bb[:, j:j + 1].contiguous(), st)
        hs.append(hj)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(hs, 1), h) and torch.equal(st, out)
    assert_plain(h, out, la, bb, h0)

