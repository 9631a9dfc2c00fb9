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

Tests marked ``cuda`` hold the CUDA kernel against the plain version on
the card and skip where there is none:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_rglru.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.rglru import (rglru_op, rglru_ref, rglru_ref_state,
                                       rglru_scan, rglru_scan_state,
                                       rglru_state_op)

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
