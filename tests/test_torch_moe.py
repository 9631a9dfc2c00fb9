"""The port's MoE layer against the JAX package's, on the CPU.

``moe_apply`` (outputs, the load-balancing aux, the drop pattern and the
f32 gradients) and ``moe_reference`` at ``reduced()`` deepseek-moe-16b
and llama4-maverick-400b-a17b widths, with the weights of the JAX
``moe_init`` bridged into torch and the same numpy inputs: with and
without a mask of real tokens, with drops (``capacity_factor`` 1.0) and
without (8.0), over groups of 512 tokens, a prime stream length (groups
of one token), decode batches ``[B, 1, d]`` (one token a group, capacity
1) and rows of exact ties.  Tolerance: ``atol=2e-5, rtol=2e-4``, the
reference's own for ``moe_apply`` against ``moe_reference``
(``tests/test_models.py``); gradients within ``2e-4`` of each leaf's
largest magnitude, as ``tests/test_torch_train.py`` holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe
from repro_torch.models.bridge import params_from_numpy

ATOL, RTOL = 2e-5, 2e-4
GRAD_REL = 2e-4
ARCHS = ["deepseek-moe-16b", "llama4-maverick-400b-a17b"]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _cfgs(arch, **extra):
    return (jax_reduced(jax_get_config(arch), **extra),
            reduced(get_config(arch), **extra))


def _weights(jcfg, seed=0):
    jp, _ = jmoe.moe_init(jax.random.key(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def _valid(rng, b, s, frac=0.7):
    return rng.random((b, s)) < frac


# (B, S): groups of 512 (and a ragged 32-token batch), a prime stream
# length past 512 (521: groups of one token), decode batches
SHAPES = [(2, 32), (1, 1024), (1, 521), (5, 1)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("capacity", [1.0, 8.0])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(rng, arch, shape, capacity, masked):
    jcfg, cfg = _cfgs(arch, capacity_factor=capacity)
    jp, tp = _weights(jcfg)
    b, s = shape
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    valid = _valid(rng, b, s) if masked else None
    want, jaux = jmoe.moe_apply(
        jp, jnp.asarray(x), jcfg, return_aux=True,
        valid=None if valid is None else jnp.asarray(valid))
    got, aux = moe.moe_apply(
        tp, torch.from_numpy(x), cfg, return_aux=True,
        valid=None if valid is None else torch.from_numpy(valid))
    _close(got, want)
    _close(aux, jaux)
    assert got.shape == (b, s, cfg.d_model) and aux.dtype == torch.float32
    plain = moe.moe_apply(tp, torch.from_numpy(x), cfg, valid=None
                          if valid is None else torch.from_numpy(valid))
    assert torch.equal(plain, got)


def _drop_pattern(params, x, cfg, valid, lib):
    """Which assignments ``moe_apply`` keeps, read from its output: with
    every expert's down projection zeroed but expert ``e``'s, a token's
    routed output is nonzero exactly when its ``e`` assignment is kept."""
    out = []
    for e in range(cfg.num_experts):
        p = {k: v for k, v in params.items() if k != "shared"}
        mask = np.zeros((cfg.num_experts, 1, 1), np.float32)
        mask[e] = 1
        if lib is jmoe:
            p["w_down"] = p["w_down"] * jnp.asarray(mask)
            y = np.asarray(jmoe.moe_apply(p, jnp.asarray(x), cfg,
                                          valid=valid))
        else:
            p["w_down"] = p["w_down"] * torch.from_numpy(mask)
            y = moe.moe_apply(p, torch.from_numpy(x), cfg,
                              valid=valid).numpy()
        out.append(np.abs(y).max(axis=-1) > 0)
    return np.stack(out, -1)


@pytest.mark.parametrize("arch", ARCHS)
def test_drop_pattern_matches_jax(rng, arch):
    """At capacity 1.0 some assignments drop; the port keeps exactly the
    JAX package's, token by token and expert by expert, with pads."""
    jcfg, cfg = _cfgs(arch, capacity_factor=1.0)
    jp, tp = _weights(jcfg)
    x = rng.standard_normal((1, 96, cfg.d_model)).astype(np.float32)
    valid = _valid(rng, 1, 96)
    want = _drop_pattern(jp, x, jcfg, jnp.asarray(valid), jmoe)
    got = _drop_pattern(tp, x, cfg, torch.from_numpy(valid), moe)
    np.testing.assert_array_equal(got, want)
    routed = cfg.top_k * int(valid.sum())
    assert 0 < int(want.sum()) < routed          # drops happened
    assert not want[~valid].any()                 # pads keep nothing


def _tied(rng, cfg, b, s):
    """Weights and inputs whose router products are exact in f32 (small
    multiples of 1/4), with experts 1, 3 and 6 (and 2 and 5) sharing a
    router column, plus rows of zeros: exact ties in the probabilities,
    which only the tie order separates."""
    d, e = cfg.d_model, cfg.num_experts
    router = rng.integers(-2, 3, (d, e)).astype(np.float32) / 4
    router[:, 3] = router[:, 6] = router[:, 1]
    router[:, 5] = router[:, 2]
    x = rng.integers(-2, 3, (b, s, d)).astype(np.float32) / 4
    x[:, ::3] = 0.0
    return router, x


@pytest.mark.parametrize("arch", ARCHS)
def test_tie_order_matches_jax_top_k(rng, arch):
    """Among equal probabilities the lower expert index comes first, as
    ``jax.lax.top_k`` orders them; the layer's outputs, aux and drops
    follow."""
    jcfg, cfg = _cfgs(arch, capacity_factor=1.0)
    jp, tp = _weights(jcfg)
    router, x = _tied(rng, cfg, 2, 24)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    probs = np.array(jax.nn.softmax(jnp.asarray(x) @ jp["router"], -1))
    _, j_idx = jax.lax.top_k(jnp.asarray(probs), cfg.top_k)
    _, t_idx = moe.route(torch.from_numpy(probs), cfg.top_k)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    uniform = np.tile(np.arange(cfg.top_k), (2, 8, 1))
    np.testing.assert_array_equal(t_idx[:, ::3].numpy(), uniform)
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, return_aux=True)
    got, aux = moe.moe_apply(tp, torch.from_numpy(x), cfg, return_aux=True)
    _close(got, want)
    _close(aux, jaux)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_grads_match_jax(rng, arch, masked):
    """f32 gradients of a random projection of the output plus the aux,
    for every weight leaf and the input, at capacity 1.0 (drops)."""
    jcfg, cfg = _cfgs(arch, capacity_factor=1.0)
    jp, tp = _weights(jcfg)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    valid = _valid(rng, 2, 40) if masked else None

    def jloss(p, xx):
        out, aux = jmoe.moe_apply(
            p, xx, jcfg, return_aux=True,
            valid=None if valid is None else jnp.asarray(valid))
        return jnp.sum(out * ct) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = jax.tree.map(lambda t: t.requires_grad_(True), tp)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_apply(
        tp, tx, cfg, return_aux=True,
        valid=None if valid is None else torch.from_numpy(valid))
    (out * torch.from_numpy(ct)).sum().add(aux).backward()
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    for path, want in [(p, np.asarray(v)) for p, v in flat] + [("x", jgx)]:
        if path == "x":
            got = tx.grad
        else:
            got = tp
            for k in path:
                got = got[k.key]
            got = got.grad
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= GRAD_REL * max(np.abs(want).max(), 1e-30), (path, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_reference_matches_jax(rng, arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(jcfg)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32) * 0.5
    want = jmoe.moe_reference(jp, jnp.asarray(x), jcfg)
    got = moe.moe_reference(tp, torch.from_numpy(x), cfg)
    _close(got, want)
    # ample capacity: the dispatch equals the per-token oracle
    jcfg8, cfg8 = _cfgs(arch, capacity_factor=8.0)
    _close(moe.moe_apply(tp, torch.from_numpy(x), cfg8), got)


def test_moe_chunk_pads_cannot_steal_capacity(rng):
    """The reference's property (``tests/test_chunked_prefill.py``) on the
    port: at capacity 1.0 the routed output at real tokens does not
    depend on what the pad tail holds, and the padded chunk routes as the
    unpadded batch does; both against the JAX package too."""
    jcfg, cfg = _cfgs("deepseek-moe-16b", capacity_factor=1.0)
    jp, tp = _weights(jcfg)
    b, s, nv = 2, 32, 20
    x_real = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    valid = np.zeros((b, s), bool)
    valid[:, :nv] = True
    outs = []
    for fill in (0.0, 7.0, -3.0):
        x = x_real.copy()
        x[:, nv:] = fill
        got = moe.moe_apply(tp, torch.from_numpy(x), cfg,
                            valid=torch.from_numpy(valid))[:, :nv]
        want = jmoe.moe_apply(jp, jnp.asarray(x), jcfg,
                              valid=jnp.asarray(valid))[:, :nv]
        _close(got, want)
        outs.append(got.numpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)
    np.testing.assert_allclose(outs[0], outs[2], atol=1e-6)
    ref = moe.moe_apply(tp, torch.from_numpy(x_real[:, :nv]), cfg)
    np.testing.assert_allclose(outs[0], ref.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_has_the_jax_layout(arch, dtype):
    """Same leaves, shapes and dtypes as the JAX ``moe_init`` (the router
    f32 in a bf16 model), with a group-stacking lead; each leaf drawn
    from the reference's distribution, uniform +-1/sqrt(shape[-2])."""
    jcfg, cfg = _cfgs(arch, dtype=dtype)
    jp, _ = jmoe.moe_init(jax.random.key(0), jcfg)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    mine = moe.moe_init(cfg, tdt, "cpu", torch.Generator().manual_seed(0),
                        lead=(3,))
    want = jax.tree.map(lambda a: ((3,) + a.shape,
                                   str(a.dtype).replace("bfloat16", "bf16")),
                        jp)

    def layout(t):
        if isinstance(t, dict):
            return {k: layout(v) for k, v in t.items()}
        return tuple(t.shape), {torch.float32: "float32",
                                torch.bfloat16: "bf16"}[t.dtype]
    assert layout(mine) == want
    w = mine["w_gate"].float()
    bound = 1 / np.sqrt(cfg.d_model)
    assert float(w.abs().max()) <= bound
    assert float(w.std()) == pytest.approx(bound / np.sqrt(3), rel=0.1)
    # each stacked layer and expert is its own draw
    assert not torch.equal(w[0, 0], w[0, 1]) and not torch.equal(w[0], w[1])
