"""The port's ``remat`` policies against the reference's, on the CPU.

The reference checkpoints its scanned group body under
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` when
``remat == "dots"`` (the default), with no policy for any other value
but ``"none"``; the port checkpoints each group layer (its
cross-attention with it) likewise, keeping under ``"dots"`` the outputs
of its products without batch dims, the ``x @ w`` of a weight
``w [d, f]`` (``models.remat.dot``), all but the layer's closing one.
Reduced configs at 2 x 32 tokens (3 x 32 for (a'), 4 x 32 on the
meshes): every arch for (a)-(c), and for (d) one of each family,
yi-6b, recurrentgemma-9b (RG-LRU), rwkv6-7b (at ``d_model=128``: two
heads), deepseek-moe-16b and whisper-tiny (cross-attention).

* (a) the element counts of the products the port's forward runs in
  each group (``chip_smoke.kept_products``) equal, as a multiset, those
  of the ``dot_general``s without batch dims inside the reference's
  dots ``checkpoint`` (``jax.make_jaxpr`` of its ``loss_fn``; the loss
  chunks' policy-free checkpoint left out);
* (a') what the port keeps of a group past its forward (each layer's
  input and the products still kept as its forward ends) equals, as a
  multiset of element counts, the residuals the reference's decoder
  group scan stacks (JAX's ``saved_residuals``);
* (b) the loss and every gradient leaf are bit for bit equal under
  ``"none"``, ``"dots"`` and ``"full"``, also with the stand-in for
  each closing product's output filled with NaN;
* (c) under ``"dots"`` the ``mm`` / ``addmm`` calls over forward and
  backward are ``"none"``'s (every one of the layer's is kept or not
  needed), the ``bmm`` calls and the flash forwards ``"full"``'s;
* (d) a ``1x2`` tensor-parallel rank and a ``2x1`` FSDP rank (vocab
  16384: embed and head sliced) step bit for bit alike under the three,
  also with the NaN stand-ins;
* (e) ``MeshPool`` and ``spawn_mesh`` default to the card: without one
  they raise before any rank starts.
"""

import functools
import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_train_ranks as ranks
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.flash_attention import vjp
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import MeshPool
from repro_torch.models import transformer as tf
from repro_torch.models import zoo
from repro_torch.models.bridge import tree_leaves
from repro_torch.optim import accum

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

ARCHS = ["yi-6b", "recurrentgemma-9b", "rwkv6-7b", "deepseek-moe-16b",
         "whisper-tiny"]
# (a)-(c) take every arch of the zoo
ALL_ARCHS = ARCHS + ["h2o-danube-3-4b", "gemma3-4b", "starcoder2-15b",
                     "llama4-maverick-400b-a17b", "internvl2-1b"]
OVERRIDES = {"rwkv6-7b": {"d_model": 128}}
REMATS = ("none", "dots", "full")
PRODUCTS = ("mm", "addmm", "bmm", "baddbmm")
SHAPE = ShapeConfig("t", 32, 2, "train")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def port_cfg(arch, **extra):
    return reduced(get_config(arch), **OVERRIDES.get(arch, {}), **extra)


def port_inputs(cfg, shape=SHAPE):
    params = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = zoo.make_batch(cfg, shape, np.random.default_rng(0), "cpu")
    return params, batch


# ---------------------------------------------------------------------------
# (a) what is saved, against the reference's jaxpr
# ---------------------------------------------------------------------------


def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (tuple, list)) else (v,)):
            if hasattr(x, "jaxpr") and hasattr(x, "consts"):
                yield x.jaxpr
            elif hasattr(x, "eqns"):
                yield x


def reference_saves(jaxpr, policy) -> list[Counter]:
    """For each ``checkpoint`` equation under ``policy`` (one per scanned
    group body): the element counts of its ``dot_general``s with no batch
    dims, each as many times as the scans inside run it.  A Pallas
    kernel's body is the kernel's, not the checkpoint's."""
    found = []

    def count(j, times, into):
        for e in j.eqns:
            name = e.primitive.name
            if name == "dot_general" and not e.params[
                    "dimension_numbers"][1][0]:
                into[int(np.prod(e.outvars[0].aval.shape))] += times
            if name == "pallas_call":
                continue
            inner = times * (e.params["length"] if name == "scan" else 1)
            for sub in _sub_jaxprs(e):
                count(sub, inner, into)

    def find(j):
        for e in j.eqns:
            if e.params.get("policy") is policy:
                found.append(Counter())
                for sub in _sub_jaxprs(e):
                    count(sub, 1, found[-1])
                continue
            for sub in _sub_jaxprs(e):
                find(sub)

    find(jaxpr)
    return found


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_dots_saves_the_reference_products(arch, monkeypatch):
    jax = pytest.importorskip("jax")
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    from repro import configs as jconfigs
    from repro.models import zoo as jzoo
    jcfg = jconfigs.reduced(jconfigs.get_config(arch),
                            **OVERRIDES.get(arch, {}))
    jp, _ = jzoo.init(jcfg, jax.random.key(0))
    cfg = port_cfg(arch)
    params, batch = port_inputs(cfg)
    jb = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    jaxpr = jax.make_jaxpr(
        lambda p: jzoo.loss_fn(jcfg, p, jb, remat="dots"))(jp).jaxpr
    want = reference_saves(
        jaxpr, jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    assert len(want) == 1 and sum(want[0].values()) > 0

    with chip_smoke.kept_products() as calls:
        accum.value_and_grad(
            lambda p, b: zoo.loss_fn(cfg, p, b, remat="dots"), params, batch)
    _, pattern, n_groups, _ = tf._plan(cfg)
    assert len(calls) == n_groups * len(pattern)
    for g in range(n_groups):
        got = Counter(n for layer in calls[g * len(pattern):
                                           (g + 1) * len(pattern)]
                      for n, _, _ in layer)
        # the reference's one checkpoint is the body its scan runs for
        # every group
        assert got == want[0], (g, sorted(got.items()),
                                sorted(want[0].items()))


# a batch unlike every arch's group count, so that the group scan's
# stacked residuals [n_groups, B, ...] are told from its carry [B, S, d]
SAVED_SHAPE = ShapeConfig("t", 32, 3, "train")


def reference_residuals(fn, args, n_groups: int, rows: int):
    """(the element counts a group of the residuals that the reference's
    decoder group scan stacks, as a Counter; the shapes of its other
    outputs that are residuals).  JAX's ``saved_residuals`` of ``fn``
    names each residual's origin: the decoder's scan is
    ``_run_blocks_seq``'s (whisper's encoder scan, ``_run_encoder``'s, is
    left out); a stacked residual is ``[n_groups, rows, ...]``."""
    from jax._src.ad_checkpoint import saved_residuals
    stacked, other = Counter(), []
    for aval, origin in saved_residuals(fn, *args):
        if "output of scan" not in origin or \
                "(_run_blocks_seq)" not in origin:
            continue
        if aval.shape[:2] == (n_groups, rows):
            stacked[int(np.prod(aval.shape[1:]))] += 1
        else:
            other.append(aval.shape)
    return stacked, other


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_dots_keeps_the_reference_residuals(arch, monkeypatch):
    """Left out on both sides: the final carry [B, S', d] of the
    reference's scan, which the final norm saves (the port's final norm
    saves its input outside any checkpoint); the reference's stacked
    residuals without a batch dim (whisper-tiny's layer index, which
    picks each layer's cross-attention weights); the encoder's output,
    which the reference's scan closes over and the port's checkpoints
    all hold, one tensor for every layer.  S' counts internvl2-1b's
    patch positions."""
    jax = pytest.importorskip("jax")
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    from repro import configs as jconfigs
    from repro.models import zoo as jzoo
    jcfg = jconfigs.reduced(jconfigs.get_config(arch),
                            **OVERRIDES.get(arch, {}))
    jp, _ = jzoo.init(jcfg, jax.random.key(0))
    cfg = port_cfg(arch)
    params, batch = port_inputs(cfg, SAVED_SHAPE)
    jb = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    _, pattern, n_groups, _ = tf._plan(cfg)
    rows = SAVED_SHAPE.global_batch
    assert n_groups != rows
    want, other = reference_residuals(
        lambda p: jzoo.loss_fn(jcfg, p, jb, remat="dots"), (jp,),
        n_groups, rows)
    for shape in other:
        # the carry, or no batch dim
        assert (len(shape) == 3 and shape[0] == rows
                and shape[2] == cfg.d_model) or rows not in shape[:2], shape

    inputs = []
    checkpoint = tf._grad_checkpoint

    def spy(fn, *args, dots=False):
        if dots:        # a group layer's (p, cp, x, enc_out)
            inputs.append(args[2].numel())
        return checkpoint(fn, *args, dots=dots)
    monkeypatch.setattr(tf, "_grad_checkpoint", spy)
    with chip_smoke.kept_products() as calls:
        accum.value_and_grad(
            lambda p, b: zoo.loss_fn(cfg, p, b, remat="dots"), params, batch)
    assert len(calls) == len(inputs) == n_groups * len(pattern)
    for g in range(n_groups):
        layers = range(g * len(pattern), (g + 1) * len(pattern))
        got = Counter(inputs[i] for i in layers)
        got.update(n for i in layers for n, _, kept in calls[i] if kept)
        assert got == want, (g, sorted(got.items()), sorted(want.items()))


# ---------------------------------------------------------------------------
# (b), (c) one process: the gradients and what runs again
# ---------------------------------------------------------------------------


class _Products(TorchDispatchMode):
    """Counts the matrix products dispatched; a kept product handed back
    to the recompute dispatches none."""

    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in PRODUCTS:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


@functools.cache
def policy_runs(arch):
    """By policy: (loss, gradient leaves, product counts, flash forward
    calls) of one ``loss_fn`` step of ``arch``."""
    cfg = port_cfg(arch)
    params, batch = port_inputs(cfg)
    forward = vjp.FlashAttention.forward
    out = {}
    for remat in REMATS:
        flash = []

        def counting(ctx, *a):
            flash.append(1)
            return forward(ctx, *a)
        vjp.FlashAttention.forward = staticmethod(counting)
        try:
            with _Products() as mode:
                loss, _, grads = accum.value_and_grad(
                    lambda p, b: zoo.loss_fn(cfg, p, b, remat=remat),
                    params, batch)
        finally:
            vjp.FlashAttention.forward = staticmethod(forward)
        out[remat] = (loss, list(tree_leaves(grads)), mode.counts,
                      len(flash))
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_gradients_equal_under_every_policy(arch):
    runs = policy_runs(arch)
    loss, grads, _, _ = runs["none"]
    for remat in ("dots", "full"):
        assert torch.equal(runs[remat][0], loss), remat
        assert len(runs[remat][1]) == len(grads)
        for a, b in zip(grads, runs[remat][1]):
            assert torch.equal(a, b), remat


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_the_recompute_reads_no_dropped_product(arch):
    """A ``"dots"`` step whose closing products come back to the
    recompute as NaN: one stand-in a checkpointed layer, and the loss and
    every gradient leaf bit for bit those of ``"none"`` and ``"full"``."""
    cfg = port_cfg(arch)
    params, batch = port_inputs(cfg)
    with ranks.nan_placeholder() as made:
        loss, _, grads = accum.value_and_grad(
            lambda p, b: zoo.loss_fn(cfg, p, b, remat="dots"), params, batch)
    _, pattern, n_groups, _ = tf._plan(cfg)
    assert len(made) == n_groups * len(pattern)
    grads = list(tree_leaves(grads))
    for remat in ("none", "full"):
        want_loss, want, _, _ = policy_runs(arch)[remat]
        assert torch.equal(loss, want_loss), remat
        assert len(grads) == len(want)
        for a, b in zip(grads, want):
            assert torch.equal(a, b), remat


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_dots_reruns_the_batched_work_alone(arch):
    runs = policy_runs(arch)
    none, dots, full = (runs[r][2] for r in REMATS)
    flash = {r: runs[r][3] for r in REMATS}
    saved = ("mm", "addmm")
    assert [dots[k] for k in saved] == [none[k] for k in saved]
    assert [dots[k] for k in ("bmm", "baddbmm")] == \
        [full[k] for k in ("bmm", "baddbmm")]
    assert flash["dots"] == flash["full"]
    # and "full" does rerun the products "dots" saves
    assert full["mm"] + full["addmm"] > none["mm"] + none["addmm"]
    assert flash["full"] > flash["none"] > 0 or arch == "rwkv6-7b"


# ---------------------------------------------------------------------------
# (d) mesh ranks, (e) the launchers' default device
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool():
    p = MeshPool(2, 1, device="cpu", timeout_s=60.0, threads=1)
    yield p
    p.close()


_MESH_RUNS = {}


def mesh_runs(pool, arch, mesh, fn=ranks.remat_steps, remats=REMATS):
    """``fn``'s results by rank on a ``mesh`` ("1x2", "2x1") of
    ``pool``, once a module."""
    key = (fn.__name__, arch, mesh, remats)
    if key not in _MESH_RUNS:
        data, model = (int(v) for v in mesh.split("x"))
        over = dict(OVERRIDES.get(arch, {}), vocab_size=16384)
        _MESH_RUNS[key] = pool.run(fn, arch, over, data, model, remats)
    return _MESH_RUNS[key]


def assert_ranks_equal(got, want, remats):
    """Each rank's state and metrics after the step under each of
    ``remats`` (``got``) equal to its own under ``"none"`` (``want``)."""
    for mine, rank in zip(got, want):
        state, metrics = rank["none"]
        for remat in remats:
            assert mine[remat][1] == metrics, remat
            assert set(mine[remat][0]) == set(state)
            for k, v in state.items():
                assert np.array_equal(mine[remat][0][k], v), (remat, k)


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_ranks_equal_under_every_policy(pool, arch, mesh):
    got = mesh_runs(pool, arch, mesh)
    assert_ranks_equal(got, got, ("dots", "full"))


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_ranks_read_no_dropped_product(pool, arch, mesh):
    """The ranks' ``"dots"`` step with NaN for each closing product in
    the recompute (``torch_train_ranks.nan_placeholder``): one stand-in
    a checkpointed layer on every rank, each rank's state and metrics
    its own under ``"none"``."""
    got = mesh_runs(pool, arch, mesh, ranks.remat_steps_nan, ("dots",))
    _, pattern, n_groups, _ = tf._plan(port_cfg(arch))
    assert [n for _, n in got] == [n_groups * len(pattern)] * len(got)
    assert_ranks_equal([r for r, _ in got], mesh_runs(pool, arch, mesh),
                       ("dots",))


def test_mesh_launchers_default_to_the_card(monkeypatch):
    assert MeshPool(1, 1, device="cpu").device == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert MeshPool(1, 1).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshPool(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.spawn_mesh(1, 1, print)


def test_a_recompute_that_diverges_raises():
    """The recompute must run the forward's products in order: one whose
    shapes differ from the kept one's stops the backward pass."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models import remat
    w1, w2 = torch.randn(4, 3, requires_grad=True), torch.randn(4, 5)
    passes = []

    def fn(x):
        passes.append(1)
        return remat.dot(x, w1 if len(passes) == 1 else w2.requires_grad_())
    y = checkpoint(fn, torch.randn(2, 4, requires_grad=True),
                   use_reentrant=False, context_fn=remat.contexts)
    with pytest.raises(RuntimeError, match="remat dots"):
        y.square().sum().backward()
