"""The port's serving collectives and EP MoE across gloo processes.

One ``MeshPool`` of four ranks serves every case; a ``1x2`` mesh runs on
its first two ranks (the other two return None).  Each piece is held to
the JAX package on the same numpy inputs and to the port's single-device
path:

* the head-parallel attention wrappers (flat and paged segment, paged and
  dense decode), each rank holding only its KV head chunk, equal the
  port's single-device op bit for bit and the JAX plain op within the
  kernels' tolerance, at ``1x2`` and ``2x2``;
* ``moe_apply_ep`` at the packed tick's ``[1, P]`` (tokens replicated;
  P short, longer than a 512-token group, and prime) and
  ``moe_apply_ep_serve`` at decode's ``[B, 1]`` equal the port's and the
  JAX ``moe_apply`` within 2e-5 in f32 at ample capacity, where neither
  drops an assignment (the same routing), each rank holding ``E / M``
  experts;
* at a tight capacity the EP bodies drop as ``moe_apply`` does
  over one group of the whole stream, which is not how ``moe_apply``
  groups a stream longer than 512 tokens or of prime length;
* ``CacheShardingPlan.leaf_spec`` and ``shard_bytes`` equal the
  reference's on paged, group-stacked and dense cache trees.
"""

import time
import types

import jax
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.decode_attention import decode_attention_ref
from repro.kernels.paged_attention import paged_decode_attention_ref
from repro.kernels.segment_attention import (paged_segment_attention_ref,
                                             segment_attention_ref)
from repro.models import moe as jmoe
from repro.models import zoo as jzoo
from repro.serve.block_store import CacheShardingPlan as JaxPlan
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import MeshPool
from repro_torch.models import zoo
from repro_torch.serve.block_store import CacheShardingPlan
from test_torch_kernels import IDLE_ROW, decode_case, flat_case, segment_case

MESHES = [(1, 2), (2, 2)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def pool():
    p = MeshPool(2, 2, timeout_s=60.0, threads=1)
    yield p
    p.close()


def _live(results, data, model):
    out = results[:data * model]
    assert all(r is not None for r in out)
    return out


def dense_case(rng, *, h, kv, d=16, s=40):
    """Rings [B, S, Kv, D] with ragged written positions (-1 unwritten)
    and keys ahead of a row's query; the last row has one key."""
    b = 4
    k_pos = np.full((b, s), -1, np.int32)
    q_pos = np.array([17, 39, 60, 0], np.int32)
    for r in range(3):
        n = int(rng.integers(10, min(s, q_pos[r] + 5)))
        k_pos[r, :n] = rng.permutation(q_pos[r] + 5)[:n]
    k_pos[3, 7] = 0
    return dict(q=rng.standard_normal((b, h, d)).astype(np.float32),
                k=rng.standard_normal((b, s, kv, d)).astype(np.float32),
                v=rng.standard_normal((b, s, kv, d)).astype(np.float32),
                k_pos=k_pos, q_pos=q_pos)


CASES = {"segment": flat_case, "paged_segment": segment_case,
         "paged_decode": decode_case, "dense_decode": dense_case}


def _jax_want(kind, case, window):
    jnp = jax.numpy
    x = {k: jnp.asarray(v) for k, v in case.items()}
    if kind == "segment":
        return segment_attention_ref(**x, window=window)
    if kind == "paged_segment":
        return paged_segment_attention_ref(**x, window=window)
    if kind == "paged_decode":
        return paged_decode_attention_ref(**x, window=window)
    return decode_attention_ref(x["q"], x["k"].transpose(0, 2, 1, 3),
                                x["v"].transpose(0, 2, 1, 3), x["k_pos"],
                                x["q_pos"], window=window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("h,kv", [(4, 2), (8, 4)])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("kind", list(CASES))
def test_tp_attention_equals_one_device(pool, kind, mesh, h, kv, window,
                                        dtype):
    case = CASES[kind](np.random.default_rng(h + kv + window), h=h, kv=kv)
    got = _live(pool.run(ranks.tp_attention, *mesh, kind, case, window,
                         dtype), *mesh)
    one = got[0][0]
    for single, tp in got:
        np.testing.assert_array_equal(tp, one)        # bit for bit
        np.testing.assert_array_equal(single, one)
    if dtype == "float32":
        want = np.asarray(_jax_want(kind, case, window), np.float32)
        if kind == "paged_decode":    # the idle row: the kernels give zeros
            one, want = np.delete(one, IDLE_ROW, 0), np.delete(want,
                                                               IDLE_ROW, 0)
        np.testing.assert_allclose(one, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])


# the packed tick's [1, P] stream (tokens replicated): short, longer than
# one 512-token group of moe_apply, and of prime length (moe_apply's
# groups are then single tokens); decode's [B, 1]
MOE_SHAPES = {"packed": (1, 37), "long": (1, 600), "prime": (1, 1031),
              "decode": (4, 1)}
MOE_ARCHS = ["deepseek-moe-16b", "llama4-maverick-400b-a17b"]


def _moe_case(arch, shape, masked, capacity=None):
    over = {} if capacity is None else {"capacity_factor": capacity}
    jcfg = jax_reduced(jax_get_config(arch), **over)
    jp, _ = jmoe.moe_init(jax.random.key(0), jcfg)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(shape + (jcfg.d_model,)).astype(np.float32)
    valid = (rng.random(shape) < 0.7) if masked else None
    return jcfg, jp, over, x, valid


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", list(MOE_SHAPES))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ep_matches_moe_apply(pool, arch, mesh, kind, masked):
    jcfg, jp, over, x, valid = _moe_case(arch, MOE_SHAPES[kind], masked,
                                         capacity=8.0)
    got = _live(pool.run(ranks.moe_ep, *mesh, arch, over,
                         jax.tree.map(np.asarray, jp), x, valid,
                         kind == "decode"), *mesh)
    want = np.asarray(jmoe.moe_apply(
        jp, jax.numpy.asarray(x), jcfg,
        valid=None if valid is None else jax.numpy.asarray(valid)))
    for out, whole, experts, drops in got:
        assert drops == (0, 0)          # the same routing on both paths
        np.testing.assert_allclose(whole, want, atol=2e-5, rtol=2e-4)
        np.testing.assert_allclose(out, whole, atol=2e-5, rtol=2e-4)
        assert experts[0] == jcfg.num_experts // mesh[1]
    for out, _, _, _ in got[1:]:
        np.testing.assert_array_equal(out, got[0][0])


@pytest.mark.parametrize("kind", ["long", "prime"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ep_caps_over_the_whole_stream(pool, arch, mesh, kind):
    """At a capacity tight enough that both paths drop (1.0), the EP
    bodies cap each expert over all of the stream's tokens: they equal
    ``moe_apply`` over one group of the whole stream, not ``moe_apply``
    over its 300-token (or, at a prime length, one-token) groups, which
    drops other assignments."""
    jcfg, jp, over, x, valid = _moe_case(arch, MOE_SHAPES[kind], True,
                                         capacity=1.0)
    got = _live(pool.run(ranks.moe_ep, *mesh, arch, over,
                         jax.tree.map(np.asarray, jp), x, valid, False,
                         True), *mesh)
    for out, one_group, _, (grouped, ep) in got:
        np.testing.assert_allclose(out, one_group, atol=2e-5, rtol=2e-4)
        assert ep > 0 and grouped != ep, (grouped, ep)


def _key(path) -> tuple:
    """A JAX tree path as the port's path: dict keys and list indices."""
    return tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)


@pytest.mark.parametrize("model", [2, 3])
@pytest.mark.parametrize("arch,paged", [
    ("yi-6b", True), ("deepseek-moe-16b", True), ("gemma3-4b", False),
    ("recurrentgemma-9b", False), ("yi-6b", False)])
def test_cache_plan_matches_jax(arch, paged, model):
    """Specs leaf by leaf and per-rank bytes, on the same trees: paged
    stores (stacked and prefix layers), dense rings (stacked and
    remainder layers) with their position planes, recurrent state, and a
    Kv dim the axis cannot divide (recurrentgemma's single KV head, 4 KV
    heads over 3)."""
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    if paged:
        jtree = jzoo.init_paged_cache(jcfg, 6, 4)
        tree = zoo.init_paged_cache(cfg, 6, 4, "cpu")
    else:
        jtree = jzoo.init_cache(jcfg, 2, 24)
        tree = zoo.init_cache(cfg, 2, 24, "cpu")
    mesh = types.SimpleNamespace(shape={"model": model}, model_index=0)
    jplan = JaxPlan(mesh, paged=paged)
    plan = CacheShardingPlan(mesh, paged=paged)
    want = {_key(p): tuple(jplan.leaf_spec(p, a))
            for p, a in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    got = {}

    def walk(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            got[path] = plan.leaf_spec(path, t)

    walk(tree)
    assert got == want
    assert plan.shard_bytes(tree) == jplan.shard_bytes(jtree)
    if paged and cfg.num_kv_heads % model == 0:
        assert plan.shard_bytes(tree) * model == sum(
            a.numel() * a.element_size() for a in
            (leaf for c in tree.values() for d in c for leaf in d.values()))
    sharded = [s for s in got.values() if "model" in s]
    assert bool(sharded) == (cfg.num_kv_heads % model == 0)


def test_a_failing_rank_fails_the_call_at_once(pool):
    """One rank raises while the others wait in a collective it never
    enters: the call fails with its traceback within seconds, not at
    gloo's timeout, and the pool serves the next call on fresh ranks."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        pool.run(ranks.fail_on, 1)
    assert time.monotonic() - t0 < 30.0
    got = pool.run(ranks.mesh_index, 1, 2)
    assert got == [(0, 0), (0, 1), None, None]
