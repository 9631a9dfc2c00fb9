"""The port's mesh serving on the CPU, across gloo processes.

The four sections of the reference's mesh suite (``tests/test_mesh_serve.py``),
on the port: one ``MeshPool`` of four ranks (a ``2x2`` mesh: the reduced
configs have 4 KV heads, so ``model = 2`` shards every attention arch)
started once for the module and fed every case.  The ranks import only
the port (``torch_mesh_ranks``); this process runs the JAX engine on one
device and the port on one device for the same weights (``zoo.init``,
seed 0, through the bridge) and prompts.

* every text arch serves token-identically under the mesh — rank 0's
  greedy tokens equal the single-device port's and the JAX engine's, on
  every rank — paged and dense KV, speculation on, prefix cache and
  copy-on-write live where the reference uses them; a paged store's
  per-rank bytes times the shard count equal the single-device total;
* explicit dense KV under TP (rings shard on the Kv dim too);
* a mid-flight KV budget cut stays identical;
* recurrentgemma-9b's single KV head cannot shard: it serves on a
  ``4x1`` mesh (the data axis only) instead, the reference's forced
  single-device fallback having no counterpart in the port;
* a paged store cut to its least and grown back by admissions keeps each
  rank's KV head chunk;
* infeasible meshes raise the reference's ``ValueError`` words;
* the launcher's ``--mesh`` with a telemetry hub serves and writes rank
  0's files;
* with SmartConf on and a clock that runs at another rate on each rank,
  every rank takes the same decisions (the agreed clock), with no
  collective left waiting.
"""

import io
import re
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import zoo as jzoo
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import ServeOptions as JServeOptions
from repro.serve.block_store import build_serve_mesh as jax_build_serve_mesh
from repro.serve.block_store import parse_mesh_spec as jax_parse_mesh_spec
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import MeshPool
from repro_torch.serve import SLOSpec
from repro_torch.serve.block_store import build_serve_mesh, parse_mesh_spec

TEXT = ["h2o-danube-3-4b", "starcoder2-15b", "yi-6b", "gemma3-4b",
        "deepseek-moe-16b", "llama4-maverick-400b-a17b", "rwkv6-7b",
        "recurrentgemma-9b"]
MESH = "2x2"


@pytest.fixture(scope="module")
def pool():
    p = MeshPool(2, 2, timeout_s=60.0, threads=1)
    yield p
    p.close()


def _overrides(arch) -> dict:
    # ample capacity -> deterministic routing for equivalence
    return {"capacity_factor": 8.0} if jax_get_config(arch).moe else {}


def _weights(arch):
    jcfg = jax_reduced(jax_get_config(arch), **_overrides(arch))
    params, _ = jzoo.init(jcfg, jax.random.key(0))
    return jcfg, params, jax.tree.map(np.asarray, params)


def _opts(mesh=None, kv="auto", prefix=False, spec=2, **kw) -> dict:
    return dict(max_batch=2, cache_len=64, enable_smartconf=False,
                prefill_mode="packed", kv_mode=kv, spec_depth=spec,
                prefix_cache=prefix, mesh=mesh, **kw)


def _jax_run(jcfg, params, prompts, opts, budget_cut_tick=None):
    """The reference's ``run`` on one device: tokens by request."""
    eng = JServeEngine(jcfg, params, options=JServeOptions(**opts))
    for i, p in enumerate(prompts):
        assert eng.submit(JRequest(i, p, ranks.MAX_NEW))
    t = 0
    while len(eng.finished) < len(prompts) and t < 300:
        if budget_cut_tick is not None and t == budget_cut_tick:
            eng.set_kv_budget(max(2, eng.pool.max_blocks // 2))
        eng.tick()
        t += 1
    assert len(eng.finished) == len(prompts), (jcfg.name, t)
    outs = {r.req_id: [int(x) for x in r.generated] for r in eng.finished}
    eng.close()
    return outs


def _prompts(vocab, seed, lens, shared=False):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in lens]
    if shared:
        prompts[1][:8] = prompts[0][:8]     # shared prefix: radix hits + COW
    return prompts


def _hold(pool, arch, prompts, opts, budget_cut_tick=None):
    """JAX engine, the port on one device and the port on the mesh, on the
    same weights: every rank's tokens equal both single-device runs'.
    Returns the single-device port run and the ranks' runs."""
    jcfg, jparams, weights = _weights(arch)
    one_opts = dict(opts, mesh=None)
    want = _jax_run(jcfg, jparams, prompts, one_opts, budget_cut_tick)
    one = ranks.serve(arch, _overrides(arch), weights, prompts, one_opts,
                      budget_cut_tick)
    assert one["outs"] == want, arch
    got = pool.run(ranks.serve, arch, _overrides(arch), weights, prompts,
                   opts, budget_cut_tick)
    for r, res in enumerate(got):
        assert res["outs"] == want, (arch, r)
    return one, got


@pytest.mark.parametrize("arch", TEXT)
def test_mesh_tokens_equal_one_device(pool, arch):
    jcfg = jax_reduced(jax_get_config(arch))
    prompts = _prompts(jcfg.vocab_size, 7, (9, 17, 26), shared=True)
    prefix = jzoo.supports_paged_kv(jcfg)
    if jcfg.num_kv_heads % 2:
        # kv_heads the model axis cannot divide: the data axis alone
        one, got = _hold(pool, arch, prompts, _opts("4x1", prefix=prefix))
        assert [res["tp_shards"] for res in got] == [1] * 4
        return
    one, got = _hold(pool, arch, prompts, _opts(MESH, prefix=prefix))
    assert one["tp_shards"] == 1
    for res in got:
        assert res["tp_shards"] == 2, arch
        if res["paged"]:   # paged stores are pure K/V planes: shards sum
            assert res["kv_shard_bytes"] * 2 == one["kv_shard_bytes"]
    if jcfg.moe:           # a rank holds E / M experts
        e = jcfg.num_experts
        assert all(s[-3] == e for s in one["experts"])
        assert all(s[-3] == e // 2 for res in got for s in res["experts"])


@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-moe-16b"])
def test_mesh_dense_kv_equals_one_device(pool, arch):
    vocab = jax_reduced(jax_get_config(arch)).vocab_size
    prompts = _prompts(vocab, 11, (7, 21))
    one, got = _hold(pool, arch, prompts, _opts(MESH, kv="dense"))
    assert not one["paged"]
    for res in got:
        assert not res["paged"] and res["tp_shards"] == 2
        # the rings' K/V planes shard, their position planes do not
        assert res["kv_shard_bytes"] < one["kv_shard_bytes"]


def test_mesh_kv_budget_cut_equals_one_device(pool):
    vocab = jax_reduced(jax_get_config("yi-6b")).vocab_size
    prompts = _prompts(vocab, 13, (12, 18, 25))
    one, got = _hold(pool, "yi-6b", prompts, _opts(MESH),
                     budget_cut_tick=4)
    for res in got:
        assert res["tp_shards"] == 2
        assert res["knobs"] == one["knobs"]


def test_resized_store_keeps_its_head_chunk(pool):
    """The budget cut and the admissions' grows move whole blocks: after
    each, every rank's K/V planes hold its 2 of the 4 KV heads, the
    store's block count follows one device's tick for tick, and so do the
    tokens."""
    arch = "yi-6b"
    _, _, weights = _weights(arch)
    kv = jax_reduced(jax_get_config(arch)).num_kv_heads
    prompts = _prompts(jax_reduced(jax_get_config(arch)).vocab_size, 17,
                       (14, 30, 9))
    one_planes, one_outs = ranks.resize_store(arch, weights, prompts,
                                              _opts(None, spec=0))
    blocks = [sorted({n for n, _ in p}) for p in one_planes]
    assert blocks[1] < blocks[0] and max(blocks[2:]) > blocks[1]  # cut, grown
    assert {h for p in one_planes for _, h in p} == {kv}
    for planes, outs in pool.run(ranks.resize_store, arch, weights, prompts,
                                 _opts(MESH, spec=0)):
        assert [sorted({n for n, _ in p}) for p in planes] == blocks
        assert {h for p in planes for _, h in p} == {kv // 2}
        assert outs == one_outs


@pytest.mark.parametrize("arch,mesh,prefill,match", [
    ("yi-6b", "4x4", "packed", "16 devices"),
    ("recurrentgemma-9b", "1x2", "packed", "kv_heads"),
    ("yi-6b", "1x2", "bucketed", "packed stream")],
    ids=["4x4-on-4-ranks", "kv_heads-explicit", "bucketed-prefill"])
def test_infeasible_mesh(pool, arch, mesh, prefill, match):
    """An infeasible mesh raises the reference's words on every rank."""
    _, _, weights = _weights(arch)
    got = pool.run(ranks.build_engine_error, arch, _overrides(arch),
                   weights, dict(_opts(mesh), prefill_mode=prefill))
    for err, warned in got:
        assert isinstance(err, str) and match in err, err
        assert "is infeasible" in err and not warned


def _reasons(msg: str) -> list[str]:
    """The problems of an infeasible-mesh message, each without the remedy
    in parentheses (the reference's names a JAX flag)."""
    body = msg.split("is infeasible: ", 1)[1]
    return [re.sub(r" \((XLA_FLAGS=|start )[^)]*\)$", "", p)
            for p in body.split("; ")]


@pytest.mark.parametrize("spec", ["2x4", "1X1", " 8 x 1 ", "2x", "x4",
                                  "2x4x1", "ax b", "2", "0x4"])
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jax_parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(spec)
        assert str(got.value) == str(e)
        return
    assert parse_mesh_spec(spec) == want


@pytest.mark.parametrize("spec,heads,kv,impl", [
    ("2x4", 4, 4, "packed"), ("1x1", 4, 4, "bucketed"),
    ("2x4", 4, 1, "legacy"), ("1x3", 6, 2, "packed")])
def test_build_serve_mesh_reasons_match_jax(spec, heads, kv, impl):
    """One visible device here, for both packages: the same problems in
    the same words."""
    with pytest.raises(ValueError) as want:
        jax_build_serve_mesh(spec, heads=heads, kv_heads=kv,
                             prefill_impl=impl, env_forced=False)
    with pytest.raises(ValueError) as got:
        build_serve_mesh(spec, heads=heads, kv_heads=kv, prefill_impl=impl)
    assert _reasons(str(got.value)) == _reasons(str(want.value))


def test_router_reports_the_mesh(pool):
    """Engines on a mesh behind the replica router: every merged tick
    reports the engines' model-axis shards, and the tokens equal one
    device's."""
    arch = "yi-6b"
    _, _, weights = _weights(arch)
    vocab = jax_reduced(jax_get_config(arch)).vocab_size
    prompts = _prompts(vocab, 5, (11, 23, 7, 16))
    got = pool.run(ranks.router_shards, arch, weights, prompts,
                   _opts(MESH, spec=0))
    one = ranks.router_shards(arch, weights, prompts, _opts(None, spec=0))
    assert set(one[0]) == {1}
    for shards, outs in got:
        assert set(shards) == {2}
        assert outs == one[1]


def test_ranks_agree_under_smartconf(pool):
    """SmartConf on (HBM goal, decode-latency goal, TTFT SLO) with a clock
    that runs 1x, 2x, 3x and 4x on the four ranks: every rank's Decision
    log, knob trajectory and tokens are the same."""
    arch = "yi-6b"
    _, _, weights = _weights(arch)
    vocab = jax_reduced(jax_get_config(arch)).vocab_size
    prompts = _prompts(vocab, 3, (20, 9, 30, 14, 25))
    opts = _opts(MESH, spec=0)
    opts.update(enable_smartconf=True, latency_goal_s=0.004,
                slo=SLOSpec(ttft_s=0.05))
    got = pool.run(ranks.serve, arch, {}, weights, prompts, opts, None,
                   0.001, 500_000)
    first = got[0]
    assert sorted(first["outs"]) == list(range(len(prompts)))
    assert len({d["conf"] for d in first["decisions"]}) == 4
    for res in got[1:]:
        assert res["decisions"] == first["decisions"]
        assert res["knobs"] == first["knobs"]
        assert res["outs"] == first["outs"]


@pytest.mark.parametrize("mode", [[], ["--trace", "poisson", "--horizon-s",
                                       "3", "--ttft-slo-s", "1"]],
                         ids=["closed-loop", "trace"])
def test_launcher_mesh_with_telemetry(monkeypatch, tmp_path, mode):
    """``--mesh 1x2 --telemetry-dir``: both ranks keep a hub (it reads the
    agreed clock, a collective), rank 0 prints the summary and writes the
    files, and no rank waits in a collective the other never enters."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "yi-6b", "--device", "cpu", "--mesh", "1x2",
        "--requests", "3", "--max-new-tokens", "4", "--telemetry-dir",
        str(tmp_path)] + mode)
    out = io.StringIO()
    with redirect_stdout(out):
        launch_serve.main()
    lines = out.getvalue().strip().splitlines()
    assert lines[-1].startswith("telemetry: ")
    if not mode:
        assert "mesh 1x2: 2-way TP ticks" in lines[-2]
    else:
        assert "unhandled 0" in lines[-2]
    assert {p.name for p in tmp_path.iterdir()} >= {
        "trace.json", "metrics.json", "audit.jsonl", "flight.json"}
