"""What each rank of the mesh tests runs (``launch.mesh.MeshPool``).

Spawned ranks import this module by name; it imports the port and numpy
only, never JAX.  Inputs arrive and results leave as numpy arrays and
plain values.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.telemetry import Telemetry
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import use_mesh
from repro_torch.kernels.decode_attention import decode_attention_op
from repro_torch.kernels.paged_attention import paged_decode_attention_op
from repro_torch.kernels.segment_attention import (paged_segment_attention_op,
                                                   segment_attention_op)
from repro_torch.launch.mesh import make_host_mesh, world
from repro_torch.models import moe as moe_lib
from repro_torch.models import zoo
from repro_torch.models.bridge import params_from_numpy, tree_leaves
from repro_torch.serve import (ReplicaRouter, Request, ServeEngine,
                               ServeOptions, VirtualClock)

MAX_NEW = 6


def config(arch: str, overrides: dict):
    return reduced(get_config(arch), **overrides)


class RankClock:
    """A clock that runs ``rate`` times faster on each later rank: every
    reading advances it by ``step * (1 + rank)``, so the ranks' own tick
    times all differ."""

    def __init__(self, step: float) -> None:
        self.now = 0.0
        self.step = step * (1 + world()[1])

    def __call__(self) -> float:
        self.now += self.step
        return self.now


def serve(arch, overrides, weights, prompts, opts, budget_cut_tick=None,
          clock_step=None, hbm_headroom=None):
    """One engine over ``prompts`` (greedy, ``MAX_NEW`` tokens each):
    tokens by request, the shard count, the KV bytes of this rank, whether
    the store is paged, each tick's knobs, the Decision log (with
    ``clock_step``: SmartConf on a :class:`RankClock`), the warnings and
    this rank's expert leaf shapes."""
    cfg = config(arch, overrides)
    params = params_from_numpy(weights, "cpu")
    kw = {}
    tel = None
    if clock_step is not None:
        tel = Telemetry(enabled=True)
        kw = dict(clock=RankClock(clock_step), telemetry=tel)
        if hbm_headroom is not None:
            opts = dict(opts, hbm_budget_bytes=int(
                sum(t.numel() * t.element_size()
                    for t in tree_leaves(params)) + hbm_headroom))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = ServeEngine(cfg, params, options=ServeOptions(**opts),
                          device="cpu", **kw)
        for i, p in enumerate(prompts):
            assert eng.submit(Request(i, np.asarray(p, np.int32), MAX_NEW))
        t, shards, knobs = 0, None, []
        while len(eng.finished) < len(prompts) and t < 300:
            if budget_cut_tick is not None and t == budget_cut_tick:
                eng.set_kv_budget(max(2, eng.pool.max_blocks // 2))
            st = eng.tick()
            t += 1
            shards = st["tp_shards"]
            knobs.append((eng.max_queue_tokens, eng.pool.max_blocks,
                          eng.prefill_chunk, st["preemptions"]))
    out = {
        "outs": {r.req_id: [int(x) for x in r.generated]
                 for r in eng.finished},
        "ticks": t, "tp_shards": shards, "kv_shard_bytes":
            eng.kv_shard_bytes(), "paged": eng.paged, "knobs": knobs,
        "warnings": [str(w.message) for w in caught
                     if issubclass(w.category, RuntimeWarning)],
        "experts": _expert_shapes(eng.params),
        "decisions": ([d.to_dict() for d in tel.audit.records]
                      if tel is not None else None)}
    eng.close()
    return out


def router_shards(arch, weights, prompts, opts):
    """Two mesh engines behind a ``ReplicaRouter`` (a clock every rank
    reads alike): each tick's ``tp_shards`` and the tokens by request."""
    cfg = config(arch, {})
    params = params_from_numpy(weights, "cpu")
    vc = VirtualClock()
    engines = [ServeEngine(cfg, params, options=ServeOptions(**opts),
                           device="cpu", clock=vc) for _ in range(2)]
    router = ReplicaRouter(engines, clock=vc)
    for i, p in enumerate(prompts):
        assert router.submit(Request(i, np.asarray(p, np.int32), MAX_NEW))
    shards = []
    while sum(len(e.finished) for e in engines) < len(prompts):
        shards.append(router.tick()["tp_shards"])
        vc.advance(0.01)
        assert len(shards) < 300
    outs = {r.req_id: [int(x) for x in r.generated]
            for e in engines for r in e.finished}
    router.close()
    return shards, outs


def _expert_shapes(params) -> list:
    out = []

    def walk(tree):
        if isinstance(tree, dict):
            if "moe" in tree:
                out.append(tuple(tree["moe"]["w_gate"].shape))
            for v in tree.values():
                walk(v)
        elif isinstance(tree, list):
            for v in tree:
                walk(v)

    walk(params)
    return out


def build_engine_error(arch, overrides, weights, opts):
    """The ``ValueError`` text an engine with ``opts`` raises, or None,
    and the RuntimeWarnings it gave."""
    cfg = config(arch, overrides)
    params = params_from_numpy(weights, "cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            eng = ServeEngine(cfg, params, options=ServeOptions(**opts),
                              device="cpu")
        except ValueError as e:
            return str(e), []
    shards = eng.tp_shards
    eng.close()
    return shards, [str(w.message) for w in caught
                    if issubclass(w.category, RuntimeWarning)]


def _mesh(data: int, model: int):
    """This rank's mesh, or None on a rank past ``data * model`` (a
    ``1x2`` mesh on a pool of four)."""
    if world()[1] >= data * model:
        try:
            make_host_mesh(data=data, model=model)   # builds the groups
        except ValueError:
            return None
    return make_host_mesh(data=data, model=model)


def _t(case: dict, dtype=torch.float32) -> dict:
    return {k: (torch.from_numpy(v).to(dtype) if v.dtype == np.float32
                else torch.from_numpy(v)) for k, v in case.items()}


def _kv_chunk(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    n = x.shape[dim] // mesh.shape["model"]
    return x.narrow(dim, mesh.model_index * n, n).contiguous()


def tp_attention(data, model, kind, case, window, dtype_name):
    """``kind``'s single-device op and its TP wrapper on this rank's KV
    chunk of ``case``: both outputs (numpy, f32)."""
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        dtype_name]
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    x = _t(case, dtype)
    if kind == "segment":
        one = segment_attention_op(**x, window=window)
        loc = dict(x, k=_kv_chunk(x["k"], mesh, 1),
                   v=_kv_chunk(x["v"], mesh, 1))
        wrap = collectives.tp_segment_attention
    elif kind == "paged_segment":
        one = paged_segment_attention_op(**x, window=window)
        loc = dict(x, k_store=_kv_chunk(x["k_store"], mesh, 1),
                   v_store=_kv_chunk(x["v_store"], mesh, 1))
        wrap = collectives.tp_paged_segment_attention
    elif kind == "paged_decode":
        one = paged_decode_attention_op(**x, window=window)
        loc = dict(x, k_store=_kv_chunk(x["k_store"], mesh, 1),
                   v_store=_kv_chunk(x["v_store"], mesh, 1))
        wrap = collectives.tp_paged_decode_attention
    else:
        k = x["k"].transpose(1, 2)              # [B,Kv,S,D] views, as the
        v = x["v"].transpose(1, 2)              # model passes its rings
        one = decode_attention_op(x["q"], k, v, x["k_pos"], x["q_pos"],
                                  window=window)
        kl = _kv_chunk(x["k"], mesh, 2).transpose(1, 2)
        vl = _kv_chunk(x["v"], mesh, 2).transpose(1, 2)
        loc = dict(q=x["q"], k=kl, v=vl, k_pos=x["k_pos"], q_pos=x["q_pos"])
        wrap = collectives.tp_decode_attention
    with use_mesh(mesh):
        got = wrap(**loc, window=window)
    return one.float().numpy(), got.float().numpy()


def fail_on(rank: int):
    """Rank ``rank`` raises; the others enter a collective it never
    enters."""
    if world()[1] == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    torch.distributed.all_reduce(torch.zeros(1))


def mesh_index(data, model):
    """This rank's ``(data_index, model_index)`` in a ``data x model``
    mesh, or None on a rank past it."""
    mesh = _mesh(data, model)
    return None if mesh is None else (mesh.data_index, mesh.model_index)


def _store(eng) -> list:
    """``(blocks, KV heads)`` of every K/V plane of a paged store."""
    seen = []

    def look(a, ax):
        seen.append((a.shape[ax], a.shape[ax + 1]))
        return a

    zoo.map_paged_caches(eng.caches, look)
    return sorted(set(seen))


def resize_store(arch, weights, prompts, opts):
    """A paged engine whose store is cut to its least, then grown back by
    admissions as ``prompts`` are served: each tick's store planes
    ``(blocks, KV heads)`` and the tokens by request."""
    cfg = config(arch, {})
    eng = ServeEngine(cfg, params_from_numpy(weights, "cpu"),
                      options=ServeOptions(**opts), device="cpu")
    budget = eng.pool.max_blocks
    planes = [_store(eng)]
    eng.set_kv_budget(2)
    planes.append(_store(eng))
    eng.set_kv_budget(budget)
    for i, p in enumerate(prompts):
        assert eng.submit(Request(i, np.asarray(p, np.int32), MAX_NEW))
    while len(eng.finished) < len(prompts):
        eng.tick()
        planes.append(_store(eng))
        assert len(planes) < 300
    outs = {r.req_id: [int(x) for x in r.generated] for r in eng.finished}
    eng.close()
    return planes, outs


def moe_ep(data, model, arch, overrides, weights, x, valid, decode,
           one_group=False):
    """``moe_apply_ep`` (or ``moe_apply_ep_serve`` with ``decode``) of one
    MoE layer's weights on x [B, S, d] under the mesh, this rank holding
    only its experts (placed for a decode batch of ``data`` rows);
    ``moe_apply`` on the whole layer (with ``one_group``, its groups as
    long as x's rows); and both paths' dropped assignments."""
    cfg = config(arch, overrides)
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    params = params_from_numpy(weights, "cpu")
    xt = torch.from_numpy(x)
    vt = None if valid is None else torch.from_numpy(valid)
    drops = tuple(moe_lib.dropped_assignments(params["router"], xt, cfg, vt,
                                              grouped=g)
                  for g in (True, False))
    group_tokens = moe_lib.GROUP_TOKENS
    if one_group:
        moe_lib.GROUP_TOKENS = x.shape[1]
    try:
        whole = moe_lib.moe_apply(params, xt, cfg, valid=vt).numpy()
    finally:
        moe_lib.GROUP_TOKENS = group_tokens
    mine = moe_lib.place_experts({"moe": params}, cfg, mesh, data)["moe"]
    with use_mesh(mesh):
        if decode:
            got = moe_lib.moe_apply_ep_serve(mine, xt, cfg, valid=vt)
        else:
            got = moe_lib.moe_apply_ep(mine, xt, cfg, valid=vt)
    return got.numpy(), whole, tuple(mine["w_gate"].shape), drops
