"""The port's radix prefix cache against the JAX package's, on the CPU.

The allocator and cache properties of ``tests/test_prefix_cache.py`` run
as the same operation sequences on both packages' ``PagedKVAllocator``
and ``PrefixCache``, their states compared after every operation:
refcounts, free lists, tables, the HBM ledger, lookups, probes, the
tree's held blocks.  Then the engine: warm output (a request admitted
over a cached prefix, mid-block) equals cold output on every paged text
arch the port serves, the port's warm run equals the JAX engine's tick
for tick (every stat but ``hbm``, ``kv_cache_share``,
``prefix_hit_tokens`` and ``prefix_cache_blocks`` among them, and the
copy-on-write count), ``serve.kv_cache_share``'s audit trail equals the
JAX engine's Decision for Decision, and block-level window eviction stays
off when the cache is on.  Weights: the JAX package's ``zoo.init``,
bridged.
"""

import collections
import json
import os
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.sensors import HBMAccountant as JAccountant
from repro.core.smartconf import ConfRegistry as JRegistry
from repro.core.telemetry import Telemetry as JTelemetry
from repro.models import zoo as jzoo
from repro.serve import PagedKVAllocator as JAlloc
from repro.serve import PrefixCache as JCache
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.core.sensors import HBMAccountant
from repro_torch.core.smartconf import ConfRegistry
from repro_torch.core.telemetry import Telemetry
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import (TICK_STATS_KEYS, PagedKVAllocator,
                               PrefixCache, Request, ServeEngine)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from test_torch_slo_serving import assert_decisions_match  # noqa: E402

# the paged text archs the port serves, MoE FFNs included (only the
# attention K/V is paged), as the reference's own test lists them
PAGED_ARCHS = ("yi-6b", "h2o-danube-3-4b", "gemma3-4b", "starcoder2-15b",
               "deepseek-moe-16b", "llama4-maverick-400b-a17b")
_MODELS: dict = {}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _models(arch):
    """reduced() ``arch`` in both packages, the port's weights bridged."""
    if arch not in _MODELS:
        jcfg = jax_reduced(jax_get_config(arch))
        jp, _ = jzoo.init(jcfg, jax.random.key(0))
        _MODELS[arch] = (jcfg, jp, reduced(get_config(arch)),
                         params_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu"))
    return _MODELS[arch]


def _pair(*, capacity=8, bps=4, bt=16, budget=None, ledger=False):
    """The same allocator in both packages (reduced yi-6b's block bytes)."""
    jcfg, _, cfg, _ = _models("yi-6b")
    accs = (JAccountant(), HBMAccountant()) if ledger else (None, None)
    return (JAlloc(jcfg, block_tokens=bt, max_blocks_per_seq=bps,
                   capacity_blocks=capacity, budget_blocks=budget,
                   accountant=accs[0]),
            PagedKVAllocator(cfg, block_tokens=bt, max_blocks_per_seq=bps,
                             capacity_blocks=capacity, budget_blocks=budget,
                             accountant=accs[1]), accs)


def _pool_state(pool, leases, acc=None):
    return {"refs": list(pool._refs), "free": sorted(pool._free),
            "used": pool.used_blocks, "capacity": pool.capacity,
            "budget": pool.max_blocks, "failures": pool.alloc_failures,
            "tables": [(list(ls.blocks), ls.tokens, ls.released)
                       for ls in leases],
            "ledger": (None if acc is None
                       else acc.breakdown().get("kv_cache"))}


def _tree_state(cache):
    out, stack = [], [(cache.root, 0)]
    while stack:
        nd, depth = stack.pop()
        out.append((depth, nd.edge.tolist(), list(nd.blocks), nd.last_used))
        stack.extend((c, depth + 1) for c in nd.children)
    return (sorted(out), cache.blocks_held, cache.lookups, cache.hits,
            cache.hit_tokens, cache.evicted_blocks)


# ------------------------------------------------------ refcounts and COW
def test_fork_shares_then_cow_rehomes():
    """A fork takes no block; ``writable`` re-homes exactly the shared
    blocks of its span; an out-of-order release keeps the child's blocks
    — the same ids, pairs and refcounts in both packages."""
    got = []
    for pool in _pair()[:2]:
        ls = pool.lease(48)
        child = ls.fork()
        pairs = child.writable(16, 40)
        steps = [pool.used_blocks, [ls.refcount(i) for i in range(3)],
                 pairs, list(child.blocks), list(ls.blocks),
                 child.writable(16, 40)]
        ls.release()
        steps.append(pool.used_blocks)
        child.release()
        steps += [pool.used_blocks, pool.free_blocks]
        got.append(steps)
    assert got[1] == got[0]
    assert got[1][0] == 5 and len(got[1][2]) == 2 and got[1][-2:] == [0, 8]


def test_shared_adoption_and_atomic_cow_failure():
    """A lease adopting live blocks (``shared=``) outlives its donor and a
    double release frees nothing twice; a ``writable`` that cannot source
    its copies changes nothing and counts a failure — in both
    packages."""
    got = []
    for pool in _pair()[:2]:
        donor = pool.lease(32)
        borrower = pool.lease(64, shared=list(donor.blocks))
        steps = [pool.used_blocks, list(borrower.blocks)]
        donor.release()
        steps += [pool.used_blocks, borrower.writable(0, 64)]
        borrower.release()
        borrower.release()
        steps += [pool.used_blocks, pool.free_blocks]
        got.append(steps)
    assert got[1] == got[0] and got[1][0] == 4 and got[1][-1] == 8
    got = []
    for pool in _pair(capacity=4)[:2]:
        ls = pool.lease(64)
        child = ls.fork()
        before = list(child.blocks)
        steps = [child.writable(0, 64), pool.alloc_failures,
                 list(child.blocks) == before,
                 [ls.refcount(i) for i in range(4)]]
        ls.release()
        child.release()
        got.append(steps + [pool.free_blocks])
    assert got[1] == got[0] == [None, 1, True, [2, 2, 2, 2], 4]


def test_allocator_sweep_matches_jax():
    """The reference's randomized lease / extend / fork / writable / trim /
    release interleaving with budget churn, on both pools in lockstep:
    every return value and, after every operation, the refcounts, free
    list, tables and HBM ledger equal; and the port's pool agrees with a
    mirror recomputed from its live tables (no leak, no double free)."""
    jpool, pool, (jacc, acc) = _pair(capacity=16, bps=4, ledger=True)
    rng = np.random.default_rng(7)
    live: list = []       # (jax lease, port lease)

    def same():
        assert (_pool_state(pool, [p for _, p in live], acc)
                == _pool_state(jpool, [j for j, _ in live], jacc))
        mirror = collections.Counter(b for _, ls in live
                                     for b in ls.blocks if b >= 0)
        assert [pool._refs[b] for b in range(pool.capacity)] == \
            [mirror.get(b, 0) for b in range(pool.capacity)]

    for step in range(300):
        op = int(rng.integers(0, 6))
        if op == 0:
            n = int(rng.integers(1, 65))
            a, b = jpool.lease(n), pool.lease(n)
            assert (a is None) == (b is None)
            if b is not None:
                live.append((a, b))
        elif op == 1 and live:
            a, b = live[int(rng.integers(len(live)))]
            n = b.tokens + int(rng.integers(1, 33))
            assert b.extend(n) == a.extend(n)
        elif op == 2 and live:
            a, b = live[int(rng.integers(len(live)))]
            live.append((a.fork(), b.fork()))
        elif op == 3 and live:
            a, b = live[int(rng.integers(len(live)))]
            lo = int(rng.integers(0, max(1, b.tokens)))
            hi = min(b.tokens, lo + int(rng.integers(1, 33)))
            assert b.writable(lo, hi) == a.writable(lo, hi)
        elif op == 4 and live:
            a, b = live[int(rng.integers(len(live)))]
            k = int(rng.integers(0, len(b.blocks) + 1))
            assert b.trim_front(k) == a.trim_front(k)
        elif op == 5 and live:
            a, b = live.pop(int(rng.integers(len(live))))
            a.release()
            b.release()
        if step % 3 == 0:
            k = int(rng.integers(4, 17))
            jpool.set_budget(k)
            pool.set_budget(k)
        same()
    for a, b in live:
        a.release()
        b.release()
    live.clear()
    same()
    assert pool.used_blocks == 0 and pool.free_blocks == pool.capacity


def test_cache_survives_borrower_release_and_compact():
    """COW-safe preemption at the tree level (a borrower's release keeps
    the tree's blocks), and a compaction renumbering tree-held ids through
    ``remap_hook`` — the same in both packages."""
    got = []
    for pool, cls in zip(_pair()[:2], (JCache, PrefixCache)):
        cache = cls(pool)
        pool.remap_hook = cache.remap
        prompt = np.arange(40, dtype=np.int32)
        donor = pool.lease(40)
        steps = [cache.insert(prompt, list(donor.blocks), 1)]
        donor.release()
        match, blocks = cache.lookup(prompt, 2)
        borrower = pool.lease(40, shared=blocks)
        steps += [match, list(blocks), pool.used_blocks]
        borrower.release()
        steps += [pool.used_blocks, cache.blocks_held]
        keep = pool.compact(2)
        m2, blocks2 = cache.lookup(prompt, 3)
        steps += [m2, [int(keep[b]) for b in blocks2] == blocks,
                  cache.clear(), pool.used_blocks]
        got.append(steps)
    assert got[1] == got[0] == [2, 32, got[0][2], 3, 2, 2, 32, True, 2, 0]


def test_prefix_cache_sweep_matches_jax():
    """Random prompts from a few shared stems (so edges split, siblings
    share less than a block, matches end mid-edge) through insert,
    lookup, probe, LRU eviction and ``enforce`` on both packages' caches
    over their own allocators: every return value and the whole tree
    (edges, blocks, LRU stamps, counters) equal after every operation."""
    jpool, pool, _ = _pair(capacity=64, bps=8, bt=4)
    caches = (JCache(jpool), PrefixCache(pool))
    for p, c in zip((jpool, pool), caches):
        p.remap_hook = c.remap
    rng = np.random.default_rng(3)
    stems = [rng.integers(0, 5, 12).astype(np.int32) for _ in range(3)]
    leases = []
    for now in range(200):
        stem = stems[int(rng.integers(3))]
        cut = int(rng.integers(0, 13))
        prompt = np.concatenate([stem[:cut], rng.integers(
            0, 5, int(rng.integers(1, 18))).astype(np.int32)])
        op = int(rng.integers(0, 5))
        if op == 0:
            outs = []
            for p, c in zip((jpool, pool), caches):
                ls = p.lease(len(prompt))
                if ls is None:
                    outs.append(None)
                    continue
                outs.append(c.insert(prompt, list(ls.blocks), now))
                ls.release()
            assert outs[1] == outs[0]
        elif op == 1:
            j, t = (c.lookup(prompt, now) for c in caches)
            assert t == j
        elif op == 2:
            assert caches[1].probe(prompt) == caches[0].probe(prompt)
        elif op == 3:
            assert (caches[1].evict_lru_leaf()
                    == caches[0].evict_lru_leaf())
        else:
            k = int(rng.integers(0, 20))
            assert caches[1].enforce(k) == caches[0].enforce(k)
        assert _tree_state(caches[1]) == _tree_state(caches[0])
        assert (_pool_state(pool, leases)["refs"]
                == _pool_state(jpool, leases)["refs"])
    assert caches[1].hit_rate == caches[0].hit_rate > 0
    assert caches[1].clear() == caches[0].clear()
    assert pool.used_blocks == jpool.used_blocks == 0


# ----------------------------------------------------------------- engine
def _prefix_prompts(cfg, seed=0, n=2, prefix=40, tail=24):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, cfg.vocab_size, prefix).astype(np.int32)
    return [np.concatenate([pre, rng.integers(0, cfg.vocab_size, tail)
                            .astype(np.int32)]) for _ in range(n)]


def _serial(eng, req_cls, prompts, max_new=6, on_tick=None):
    """Requests one after another (each one's prompt enters the cache
    before the next is submitted); the receipts and every tick's stats."""
    stats, receipts = [], []
    for i, p in enumerate(prompts):
        receipts.append(eng.submit(req_cls(i, p, max_new)))
        while len(eng.finished) < i + 1 and len(stats) < 400:
            stats.append(eng.tick())
            if on_tick is not None:
                on_tick(eng)
    return stats, receipts


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_warm_tokens_equal_cold(arch):
    """A request admitted over a cached prefix (40 tokens: a mid-block
    match, so its boundary block is copied) generates exactly the tokens
    the cold engine does, with reclaimed prefill and a copy on the warm
    side."""
    _, _, cfg, tp = _models(arch)
    prompts = _prefix_prompts(cfg)
    outs = {}
    for cache_on in (False, True):
        eng = ServeEngine(cfg, tp, device="cpu", max_batch=2, cache_len=96,
                          enable_smartconf=False, kv_mode="paged",
                          prefix_cache=cache_on)
        stats, receipts = _serial(eng, Request, prompts)
        assert len(eng.finished) == 2
        assert all(tuple(st) == TICK_STATS_KEYS for st in stats)
        assert receipts[1].footprint_blocks > 0
        if cache_on:
            assert receipts[1].prefix_hit_tokens == 40
            assert eng.prefix_hit_tokens_total == 40
            assert eng.cow_copied_blocks >= 1
            assert eng._prefix_cache.hit_rate > 0
        outs[cache_on] = {r.req_id: r.generated for r in eng.finished}
        eng.close()
    assert outs[True] == outs[False]


@pytest.fixture(scope="module")
def warm_runs(tmp_path_factory):
    """The same warm run (four prompts over one 40-token preamble, the
    later three submitted together and matching mid-block, a tight HBM
    goal, every knob live) on
    both engines with telemetry: every tick's stats but ``hbm``, the
    copies, the hits, the tokens and the audit trail's path."""
    jcfg, jp, cfg, tp = _models("yi-6b")
    prompts = _prefix_prompts(cfg, seed=4, n=4, prefix=40, tail=17)
    budget = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                 for x in jax.tree.leaves(jp)) + 400_000
    out = []
    for eng_cls, req_cls, c, p, reg, tel_cls in (
            (JServeEngine, JRequest, jcfg, jp, JRegistry, JTelemetry),
            (ServeEngine, Request, cfg, tp, ConfRegistry, Telemetry)):
        tel = tel_cls(enabled=True, clock=lambda: 0.0)
        kw = {} if eng_cls is JServeEngine else {"device": "cpu"}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng = eng_cls(c, p, max_batch=3, cache_len=96, kv_mode="paged",
                          prefix_cache=True, hbm_budget_bytes=budget,
                          latency_goal_s=0.01, telemetry=tel,
                          registry=reg(), clock=lambda: 0.0, **kw)
            stats = []
            eng.submit(req_cls(0, prompts[0], 5))
            while not eng.finished and len(stats) < 100:
                stats.append(eng.tick())
            for i in (1, 2, 3):
                eng.submit(req_cls(i, prompts[i], 5))
            while len(eng.finished) < 4 and len(stats) < 300:
                stats.append(eng.tick())
        paths = tel.write(str(tmp_path_factory.mktemp("audit")))
        out.append(dict(stats=[{k: v for k, v in st.items() if k != "hbm"}
                               for st in stats],
                        cow=eng.cow_copied_blocks,
                        hits=eng.prefix_hit_tokens_total,
                        tokens={r.req_id: r.generated
                                for r in eng.finished},
                        share=eng.kv_cache_share, audit=paths["audit"]))
        eng.close()
    return out


def test_warm_run_matches_jax_tick_for_tick(warm_runs):
    """Every tick's stats but ``hbm`` (``kv_cache_share``,
    ``prefix_hit_tokens`` and ``prefix_cache_blocks`` among them), the
    copies, the hits and the tokens equal the JAX engine's; and
    ``serve.kv_cache_share``'s Decisions, with the windowed hit rate they
    read, equal its audit trail Decision for Decision."""
    jx, port = warm_runs
    assert len(port["stats"]) == len(jx["stats"])
    for i, (got, want) in enumerate(zip(port["stats"], jx["stats"])):
        assert got == want, f"tick {i}"
    for key in ("cow", "hits", "tokens", "share"):
        assert port[key] == jx[key], key
    assert port["hits"] > 0 and port["cow"] > 0
    assert len({st["kv_cache_share"] for st in port["stats"]}) > 1
    assert_decisions_match(port["audit"], jx["audit"])


def test_kv_cache_share_controller_leaves_audit_trail(warm_runs):
    """``serve.kv_cache_share`` is actuated by a guarded SmartConf whose
    Decisions land in the audit log with the windowed ``prefix_hit_rate``
    reading, inside the actuator's bounds."""
    port = warm_runs[1]
    recs = [json.loads(x) for x in open(port["audit"])
            if '"serve.kv_cache_share"' in x]
    assert recs, "the cache-share controller left no Decisions"
    assert all(r["metric"] == "prefix_hit_rate" for r in recs)
    assert any(r["sensor"] > 0 for r in recs)
    assert 0.05 <= port["share"] <= 0.9


def test_window_eviction_stays_off_with_the_cache():
    """On an all-window arch the paged engine trims blocks below every
    live window; with the prefix cache on it must not (trimmed blocks
    cannot be shared), and tokens stay the cold engine's."""
    jcfg, jp, cfg, tp = _models("h2o-danube-3-4b")
    assert set(cfg.block_pattern) <= {"swa"}
    prompts = _prefix_prompts(cfg, seed=5, prefix=40, tail=20)
    outs = {}
    for cache_on in (False, True):
        eng = ServeEngine(cfg, tp, device="cpu", max_batch=2, cache_len=96,
                          enable_smartconf=False, kv_mode="paged",
                          prefix_cache=cache_on)
        jeng = JServeEngine(jcfg, jp, max_batch=2, cache_len=96,
                            enable_smartconf=False, kv_mode="paged",
                            prefix_cache=cache_on)
        assert eng._window_evict == jeng._window_evict == (not cache_on)
        jeng.close()
        trimmed = [0]

        def watch(e):
            for req in e.running.values():
                if req.lease is not None:
                    trimmed[0] = max(trimmed[0], sum(
                        1 for b in req.lease.blocks if b < 0))

        _serial(eng, Request, prompts, max_new=30, on_tick=watch)
        assert len(eng.finished) == 2
        assert (trimmed[0] > 0) == (not cache_on)
        outs[cache_on] = {r.req_id: r.generated for r in eng.finished}
        eng.close()
    assert outs[True] == outs[False]


def test_prefix_cache_needs_paged_kv():
    _, _, cfg, tp = _models("yi-6b")
    with pytest.raises(ValueError, match="paged KV"):
        ServeEngine(cfg, tp, device="cpu", max_batch=2, cache_len=96,
                    kv_mode="dense", prefix_cache=True)


@pytest.mark.parametrize("argv,want", [
    (["--prefix-cache", "--kv-mode", "paged", "--spec-depth", "2",
      "--no-spec-adaptive"], ["prefix cache", "COW copies", "spec depth 2"]),
    (["--trace", "poisson", "--horizon-s", "3", "--prefix-cache",
      "--prefix-groups", "2", "--prefix-len", "32", "--kv-cache-share",
      "0.4"], ["prefix cache hit rate", "prefill tokens reclaimed"])],
    ids=["batch", "trace"])
def test_launcher_flags_serve_on_cpu(monkeypatch, argv, want):
    """The launcher's prefix-cache and speculation flags build and serve
    (on the CPU, the reduced config), and its summary line reports them."""
    import io
    from contextlib import redirect_stdout
    from repro_torch.launch import serve as launch_serve
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "yi-6b",
                                      "--device", "cpu", "--requests", "4",
                                      *argv])
    out = io.StringIO()
    with redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        launch_serve.main()
    line = out.getvalue().strip().splitlines()[-1]
    for w in want:
        assert w in line, line
