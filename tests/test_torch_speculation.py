"""The port's self-speculative decode against the JAX package's, on the CPU.

The drafter (``NGramDrafter``) against the reference's on seeded
histories; ``markov_params`` bridged against the JAX one; ``step_spec``
against ``repro.models.zoo.step_spec`` — accept, per-offset tokens and
the caches after resolution — on paged attention, dense rings widened by
a margin (wrapped), RG-LRU with a windowed ring, and RWKV-6.  Then the
engine, the counterparts of ``tests/test_speculation.py``: speculative
output equals ``k = 0`` output on the six ported text archs with the
reference's corrupting oracle drafter (and on both KV modes for yi-6b and
gemma3-4b), always-rejected drafts, ``spec_depth = 0`` stat for stat the
JAX engine's, full acceptance under markov weights, ``sc_spec`` both ways,
rejected drafts that cannot poison the prefix cache, the telemetry
counters, a NaN accept-rate window under chaos; and ``bench_slo``'s
speculation lane, whose port run (``chip_smoke.run_spec``, what the card
runs) must equal the JAX lane tick for tick.  Tolerances: accept and
tokens exact; each cache leaf to ``1e-4`` times half its largest value
(at least ``1e-4``; f32, up to six layers deep).
"""

import dataclasses
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_slo as B
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import zoo as jzoo
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.speculation import NGramDrafter as JDrafter
from repro.serve.speculation import markov_params as jmarkov
from repro_torch.configs import get_config, reduced
from repro_torch.core.telemetry import Telemetry
from repro_torch.models import transformer, zoo
from repro_torch.models.bridge import keyed_leaves, params_from_numpy
from repro_torch.serve import (ChaosMonkey, ChaosSpec, NGramDrafter, Request,
                               ServeEngine)
from repro_torch.serve.speculation import markov_params

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as C  # noqa: E402

TEXT_ARCHS = ("yi-6b", "h2o-danube-3-4b", "gemma3-4b", "starcoder2-15b",
              "recurrentgemma-9b", "rwkv6-7b", "deepseek-moe-16b",
              "llama4-maverick-400b-a17b")
PROMPT_LENS = (5, 19, 33)
MAX_NEW = 6
ATOL = 1e-4
_MODELS: dict = {}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _models(arch):
    """reduced() ``arch`` in both packages, the port's weights bridged;
    MoE archs at capacity 8.0, as the reference's speculation tests run
    them (a spec segment groups its tokens unlike single decode tokens,
    and only drop-free routing makes the two token-identical)."""
    if arch not in _MODELS:
        extra = ({"capacity_factor": 8.0} if get_config(arch).moe else {})
        jcfg = jax_reduced(jax_get_config(arch), **extra)
        jp, _ = jzoo.init(jcfg, jax.random.key(0))
        _MODELS[arch] = (jcfg, jp, reduced(get_config(arch), **extra),
                         params_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu"))
    return _MODELS[arch]


def _prompts(cfg, lens=PROMPT_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
            for n in lens]


def _run(cfg, params, prompts, *, spec_depth=0, drafter=None,
         kv_mode="auto", max_new=MAX_NEW, **kw):
    """The reference test's ``_run`` on the port: two slots, SmartConf
    off, packed ticks; tokens by request and the spec counters."""
    eng = ServeEngine(cfg, params, device="cpu", max_batch=2, cache_len=96,
                      enable_smartconf=False, prefill_mode="packed",
                      kv_mode=kv_mode, spec_depth=spec_depth, **kw)
    if drafter is not None:
        eng._drafter = drafter
    for i, p in enumerate(prompts):
        eng.submit(Request(i, np.asarray(p, np.int32), max_new))
    ticks = max_dispatches = 0
    while len(eng.finished) < len(prompts) and ticks < 400:
        st = eng.tick()
        ticks += 1
        max_dispatches = max(max_dispatches, st["dispatches"])
    assert len(eng.finished) == len(prompts), cfg.name
    outs = {r.req_id: list(r.generated) for r in eng.finished}
    stats = dict(max_dispatches=max_dispatches, ticks=ticks,
                 proposed=eng.spec_proposed, accepted=eng.spec_accepted,
                 paged=eng.paged)
    eng.close()
    return outs, stats


# ---------------------------------------------------------------- drafter
def test_ngram_drafter_examples():
    """The reference's unit cases on the port's drafter."""
    hist = np.asarray([7, 1, 2, 3, 9, 1, 2], np.int32)
    d = NGramDrafter()
    d.begin(0, Request(0, hist, 4))
    np.testing.assert_array_equal(d.propose(0, 4), [3, 9, 1, 2])
    np.testing.assert_array_equal(d.propose(0, 2), [3, 9])
    d = NGramDrafter()
    d.begin(0, Request(0, np.arange(5, dtype=np.int32), 4))
    assert d.propose(0, 4).size == 0 and d.propose(0, 0).size == 0
    assert d.propose(7, 4).size == 0
    d.extend(7, [1, 2])
    d.extend(0, [3, 4])
    np.testing.assert_array_equal(d.propose(0, 3), [3, 4])
    d.drop(0)
    assert d.propose(0, 4).size == 0
    with pytest.raises(ValueError):
        NGramDrafter(ngram_max=0)


@pytest.mark.parametrize("ngram", [(3, 1), (2, 2), (4, 1)])
def test_ngram_drafter_matches_jax(ngram):
    """Seeded histories over a small vocabulary (so n-grams repeat),
    random extends, drops and proposals of every depth on both drafters:
    every proposal equal."""
    rng = np.random.default_rng(sum(ngram))
    hi, lo = ngram
    jd, td = JDrafter(ngram_max=hi, ngram_min=lo), NGramDrafter(
        ngram_max=hi, ngram_min=lo)
    for step in range(400):
        slot = int(rng.integers(0, 3))
        op = int(rng.integers(0, 10))
        if op == 0:
            p = rng.integers(0, 6, int(rng.integers(1, 30))).astype(np.int32)
            jd.begin(slot, JRequest(0, p, 4))
            td.begin(slot, Request(0, p, 4))
        elif op <= 4:
            toks = rng.integers(0, 6, int(rng.integers(1, 5)))
            jd.extend(slot, toks)
            td.extend(slot, toks)
        elif op == 5:
            jd.drop(slot)
            td.drop(slot)
        else:
            k = int(rng.integers(0, 9))
            want = jd.propose(slot, k)
            got = td.propose(slot, k)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- markov weights
def test_markov_params_bridged_equal_jax():
    """The same construction on both trees: every leaf equal (the blocks'
    ``wo`` and ``w_down`` zeroed), the f32 head to f32 rounding of the
    norm; the same ValueErrors."""
    jcfg, jp, cfg, tp = _models("yi-6b")
    mp = {t: (t + 1) % 8 for t in range(8)}
    want = dict((jax.tree_util.keystr(k), np.asarray(v)) for k, v in
                jax.tree_util.tree_flatten_with_path(jmarkov(jcfg, jp, mp))[0])
    got = markov_params(cfg, tp, mp)
    got = {k: v.numpy() for k, v in keyed_leaves(got)}
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        if k == "['head']":
            np.testing.assert_allclose(got[k], w, atol=1e-7, rtol=0)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert not got["['groups'][0]['attn']['wo']"].any()
    assert not got["['groups'][0]['mlp']['w_down']"].any()
    crowd = {t: 5 for t in range(300)}
    with pytest.raises(ValueError, match="cross-talk") as e_t:
        markov_params(cfg, tp, crowd)
    with pytest.raises(ValueError, match="cross-talk") as e_j:
        jmarkov(jcfg, jp, crowd)
    assert str(e_t.value) == str(e_j.value)
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    with pytest.raises(ValueError, match="untied"):
        markov_params(tied, tp, mp)
    with pytest.raises(ValueError, match="untied"):
        jmarkov(dataclasses.replace(jcfg, tie_embeddings=True), jp, mp)


# ---------------------------------------------------------- the model step
STEP_CASES = {
    # (arch, kv, prompt lengths): slots 0 and 1 decode with drafts, slot 2
    # prefills its next chunk in the same stream
    "paged-yi-6b": ("yi-6b", "paged", (21, 30, 25)),
    "dense-gemma3-4b-margin": ("gemma3-4b", "dense", (45, 52, 25)),
    "rglru-recurrentgemma-9b": ("recurrentgemma-9b", "dense", (45, 52, 25)),
    "rwkv6-rwkv6-7b": ("rwkv6-7b", "dense", (21, 30, 25)),
    "paged-deepseek-moe-16b": ("deepseek-moe-16b", "paged", (21, 30, 25)),
    "dense-llama4-maverick-400b-a17b": ("llama4-maverick-400b-a17b",
                                        "dense", (21, 30, 25)),
}


def _stream(segs, width, b, l_max):
    """``segs`` = [(slot, start, tokens, spec)] packed in order: the
    step's arrays, spec_idx as the engine builds it."""
    tokens = np.zeros((1, width), np.int32)
    slot_id = np.full(width, -1, np.int32)
    pos = np.zeros(width, np.int32)
    start = np.zeros(b, np.int32)
    seg_len = np.zeros(b, np.int32)
    spec_rows = np.zeros(b, bool)
    spec_idx = np.zeros((b, l_max), np.int32)
    draft_len = np.zeros(b, np.int32)
    c = 0
    for slot, st, toks, spec in segs:
        n = len(toks)
        tokens[0, c:c + n] = toks
        slot_id[c:c + n] = slot
        pos[c:c + n] = np.arange(st, st + n)
        start[slot], seg_len[slot] = st, n
        if spec:
            spec_rows[slot] = True
            spec_idx[slot] = c + np.minimum(np.arange(l_max), n - 1)
            draft_len[slot] = n - 1
        else:
            spec_idx[slot] = c + n - 1
        c += n
    return (tokens, slot_id, pos, start, seg_len, spec_rows, spec_idx,
            draft_len)


def _jax_tree(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_spec_matches_jax(case):
    """A prefill step, then one spec stream: slot 0 carries its true
    continuation with its third draft corrupted (accept 2), slot 1 its
    true continuation (accept 4), slot 2 its prompt's next chunk.  accept
    and the per-offset tokens equal the JAX step's exactly, the caches
    after resolution (rolled back recurrent state included) to 1e-4."""
    arch, kv, lens = STEP_CASES[case]
    jcfg, jp, cfg, tp = _models(arch)
    b, t, cache_len, l_max, margin = 3, 16, 96, 5, 4
    m = cache_len // t
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    if kv == "paged":
        bt = rng.permutation(b * m).astype(np.int32).reshape(b, m)
        jc = jzoo.init_paged_cache(jcfg, b * m, t)
        tc = zoo.init_paged_cache(cfg, b * m, t, "cpu")
        jbt, tbt = jnp.asarray(bt), torch.from_numpy(bt)
    else:
        jc = jzoo.init_cache(jcfg, b, cache_len, ring_margin=margin)
        tc = zoo.init_cache(cfg, b, cache_len, "cpu", ring_margin=margin)
        jbt = tbt = None
    # prefill: slots 0 and 1 whole, slot 2 its first 10 tokens
    segs = [(0, 0, prompts[0], False), (1, 0, prompts[1], False),
            (2, 0, prompts[2][:10], False)]
    arrs = _stream(segs, 128, b, l_max)[:5]
    want, jc = jzoo.step_packed(jcfg, jp, jc, *map(jnp.asarray, arrs),
                                block_tables=jbt)
    got = zoo.step_packed(cfg, tp, tc, *map(torch.from_numpy, arrs),
                          block_tables=tbt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    first = np.asarray(want).argmax(-1).astype(np.int32)
    # the true continuations of slots 0 and 1: four greedy JAX steps
    # (the JAX steps store their new caches into the tree they are given:
    # roll on a copy of its containers)
    cont, jroll, cur = {0: [], 1: []}, jax.tree.map(lambda a: a, jc), \
        first[:2].copy()
    for j in range(4):
        s = [(r, lens[r] + j, cur[r:r + 1], False) for r in (0, 1)]
        lg, jroll = jzoo.step_packed(jcfg, jp, jroll, *map(
            jnp.asarray, _stream(s, 16, b, l_max)[:5]), block_tables=jbt)
        cur = np.asarray(lg).argmax(-1).astype(np.int32)[:2]
        for r in (0, 1):
            cont[r].append(int(cur[r]))
    bad = list(cont[0][:3])
    bad[2] = (bad[2] + 1) % cfg.vocab_size
    segs = [(0, lens[0], np.asarray([first[0]] + bad, np.int32), True),
            (1, lens[1], np.asarray([first[1]] + cont[1], np.int32), True),
            (2, 10, prompts[2][10:], False)]
    arrs = _stream(segs, 32, b, l_max)
    ja, jt, jc = jzoo.step_spec(jcfg, jp, jc, *map(jnp.asarray, arrs),
                                block_tables=jbt)
    ta, tt = zoo.step_spec(cfg, tp, tc, *map(torch.from_numpy, arrs),
                           block_tables=tbt)
    assert np.asarray(ja).tolist()[:2] == [2, 4]
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    want = _jax_tree(jc)
    got = {k: v.numpy() for k, v in keyed_leaves(tc)}
    assert got.keys() == want.keys()
    for k, w in want.items():
        # f32 sums in another order, six layers deep, on entries up to ~9
        tol = ATOL * max(1.0, float(np.abs(w).max()) / 2)
        np.testing.assert_allclose(got[k], w, atol=tol, rtol=0, err_msg=k)
    if kv == "dense" and "pos" in str(want.keys()):
        rings = {w.shape[-1] for k, w in want.items() if k.endswith("['pos']")}
        assert rings == set(transformer.ring_lens(tc))


# ------------------------------------------- engine: spec equals k = 0
@pytest.mark.parametrize("arch", TEXT_ARCHS)
def test_spec_matches_plain_every_text_arch(arch):
    """Every ported text arch (paged where the arch allows, dense rings
    and recurrent state elsewhere): the speculating engine gives the k = 0
    engine's tokens in one dispatch a tick, drafts corrupted on a fixed
    schedule so partial accepts and rejections both occur, slots reused
    (three prompts, two slots)."""
    _, _, cfg, tp = _models(arch)
    prompts = _prompts(cfg)
    plain, _ = _run(cfg, tp, prompts)
    oracle = C.OracleDrafter(plain, cfg.vocab_size, corrupt_every=2)
    spec, st = _run(cfg, tp, prompts, spec_depth=3, drafter=oracle)
    assert spec == plain, arch
    assert st["max_dispatches"] == 1
    assert 0 < st["accepted"] < st["proposed"]


@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-4b"])
@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
def test_spec_dense_and_paged_explicit(arch, kv_mode):
    """Dense rings (gemma3's windowed ones widened by the margin) and
    paged write-then-gather with a rejected suffix overwritten."""
    _, _, cfg, tp = _models(arch)
    prompts = _prompts(cfg)
    plain, _ = _run(cfg, tp, prompts, kv_mode=kv_mode)
    oracle = C.OracleDrafter(plain, cfg.vocab_size, corrupt_every=2)
    spec, st = _run(cfg, tp, prompts, spec_depth=4, drafter=oracle,
                    kv_mode=kv_mode)
    assert spec == plain, (arch, kv_mode)
    assert st["paged"] == (kv_mode == "paged")
    assert st["max_dispatches"] == 1
    assert 0 < st["accepted"] < st["proposed"]


def test_spec_always_rejected_is_still_identical():
    """Every draft wrong: the output does not move, and the engine takes
    exactly the ticks of k = 0."""
    _, _, cfg, tp = _models("yi-6b")
    prompts = _prompts(cfg, (19,))
    plain, plain_st = _run(cfg, tp, prompts, max_new=8)
    bad = {r: [(t + 1) % cfg.vocab_size for t in toks]
           for r, toks in plain.items()}
    spec, st = _run(cfg, tp, prompts, spec_depth=4, max_new=8,
                    drafter=C.OracleDrafter(bad, cfg.vocab_size))
    assert spec == plain
    assert st["proposed"] > 0 and st["accepted"] == 0
    assert st["ticks"] == plain_st["ticks"]


def test_spec_off_is_todays_path():
    """``spec_depth = 0`` builds no drafter, counts nothing, and equals
    the JAX engine's k = 0 run stat for stat (every key but ``hbm``);
    speculation off the packed path is refused."""
    jcfg, jp, cfg, tp = _models("yi-6b")
    prompts = _prompts(cfg, (9, 30, 14))
    runs = []
    for eng_cls, req_cls, c, p, kw in (
            (JServeEngine, JRequest, jcfg, jp, {}),
            (ServeEngine, Request, cfg, tp, {"device": "cpu"})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng = eng_cls(c, p, max_batch=2, cache_len=96,
                          hbm_budget_bytes=sum(
                              int(np.prod(x.shape)) * x.dtype.itemsize
                              for x in jax.tree.leaves(jp)) + 300_000,
                          latency_goal_s=0.01, clock=lambda: 0.0, **kw)
            for i, pr in enumerate(prompts):
                eng.submit(req_cls(i, pr, 5))
            stats = [eng.tick() for _ in range(30)]
        assert not eng.spec_enabled and eng._drafter is None
        assert eng.spec_proposed == eng.spec_accepted == 0
        runs.append([{k: v for k, v in st.items() if k != "hbm"}
                     for st in stats])
        eng.close()
    assert runs[1] == runs[0]
    assert all(st["spec_depth"] == 0 and st["spec_lanes"] == 0
               for st in runs[1])
    with pytest.raises(ValueError, match="packed"):
        ServeEngine(cfg, tp, device="cpu", max_batch=2, cache_len=96,
                    prefill_mode="bucketed", spec_depth=2)


# --------------------------------------------------- markov regimes
@pytest.fixture(scope="module")
def markov():
    _, _, cfg, tp = _models("yi-6b")
    return cfg, markov_params(cfg, tp, {t: (t + 1) % 8 for t in range(8)})


def test_markov_full_accept_regime(markov):
    """Weights whose decode is a token cycle: the n-gram drafter reads the
    cycle out of the prompt, nearly every draft lands, and the engine
    finishes in fewer ticks with the same tokens."""
    cfg, params = markov
    prompts = [np.tile(np.arange(8, dtype=np.int32), 3)]
    plain, plain_st = _run(cfg, params, prompts, max_new=16)
    assert plain[0] == [(24 + i) % 8 for i in range(16)]
    spec, st = _run(cfg, params, prompts, spec_depth=4, max_new=16)
    assert spec == plain
    assert st["accepted"] / st["proposed"] > 0.8
    assert st["ticks"] < plain_st["ticks"]
    assert st["max_dispatches"] == 1


def test_sc_spec_depth_adapts_both_ways(markov):
    """A fully predictable stream deepens the draft from its initial 2;
    an always-rejected one drives it to the floor of 1, never 0."""
    cfg, params = markov
    eng = ServeEngine(cfg, params, device="cpu", max_batch=2, cache_len=96,
                      prefill_mode="packed", spec_depth=2)
    assert eng.sc_spec is not None
    eng.submit(Request(0, np.tile(np.arange(8, dtype=np.int32), 3), 48))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(400):
            if eng.finished:
                break
            eng.tick()
    assert eng.finished and eng.spec_depth > 2
    assert eng.sc_spec.sensor_faults == 0
    eng.close()
    _, _, cfg2, tp2 = _models("yi-6b")
    prompts = _prompts(cfg2, (19,))
    plain, _ = _run(cfg2, tp2, prompts, max_new=24)
    bad = {0: [(t + 1) % cfg2.vocab_size for t in plain[0]]}
    eng = ServeEngine(cfg2, tp2, device="cpu", max_batch=2, cache_len=96,
                      prefill_mode="packed", spec_depth=4)
    eng._drafter = C.OracleDrafter(bad, cfg2.vocab_size)
    eng.submit(Request(0, prompts[0], 24))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(400):
            if eng.finished:
                break
            eng.tick()
    assert list(eng.finished[0].generated) == plain[0]
    assert eng.spec_depth == 1
    eng.close()


def test_rejected_drafts_cannot_poison_prefix_cache():
    """Request A decodes with every draft rejected, and its output
    extension enters the radix cache at its finish; request B's prompt
    extends A's accepted stream and hits over those blocks, and its
    output equals a cold engine's without speculation."""
    _, _, cfg, tp = _models("yi-6b")
    p1 = _prompts(cfg, (26,), seed=3)[0]
    ref1, _ = _run(cfg, tp, [p1], kv_mode="paged", max_new=8)
    bad = {0: [(t + 1) % cfg.vocab_size for t in ref1[0]]}
    eng = ServeEngine(cfg, tp, device="cpu", max_batch=2, cache_len=96,
                      enable_smartconf=False, prefill_mode="packed",
                      kv_mode="paged", prefix_cache=True, spec_depth=4)
    eng._drafter = C.OracleDrafter(bad, cfg.vocab_size)
    eng.submit(Request(0, p1, 8))
    while not eng.finished:
        eng.tick()
    assert eng.spec_proposed > 0 and eng.spec_accepted == 0
    gen1 = list(eng.finished[0].generated)
    assert gen1 == ref1[0]
    p2 = np.concatenate([p1, np.asarray(gen1[:7], np.int32)])
    eng._drafter = NGramDrafter()
    eng.submit(Request(1, p2, 8))
    while len(eng.finished) < 2:
        eng.tick()
    warm = eng.finished[1]
    assert warm.prefix_hit > 16, "the extension's blocks serve the hit"
    eng.close()
    ref2, _ = _run(cfg, tp, [p2], kv_mode="paged", max_new=8)
    assert list(warm.generated) == ref2[0]


def test_spec_telemetry_counters_and_audit(markov):
    cfg, params = markov
    tel = Telemetry(enabled=True)
    eng = ServeEngine(cfg, params, device="cpu", max_batch=2, cache_len=96,
                      prefill_mode="packed", spec_depth=2, telemetry=tel)
    eng.submit(Request(0, np.tile(np.arange(8, dtype=np.int32), 3), 16))
    last = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        while not eng.finished:
            last = eng.tick()
    m = tel.metrics
    assert m.counter("serve.spec.proposed").value == eng.spec_proposed > 0
    assert m.counter("serve.spec.accepted").value == eng.spec_accepted > 0
    assert m.histogram("serve.spec.accepted_len").mean() > 0
    assert last["spec_depth"] == eng.spec_depth
    assert 0.0 <= last["accept_rate"] <= 1.0
    des = tel.audit.query(conf="serve.spec_depth")
    assert des and all(d.metric == "accept_rate" and d.sane for d in des)
    eng.close()


def test_spec_chaos_nan_accept_rate(markov):
    """A NaN accept-rate window with speculation live: the guardrails
    count the insane readings, the depth stays in bounds, every request
    finishes with the map's tokens."""
    cfg, params = markov
    eng = ServeEngine(cfg, params, device="cpu", max_batch=2, cache_len=96,
                      prefill_mode="packed", spec_depth=2)
    chaos = ChaosMonkey(ChaosSpec(
        seed=0, sensor_fault_tick=2, sensor_fault_ticks=10,
        sensor_fault_mode="nan", sensor_names=("accept_rate",))).install(eng)
    prompt = np.tile(np.arange(8, dtype=np.int32), 3)
    for i in range(3):
        eng.submit(Request(i, prompt, 16))
    ticks = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        while len(eng.finished) < 3 and ticks < 400:
            chaos(None, ticks)
            eng.tick()
            ticks += 1
    want = [(24 + i) % 8 for i in range(16)]
    assert all(list(r.generated) == want for r in eng.finished)
    assert len(eng.finished) == 3
    assert eng.sc_spec.sensor_faults > 0
    assert any(n.startswith("sensor_nan:accept_rate")
               for _, n in chaos.events)
    assert 1 <= eng.spec_depth <= eng.spec_depth_max
    eng.close()


# ------------------------------------------ bench_slo's speculation lane
@pytest.fixture(scope="module")
def jax_spec_lane():
    """The reference's adaptive spec run, every tick's stats recorded."""
    jcfg = jax_reduced(jax_get_config("yi-6b"))
    cyc = np.arange(1, B.SPEC_CYCLE + 1)
    jp = jmarkov(jcfg, jzoo.init(jcfg, jax.random.key(0))[0],
                 {int(cyc[i]): int(cyc[(i + 1) % B.SPEC_CYCLE])
                  for i in range(B.SPEC_CYCLE)})
    ticks = []
    tick = JServeEngine.tick

    def recorded(self):
        st = tick(self)
        ticks.append({k: v for k, v in st.items() if k != "hbm"})
        return st

    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setattr(JServeEngine, "tick", recorded)
        r = B._run_spec_policy(jcfg, jp, B.SMOKE_HORIZON_S, depth=2,
                               adaptive=True)
    r["per_tick"] = ticks
    return r


@pytest.fixture(scope="module")
def port_spec_lane():
    """The port's lane on the CPU (``chip_smoke.run_spec``): adaptive and
    every static depth, markov weights from the port's own seed-0 init
    (no controller reading depends on a weight)."""
    cfg = reduced(get_config("yi-6b"))
    params = markov_params(cfg, zoo.init(cfg, torch.Generator().manual_seed(0),
                                         "cpu"), C.cycle_map())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = {"adaptive": C.run_spec(cfg, params, "cpu", depth=2,
                                      adaptive=True)}
        for k in C.SPEC_STATIC_DEPTHS:
            res[f"static_k{k}"] = C.run_spec(cfg, params, "cpu", depth=k,
                                             adaptive=False)
    return res


def test_spec_lane_constants_are_bench_slos():
    assert (C.SPEC_CYCLE, C.SPEC_RATE_RPS, C.SPEC_LANE_S,
            C.SPEC_STATIC_DEPTHS) == (B.SPEC_CYCLE, B.SPEC_RATE_RPS,
                                      B.SPEC_LANE_S, B.SPEC_STATIC_DEPTHS)


def test_spec_lane_matches_jax_tick_for_tick(jax_spec_lane, port_spec_lane):
    ad = port_spec_lane["adaptive"]
    assert len(ad["per_tick"]) == ad["ticks"] == jax_spec_lane["ticks"]
    for i, (got, want) in enumerate(zip(ad["per_tick"],
                                        jax_spec_lane["per_tick"])):
        assert got == want, f"tick {i}"
    for key in ("goodput_tokens_by_tier", "reject_counts", "preemptions",
                "sensor_faults", "chaos_events", "proposed", "accepted",
                "final_depth", "goodput_tps", "throughput_tps", "finished"):
        assert ad[key] == jax_spec_lane[key], key


def test_spec_lane_adaptive_beats_every_static_depth(port_spec_lane):
    """The bench's gates on the port, and strictly above every static
    depth; the reverse laps leave the adaptive depth at its floor."""
    assert C.lane_faults(port_spec_lane, "spec") == []
    ad = port_spec_lane["adaptive"]
    assert ad["final_depth"] == 1
    for name, r in port_spec_lane.items():
        assert r["max_dispatches"] == 1, name
        if name != "adaptive":
            assert ad["goodput_tps"] > r["goodput_tps"], name
