"""The modality frontends of the port against the JAX package, on the CPU.

internvl2-1b's vision prefix (the connector's patch embeddings before the
tokens) and whisper-tiny's encoder-decoder (the ``bidir`` encoder, learned
positions, a cross-attention after every decoder block) at ``reduced()``
sizes in f32, on the JAX package's weights carried across with
``params_from_numpy`` and on numpy-seeded inputs.  ``init`` leaves
``pos_emb`` at zeros, so the weights bridged here carry a random one: a
test on init'd weights would never see the addition or its index.

Held to the JAX package: ``_inputs_embeds`` and the connector,
``_run_encoder``, ``forward`` (remat off and on), the one-shot
``prefill`` and decode steps that attend to ``enc_out`` (logits and
caches), ``loss_fn`` and every gradient leaf (the ``cross`` and
``connector`` leaves among them; remat off and on), ``make_batch``, and
the serve engine tick for tick (greedy tokens, every tick's stats but
the weight-dependent ``hbm``, ``slot_pos``, the ``RuntimeWarning`` that
``auto`` resolves to the one-shot path with, the admission rejections at
``npatch + prompt + new > cache_len``).  Also: the explicit chunked modes
and the stream steps refuse the frontends, the launcher serves them, the
Trainer names the input its data stream lacks, ``make_train_step``
trains on ``make_batch``, and the flash plain versions and
``layers.attention`` take keys of another length than the queries
(without a mask only) against the JAX oracle on padded-equal lengths and
a numpy softmax.

Tolerances: logits and hidden states ``atol=1e-4, rtol=1e-5``, as
``test_torch_models.py`` holds logits; the loss ``2e-5`` relative and
each gradient leaf ``2e-4`` of its largest magnitude, as
``test_torch_train.py``; the plain flash versions ``2e-5`` (gradients
``atol=5e-6, rtol=5e-5``), as ``test_torch_flash_attention.py``.
"""

import io
import sys
import warnings
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.models import transformer as jtf
from repro.models import zoo as jzoo
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 attention_bwd_ref,
                                                 attention_lse_ref,
                                                 attention_ref)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers, transformer, zoo
from repro_torch.models.bridge import keyed_leaves, params_from_numpy
from repro_torch.optim import accum, adamw
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCHS = ["internvl2-1b", "whisper-tiny"]
ATOL, RTOL = 1e-4, 1e-5
LOSS_RTOL, GRAD_REL = 2e-5, 2e-4
FLASH_TOL = 2e-5
FLASH_GRAD_TOL = dict(atol=5e-6, rtol=5e-5)
REMATS = ["none", "dots"]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _weights(arch, seed=0):
    """(JAX config, JAX params, port config, port params): the JAX
    package's init with a random ``pos_emb`` for the encoder-decoder."""
    jcfg = jax_reduced(jax_get_config(arch))
    params, _ = jzoo.init(jcfg, jax.random.key(seed))
    host = jax.tree.map(np.asarray, params)
    if "pos_emb" in host:
        rng = np.random.default_rng(seed + 100)
        host["pos_emb"] = (rng.standard_normal(host["pos_emb"].shape)
                           .astype(np.float32) * 0.3)
    return (jcfg, jax.tree.map(jnp.asarray, host), reduced(get_config(arch)),
            params_from_numpy(host, "cpu"))


def _batches(jcfg, cfg, seq_len, kind="train", b=2, seed=3):
    """The same batch for both packages, each from its own ``make_batch``
    on a numpy generator seeded alike."""
    jb = jzoo.make_batch(jcfg, JShapeConfig("t", seq_len, b, kind),
                         np.random.default_rng(seed))
    tb = zoo.make_batch(cfg, ShapeConfig("t", seq_len, b, kind),
                        np.random.default_rng(seed), "cpu")
    return jb, tb


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------ init, batch
@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_jax_layout(arch):
    jcfg, jp, cfg, _ = _weights(arch)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    mine = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert shapes(mine) == shapes(jp)
    if cfg.encoder_decoder:
        assert not mine["pos_emb"].any()        # zeros, as the reference
        assert mine["cross"]["attn"]["wq"].shape[0] == cfg.num_layers
        assert mine["encoder"]["attn"]["wq"].shape[0] == cfg.enc_layers
    else:
        w1 = mine["connector"]["w1"]
        assert float(w1.abs().max()) <= 1 / np.sqrt(cfg.frontend_dim)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_batch_matches_jax(arch, kind):
    jcfg, _, cfg, _ = _weights(arch)
    jb, tb = _batches(jcfg, cfg, 40, kind)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert tb[k].dtype == (torch.int32 if k in ("tokens", "labels")
                               else torch.float32)
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert zoo.token_seq_len(cfg, 40) == jzoo.token_seq_len(jcfg, 40)


# ------------------------------------------------- frontends, encoder
@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_embeds_match_jax(arch):
    """The connector on random patches before the token embeddings (the
    vision prefix); the token embeddings alone for the encoder-decoder,
    whose ``pos_emb`` the callers add."""
    jcfg, jp, cfg, tp = _weights(arch)
    jb, tb = _batches(jcfg, cfg, 30, "prefill")
    jx, jpos = jtf._inputs_embeds(jcfg, jp, jb)
    tx, tpos = transformer._inputs_embeds(cfg, tp, tb)
    assert tx.shape == jx.shape
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    _close(tx, jx)
    if cfg.frontend == "vision":
        assert tx.shape[1] == cfg.num_patches + tb["tokens"].shape[1]


def test_run_encoder_matches_jax():
    jcfg, jp, cfg, tp = _weights("whisper-tiny")
    _, tb = _batches(jcfg, cfg, 10, "prefill")
    want = jtf._run_encoder(jcfg, jp, jnp.asarray(tb["frames"].numpy()))
    got = transformer._run_encoder(cfg, tp, tb["frames"])
    assert got.shape == (2, cfg.enc_seq, cfg.d_model)
    _close(got, want)


# ----------------------------------------------- forward, prefill, decode
@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, remat):
    jcfg, jp, cfg, tp = _weights(arch)
    jb, tb = _batches(jcfg, cfg, 40)
    want, _ = jzoo.forward(jcfg, jp, jb, remat=remat)
    got, aux = zoo.forward(cfg, tp, tb, remat=remat)
    _close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    """A one-shot prefill, then three decode steps (the last with row 1
    left out) attending to ``enc_out``: logits every step, and the rings
    and ``enc_out`` at the end."""
    jcfg, jp, cfg, tp = _weights(arch)
    jb, tb = _batches(jcfg, cfg, 33, "prefill")
    jlg, jc = jzoo.prefill(jcfg, jp, jb, cache_len=64)
    tlg, tc = zoo.prefill(cfg, tp, tb, cache_len=64)
    _close(tlg, jlg)
    npatch = cfg.num_patches if cfg.frontend == "vision" else 0
    pos0 = tb["tokens"].shape[1] + npatch
    rng = np.random.default_rng(5)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        pos = np.full(2, pos0 + step, np.int32)
        act = None if step < 2 else np.array([True, False])
        jlg, jc = jzoo.decode_step(
            jcfg, jp, jc, jnp.asarray(tok), jnp.asarray(pos),
            active=None if act is None else jnp.asarray(act))
        tlg = zoo.decode_step(cfg, tp, tc, torch.from_numpy(tok),
                              torch.from_numpy(pos),
                              active=None if act is None
                              else torch.from_numpy(act))
        _close(tlg, jlg)
    ring = tc["groups"][0]
    for name in ("k", "v", "pos"):
        _close(ring[name], jc["groups"][0][name])
    if cfg.encoder_decoder:
        assert sorted(tc) == ["enc_out", "groups"]
        _close(tc["enc_out"], jc["enc_out"])


@pytest.mark.parametrize("arch", ARCHS)
def test_merge_slot_moves_every_leaf(arch):
    """A one-row prefill merged into slot 1 of a two-slot cache: the
    rings and ``enc_out`` of that row equal the one-row tree's, row 0 is
    untouched (the reference's ``merge_fn``)."""
    _, _, cfg, tp = _weights(arch)
    tb = zoo.make_batch(cfg, ShapeConfig("p", 20, 1, "prefill"),
                        np.random.default_rng(1), "cpu")
    _, one = zoo.prefill(cfg, tp, tb, cache_len=64)
    full = zoo.init_cache(cfg, 2, 64, "cpu")
    before = {k: v.clone() for k, v in full["groups"][0].items()}
    zoo.merge_slot(full, one, 1)
    for n, a in full["groups"][0].items():
        torch.testing.assert_close(a[:, 1], one["groups"][0][n][:, 0])
        torch.testing.assert_close(a[:, 0], before[n][:, 0])
    if cfg.encoder_decoder:
        torch.testing.assert_close(full["enc_out"][1], one["enc_out"][0])
        assert not full["enc_out"][0].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_steps_refuse_the_frontends(arch):
    """No chunk form: the packed and chunked steps raise, as the engine
    never calls them for these archs."""
    _, _, cfg, tp = _weights(arch)
    assert not zoo.supports_chunked_prefill(cfg)
    assert not zoo.supports_paged_kv(cfg)
    caches = zoo.init_cache(cfg, 2, 32, "cpu")
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="modality frontend"):
        zoo.prefill_chunk(cfg, tp, caches, torch.zeros((2, 4), dtype=torch.int32),
                          z, z + 4)
    with pytest.raises(ValueError, match="modality frontend"):
        zoo.step_packed(cfg, tp, caches, torch.zeros((1, 4), dtype=torch.int32),
                        torch.zeros(4, dtype=torch.int32),
                        torch.arange(4, dtype=torch.int32), z, z)


# --------------------------------------------------------------- training
def _jax_keyed(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    jcfg, jp, cfg, tp = _weights(arch)
    jb, tb = _batches(jcfg, cfg, 40)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jzoo.loss_fn(jcfg, p, jb, remat=remat), has_aux=True)(jp)
    loss, aux, grads = accum.value_and_grad(
        lambda p, b: zoo.loss_fn(cfg, p, b, remat=remat), tp, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["ce"]), float(jaux["ce"]),
                               rtol=LOSS_RTOL)
    want = _jax_keyed(jg)
    got = dict(keyed_leaves(grads))
    assert set(got) == set(want)
    frontend = "connector" if cfg.frontend == "vision" else "cross"
    assert any(k.startswith(f"['{frontend}']") for k in got)
    for key, t in got.items():
        a = want[key]
        err = np.abs(_np(t) - a).max()
        assert err <= GRAD_REL * max(np.abs(a).max(), 1e-30), (key, err)
        if key.startswith(("['connector']", "['cross']", "['pos_emb']")):
            assert np.abs(a).max() > 0, key       # the leaf is reached


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_trains_on_make_batch(arch):
    """``make_train_step`` on ``make_batch`` batches, three AdamW steps:
    finite losses that fall on a repeated batch, every leaf updated."""
    _, _, cfg, tp = _weights(arch)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    step = ts.make_train_step(cfg, opt)
    state = adamw.init(tp)
    batch = zoo.make_batch(cfg, ShapeConfig("t", 24, 2, "train"),
                           np.random.default_rng(0), "cpu")
    before = {k: v.clone() for k, v in keyed_leaves(tp)}
    losses = []
    params = tp
    for _ in range(3):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    moved = {k for k, v in keyed_leaves(params)
             if not torch.equal(v, before[k])}
    assert "['cross']['attn']['wq']" in moved or "['connector']['w1']" in \
        moved


@pytest.mark.parametrize("arch,missing", [("internvl2-1b", "patches"),
                                          ("whisper-tiny", "frames")])
def test_trainer_names_the_missing_input(arch, missing, tmp_path):
    """The data stream yields tokens and labels only: the reference's
    trainer stops on a KeyError at its first step, the port's refuses
    with the input's name before it allocates anything."""
    cfg = reduced(get_config(arch))
    with pytest.raises(ValueError, match=f"batch\\['{missing}'\\]"):
        Trainer(cfg, adamw.AdamWConfig(), TrainerConfig(
            workdir=str(tmp_path), total_steps=1, batch_size=1, seq_len=16),
            device="cpu")


# ------------------------------------------------------------------ engine
class Clock:
    def __init__(self) -> None:
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def _serve(eng, req_cls, prompts, max_new, clock):
    adm = [bool(eng.submit(req_cls(i, p, max_new)))
           for i, p in enumerate(prompts)]
    ticks = []
    while (len(eng.finished) + eng.rejected < len(prompts)
           and len(ticks) < 200):
        st = eng.tick()
        ticks.append(({k: v for k, v in st.items() if k != "hbm"},
                      eng.slot_pos.tolist()))
        clock.now += 0.01
    out = dict(admitted=adm, ticks=ticks,
               tokens={r.req_id: list(r.generated) for r in eng.finished},
               rejects=dict(eng.reject_counts), impl=eng.prefill_impl,
               paged=eng.paged, calls=eng.prefill_calls)
    eng.close()
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine_tick_for_tick(arch):
    """Default options with SmartConf on under an HBM goal (SmartConf
    steers to 0.95 of it, so the goal is the weights over 0.95 plus
    400 kB, the same headroom for whisper's 16.8 MB of ``pos_emb`` as for
    internvl2's small weights): both engines
    warn that ``auto`` keeps the one-shot path, resolve to legacy on
    dense KV, admit and reject the same requests (internvl2's 8 patch
    positions push 50 + 8 + 8 past cache_len 64), and give the same
    tokens, tick stats and slot positions, with more requests than
    slots."""
    jcfg, jp, cfg, tp = _weights(arch)
    weights = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                  for x in jax.tree.leaves(jp))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 50, 33, 60, 11)]
    runs = []
    for eng_cls, req_cls, cfg_, params in ((JServeEngine, JRequest, jcfg, jp),
                                           (ServeEngine, Request, cfg, tp)):
        clock = Clock()
        kw = {} if eng_cls is JServeEngine else {"device": "cpu"}
        with pytest.warns(RuntimeWarning, match="keeps the one-shot legacy "
                          "prefill path"):
            eng = eng_cls(cfg_, params, max_batch=2, cache_len=64,
                          hbm_budget_bytes=int(weights / 0.95) + 400_000,
                          latency_goal_s=0.01, clock=clock, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # goal-unreachable notices
            runs.append(_serve(eng, req_cls, prompts, 8, clock))
    want, got = runs
    assert got == want
    assert got["impl"] == "legacy" and got["paged"] is False
    npatch = cfg.num_patches if cfg.frontend == "vision" else 0
    too_long = [len(p) + 8 + npatch > 64 for p in prompts]
    assert got["admitted"] == [not t for t in too_long]
    assert got["rejects"] == ({"prompt_too_long": sum(too_long)}
                              if any(too_long) else {})
    assert len(got["tokens"]) == len(prompts) - sum(too_long)
    # a slot's position after its one-shot prefill counts the patches
    first = next(pos for _, pos in got["ticks"] if max(pos) >= 0)
    assert max(first) in {len(p) + npatch + k for p in prompts
                          for k in (0, 1)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["packed", "bucketed"])
def test_chunked_modes_raise_like_jax(arch, mode):
    jcfg, jp, cfg, tp = _weights(arch)
    with pytest.raises(ValueError, match="cannot serve") as jerr:
        JServeEngine(jcfg, jp, prefill_mode=mode)
    with pytest.raises(ValueError, match="cannot serve") as err:
        ServeEngine(cfg, tp, prefill_mode=mode, device="cpu")
    assert str(err.value) == str(jerr.value).replace(jcfg.name, cfg.name)
    with pytest.raises(ValueError, match="paged KV requires"):
        ServeEngine(cfg, tp, prefill_mode="legacy", kv_mode="paged",
                    device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_frontends(arch, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--device", "cpu", "--requests", "3",
        "--max-new-tokens", "3"])
    out = io.StringIO()
    with redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        launch_serve.main()
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith(f"{arch}-smoke: 3/3 done in ")
    assert "prefill[legacy] 3 calls" in line and "kv[dense]" in line
    assert "HBM violations 0" in line


# --------------------------------------------- attention at Sq != Sk
CROSS_CASES = [(5, 24, 4, 4), (7, 40, 4, 2), (33, 9, 4, 1), (1, 130, 2, 2)]


def _cross_case(sq, sk, h, kv, d=16, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return dict(q=rng.standard_normal((b, h, sq, d), np.float32),
                k=rng.standard_normal((b, kv, sk, d), np.float32),
                v=rng.standard_normal((b, kv, sk, d), np.float32),
                do=rng.standard_normal((b, h, sq, d), np.float32))


def _numpy_attention(q, k, v):
    g = q.shape[1] // k.shape[1]
    k, v = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) \
        * q.shape[-1] ** -0.5
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    return np.einsum("bhqk,bhkd->bhqd", np.exp(s - lse[..., None]), v), lse


@pytest.mark.parametrize("case", CROSS_CASES,
                         ids=lambda c: f"Sq{c[0]}-Sk{c[1]}-H{c[2]}kv{c[3]}")
def test_plain_cross_forward_matches_numpy(case):
    c = _cross_case(*case)
    o, lse = attention_lse_ref(*(torch.from_numpy(c[n]) for n in "qkv"),
                               causal=False)
    want_o, want_lse = _numpy_attention(c["q"], c["k"], c["v"])
    np.testing.assert_allclose(o.numpy(), want_o, atol=FLASH_TOL,
                               rtol=FLASH_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=FLASH_TOL,
                               rtol=FLASH_TOL)
    got = attention_ref(*(torch.from_numpy(c[n]) for n in "qkv"),
                        causal=False)
    torch.testing.assert_close(got, o)


@pytest.mark.parametrize("case", [c for c in CROSS_CASES if c[0] < c[1]],
                         ids=lambda c: f"Sq{c[0]}-Sk{c[1]}-H{c[2]}kv{c[3]}")
def test_plain_cross_backward_matches_jax_on_padded_queries(case):
    """Queries padded with zero rows to the keys' length give the JAX
    oracle's one-length form; non-causal, the pad rows change no real
    row, and with a zero output gradient on them, no gradient either."""
    sq, sk = case[:2]
    c = _cross_case(*case)
    pad = ((0, 0), (0, 0), (0, sk - sq), (0, 0))
    qp, dop = np.pad(c["q"], pad), np.pad(c["do"], pad)
    out, vjp = jax.vjp(lambda q, k, v: jax_attention_ref(q, k, v,
                                                         causal=False),
                       jnp.asarray(qp), jnp.asarray(c["k"]),
                       jnp.asarray(c["v"]))
    jdq, jdk, jdv = vjp(jnp.asarray(dop))
    q, k, v, do = (torch.from_numpy(c[n]) for n in ("q", "k", "v", "do"))
    o, lse = attention_lse_ref(q, k, v, causal=False)
    np.testing.assert_allclose(o.numpy(), np.asarray(out)[:, :, :sq],
                               atol=FLASH_TOL, rtol=FLASH_TOL)
    dq, dk, dv = attention_bwd_ref(q, k, v, o, lse, do, causal=False)
    assert dk.shape == k.shape and dq.shape == q.shape
    for got, want in ((dq, np.asarray(jdq)[:, :, :sq]), (dk, jdk),
                      (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **FLASH_GRAD_TOL)
    # the autograd Function over the plain versions, as the model takes it
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(FlashAttention.apply(*ins, False, 0), ins,
                                do)
    for got, want in zip(grads, (dq, dk, dv)):
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 8),
                                           (True, 8)])
def test_masked_cross_attention_raises(causal, window):
    """Keys of another length come without a mask only: the plain
    versions and ``layers.attention`` refuse a causal or windowed call
    (no arch needs one)."""
    c = _cross_case(5, 12, 4, 2)
    q, k, v = (torch.from_numpy(c[n]) for n in "qkv")
    with pytest.raises(ValueError, match="only without a mask"):
        attention_ref(q, k, v, causal=causal, window=window)
    with pytest.raises(ValueError, match="only without a mask"):
        layers.attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), q_pos=None, k_pos=None,
                         causal=causal, window=window)


def test_layers_attention_takes_cross_attention():
    """The model layout, with and without a gradient wanted, against the
    numpy softmax."""
    c = _cross_case(6, 21, 4, 2)
    want, _ = _numpy_attention(c["q"], c["k"], c["v"])
    q, k, v = (torch.from_numpy(c[n]).transpose(1, 2) for n in "qkv")
    with torch.no_grad():
        plain = layers.attention(q, k, v, q_pos=None, k_pos=None,
                                 causal=False)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    grad = layers.attention(*ins, q_pos=None, k_pos=None, causal=False)
    for got in (plain, grad):
        np.testing.assert_allclose(got.detach().transpose(1, 2).numpy(),
                                   want, atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (6, 1)])
def test_cross_decode_attention_matches_numpy(h, kv):
    """One token against every frame through the dense decode op's plain
    version (frames and query at position 0, window 0)."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 1, h, 16), np.float32)
    k = rng.standard_normal((3, 37, kv, 16), np.float32)
    v = rng.standard_normal((3, 37, kv, 16), np.float32)
    want, _ = _numpy_attention(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                               v.transpose(0, 2, 1, 3))
    got = layers.cross_decode_attention(*(torch.from_numpy(a)
                                          for a in (q, k, v)))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want,
                               atol=FLASH_TOL, rtol=FLASH_TOL)
