"""The port's training path against the JAX package, on the CPU.

Reduced configs (f32), the same weights (the JAX ``zoo.init`` tree bridged
into torch) and the same numpy batches go through both packages:
``loss_fn`` and every gradient leaf for the four attention archs and the
two recurrent ones (recurrentgemma-9b's RG-LRU and rwkv6-7b's time mix
through their one-shot forms) under the reference's default XLA
attention route and, for gemma3-4b (GQA, sliding-window and global
layers), its Pallas route in interpret mode;
``adamw.update`` and ``accumulate_grads``; the data stream; the
checkpoint format in both directions; a trainer restart in both
directions; preemption; remat on an attention and a recurrent arch; and
the kinds that are not ported.

Tolerances: the loss within ``2e-5`` relative, as the reference holds
its two attention routes (``tests/test_kernels.py``); each gradient leaf
within ``2e-4`` of its largest magnitude: the two frameworks sum the
matrix products in other orders and the differences grow with depth
(measured up to 8e-5 on gemma3-4b's six reduced layers, where the JAX
package's own two routes differ by 2.6e-5 from each other).
"""

import dataclasses
import shutil
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import keyed_leaves, restore, save
from repro_torch.configs import get_config, reduced
from repro_torch.data import PrefetchPipeline, SyntheticTokens
from repro_torch.launch import train as launch_train
from repro_torch.models import zoo
from repro_torch.models.bridge import params_from_numpy, tree_leaves, tree_map
from repro_torch.optim import accum, adamw
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCHS = ["yi-6b", "h2o-danube-3-4b", "gemma3-4b", "starcoder2-15b",
         "recurrentgemma-9b", "rwkv6-7b"]
# rwkv6 has d // 64 heads: two at d 128, where plain reduced() gives one
OVERRIDES = {"rwkv6-7b": {"d_model": 128}}
LOSS_RTOL = 2e-5
GRAD_REL = 2e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def jx(monkeypatch):
    """The JAX package's model, optimizer, data, checkpoint and trainer,
    with the attention route left at its default (XLA)."""
    jax = pytest.importorskip("jax")
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    from repro import checkpoint, configs
    from repro.data import SyntheticTokens as JSyntheticTokens
    from repro.models import zoo as jzoo
    from repro.optim import accum as jaccum
    from repro.optim import adamw as jadamw
    from repro.train import trainer as jtrainer
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, configs=configs, zoo=jzoo, adamw=jadamw,
        accum=jaccum, checkpoint=checkpoint, SyntheticTokens=JSyntheticTokens,
        Trainer=jtrainer.Trainer, TrainerConfig=jtrainer.TrainerConfig)


def configs_for(jx, arch):
    extra = OVERRIDES.get(arch, {})
    return (jx.configs.reduced(jx.configs.get_config(arch), **extra),
            reduced(get_config(arch), **extra))


def numpy_batch(vocab, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def jax_keyed(jx, tree):
    """{keystr: numpy array} of a JAX tree."""
    flat = jx.jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jx.jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


def assert_tree_close(got, want: dict, rel=GRAD_REL):
    """Every leaf of the torch tree ``got`` within ``rel`` of its JAX twin's
    largest magnitude."""
    keys = dict(keyed_leaves(got))
    assert set(keys) == set(want)
    for key, t in keys.items():
        a = want[key]
        err = np.abs(t.detach().float().numpy() - a).max()
        assert err <= rel * max(np.abs(a).max(), 1e-30), (key, err)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,route", [(a, "xla") for a in ARCHS]
                         + [("gemma3-4b", "pallas_interpret")])
def test_loss_and_grads_match_jax(jx, monkeypatch, arch, route):
    if route != "xla":
        monkeypatch.setenv("REPRO_ATTN_IMPL", route)
    jcfg, cfg = configs_for(jx, arch)
    jp, _ = jx.zoo.init(jcfg, jx.jax.random.key(0))
    batch = numpy_batch(cfg.vocab_size, 2, 40)   # past the reduced window
    (jl, jaux), jg = jx.jax.value_and_grad(
        lambda p: jx.zoo.loss_fn(jcfg, p, {k: jx.jnp.asarray(v)
                                           for k, v in batch.items()}),
        has_aux=True)(jp)
    params = params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    loss, aux, grads = accum.value_and_grad(
        lambda p, b: zoo.loss_fn(cfg, p, b), params,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["ce"]), float(jaux["ce"]),
                               rtol=LOSS_RTOL)
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    assert_tree_close(grads, jax_keyed(jx, jg))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "whisper-tiny",
                                  "internvl2-1b"])
def test_unported_kinds_raise(arch):
    cfg = reduced(get_config(arch))
    batch = {k: torch.from_numpy(v)
             for k, v in numpy_batch(cfg.vocab_size, 1, 8).items()}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        zoo.loss_fn(cfg, {}, batch)


def _remat_check(arch):
    """remat="dots" runs every group layer's attention, or its RG-LRU
    one-shot form, again in the backward pass (two forward calls per
    layer), and the gradients are those without remat."""
    from repro_torch.kernels.flash_attention import vjp
    from repro_torch.models import rglru
    cfg = reduced(get_config(arch))
    params = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in numpy_batch(cfg.vocab_size, 2, 24).items()}
    calls = []
    forward, block = vjp.FlashAttention.forward, rglru.rglru_block

    def counting(ctx, *a):
        calls.append(1)
        return forward(ctx, *a)

    def counting_block(*a):
        calls.append(1)
        return block(*a)

    out = {}
    for remat in ("none", "dots"):
        calls.clear()
        vjp.FlashAttention.forward = staticmethod(counting)
        rglru.rglru_block = counting_block
        try:
            out[remat] = accum.value_and_grad(
                lambda p, b: zoo.loss_fn(cfg, p, b, remat=remat), params,
                batch)
        finally:
            vjp.FlashAttention.forward = staticmethod(forward)
            rglru.rglru_block = block
        out[remat + "_calls"] = len(calls)
    assert out["none_calls"] == cfg.num_layers
    assert out["dots_calls"] == 2 * cfg.num_layers
    assert float(out["none"][0]) == float(out["dots"][0])
    for a, b in zip(tree_leaves(out["none"][2]), tree_leaves(out["dots"][2])):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_remat_recomputes_each_group_layer_and_keeps_the_gradients():
    """yi-6b: every layer's attention runs twice under remat."""
    _remat_check("yi-6b")


def test_remat_recomputes_each_recurrent_layer_and_keeps_the_gradients():
    """recurrentgemma-9b's (rglru, rglru, swa) group: both RG-LRU one-shot
    forms and the attention run twice under remat."""
    _remat_check("recurrentgemma-9b")


# ---------------------------------------------------------------------------
# optimizer and accumulation
# ---------------------------------------------------------------------------


def test_adamw_update_matches_jax(jx):
    """Three steps through warmup and decay, with gradients large enough
    to clip, on f32 matrices, a vector (no decay) and a bf16 matrix."""
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((8, 16), np.float32),
            "b": rng.standard_normal(16, np.float32),
            "groups": [{"m": rng.standard_normal((3, 4, 5), np.float32)}]}
    grads = [tree_map(lambda a: rng.standard_normal(a.shape, np.float32) * 3,
                      tree) for _ in range(3)]
    cfg_j = jx.adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    cfg_t = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    jnp = jx.jnp
    jp = jx.jax.tree.map(jnp.asarray, tree)
    jp["h"] = jnp.asarray(rng.standard_normal((4, 4)), jnp.bfloat16)
    p = params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    js, ts = jx.adamw.init(jp), adamw.init(p)
    for g in grads:
        g = dict(g, h=rng.standard_normal((4, 4), np.float32))
        jp, js, jm = jx.adamw.update(jx.jax.tree.map(jnp.asarray, g), js, jp,
                                     cfg_j)
        p, ts, tm = adamw.update(params_from_numpy(g, "cpu"), ts, p, cfg_t)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["grad_norm"]) > cfg_t.clip_norm    # clipped
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    assert p["h"].dtype == torch.bfloat16
    want = jax_keyed(jx, {"params": jp, "opt": js})
    got = {"params": p, "opt": ts}
    for key, t in keyed_leaves(got):
        np.testing.assert_allclose(t.float().numpy(),
                                   want[key].astype(np.float32),
                                   rtol=1e-5, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("step", [0, 1, 5, 100, 9_999, 20_000])
def test_schedule_matches_jax(jx, step):
    cfg_j = jx.adamw.AdamWConfig(warmup_steps=100, total_steps=10_000)
    cfg_t = adamw.AdamWConfig(warmup_steps=100, total_steps=10_000)
    want = float(jx.adamw.schedule(cfg_j, jx.jnp.asarray(step)))
    assert float(adamw.schedule(cfg_t, step)) == pytest.approx(want,
                                                               rel=1e-6)


def test_accumulate_grads_matches_jax(jx):
    """Two microbatches: the mean loss and the f32 mean gradients."""
    jcfg, cfg = configs_for(jx, "yi-6b")
    jp, _ = jx.zoo.init(jcfg, jx.jax.random.key(1))
    batch = numpy_batch(cfg.vocab_size, 4, 24, seed=2)
    jl, jaux, jg = jx.accum.accumulate_grads(
        lambda p, b: jx.zoo.loss_fn(jcfg, p, b), jp,
        {k: jx.jnp.asarray(v) for k, v in batch.items()}, 2)
    params = params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    loss, aux, grads = accum.accumulate_grads(
        lambda p, b: zoo.loss_fn(cfg, p, b), params,
        {k: torch.from_numpy(v) for k, v in batch.items()}, 2)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["ce"]), float(jaux["ce"]),
                               rtol=LOSS_RTOL)
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    assert_tree_close(grads, jax_keyed(jx, jg))


def test_accumulation_helpers():
    batch = {"tokens": torch.arange(24).reshape(6, 4)}
    assert accum.split_batch(batch, 3)["tokens"].shape == (3, 2, 4)
    with pytest.raises(ValueError):
        accum.split_batch(batch, 4)
    assert accum.divisors(12) == [1, 2, 3, 4, 6, 12]
    assert accum.quantize_microbatches(12, 5.2) == 6


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------


def test_synthetic_tokens_are_the_reference_batches(jx):
    ours, ref = SyntheticTokens(512, 4, 16, seed=7), jx.SyntheticTokens(
        512, 4, 16, seed=7)
    assert ours.batch_nbytes() == ref.batch_nbytes()
    for _ in range(3):
        a, b = ours.next_batch(), ref.next_batch()
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    ref.restore(ours.state())
    np.testing.assert_array_equal(ours.next_batch()["tokens"],
                                  ref.next_batch()["tokens"])
    pipe = PrefetchPipeline(SyntheticTokens(512, 4, 16, seed=7), depth=2)
    try:
        first = pipe.get()
    finally:
        pipe.close()
    np.testing.assert_array_equal(
        first["labels"], jx.SyntheticTokens(512, 4, 16, seed=7)
        .next_batch()["labels"])


def _state_tree(rng):
    """An optimizer-state-shaped tree with bf16, f32 and int32 leaves."""
    p = {"embed": torch.from_numpy(rng.standard_normal((5, 3), np.float32))
         .to(torch.bfloat16),
         "groups": [{"attn": {"wq": torch.from_numpy(
             rng.standard_normal((2, 3, 4), np.float32))}}]}
    st = adamw.init(p)
    for t in tree_leaves((st.m, st.v)):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape, np.float32)))
    return {"params": p, "opt": st._replace(step=torch.tensor(
        7, dtype=torch.int32))}


def test_checkpoints_cross_between_the_packages(jx, tmp_path):
    """The port writes, the JAX package reads, and the other way round;
    bf16 bits and NamedTuple fields survive, under the same key strings."""
    tree = _state_tree(np.random.default_rng(4))
    save(str(tmp_path / "a"), 3, tree, extra={"x": 1})
    like = jx.jax.tree.map(
        lambda t: jx.jnp.zeros(t.shape, {torch.bfloat16: jx.jnp.bfloat16,
                                         torch.float32: jx.jnp.float32,
                                         torch.int32: jx.jnp.int32}[t.dtype]),
        {"params": tree["params"], "opt": jx.adamw.AdamWState(*tree["opt"])})
    jtree, extra, step = jx.checkpoint.restore(str(tmp_path / "a"), None,
                                               like)
    assert (step, extra) == (3, {"x": 1})
    got = jax_keyed(jx, jtree)
    for key, t in keyed_leaves(tree):
        want = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(got[key].astype(want.dtype), want,
                                      err_msg=key)
    jx.checkpoint.save(str(tmp_path / "b"), 5, jtree, extra={"y": 2})
    zeros = tree_map(torch.zeros_like, tree)
    back, extra, step = restore(str(tmp_path / "b"), None, zeros)
    assert (step, extra) == (5, {"y": 2})
    assert type(back["opt"]) is adamw.AdamWState
    for (k1, a), (k2, b) in zip(keyed_leaves(back), keyed_leaves(tree)):
        assert k1 == k2 and a.dtype == b.dtype and torch.equal(a, b), k1


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

TRAIN = dict(total_steps=4, ckpt_interval=2, batch_size=2, seq_len=16,
             enable_smartconf=False)


def _port_trainer(workdir, **kw):
    cfg = reduced(get_config("yi-6b"))
    return Trainer(cfg, adamw.AdamWConfig(total_steps=4),
                   TrainerConfig(workdir=str(workdir), **dict(TRAIN, **kw)),
                   device="cpu")


def _jax_trainer(jx, workdir):
    cfg = jx.configs.reduced(jx.configs.get_config("yi-6b"))
    return jx.Trainer(cfg, jx.adamw.AdamWConfig(total_steps=4),
                      jx.TrainerConfig(workdir=str(workdir), **TRAIN))


def _jax_next_step(jx, jt, data_step):
    """The JAX trainer's step function on its restored state and the
    batch at ``data_step`` of the stream -> (loss, new params)."""
    src = jx.SyntheticTokens(jt.cfg.vocab_size, TRAIN["batch_size"],
                             TRAIN["seq_len"], seed=0)
    src.restore({"step": data_step, "seed": 0})
    batch = {k: jx.jnp.asarray(v) for k, v in src.next_batch().items()}
    params, _, metrics = jt.step_fn(jt.params, jt.opt_state, batch)
    return float(metrics["loss"]), params


def test_port_trainer_restores_a_jax_checkpoint(jx, tmp_path):
    jt = _jax_trainer(jx, tmp_path / "run")
    jt.run(2)
    jt.close()
    shutil.copytree(tmp_path / "run", tmp_path / "copy")
    jt = _jax_trainer(jx, tmp_path / "run")              # restored at step 2
    pt = _port_trainer(tmp_path / "copy")
    assert jt.step == pt.step == 2
    for key, t in keyed_leaves({"params": pt.params, "opt": pt.opt_state}):
        np.testing.assert_array_equal(
            t.numpy(), jax_keyed(jx, {"params": jt.params,
                                      "opt": jt.opt_state})[key], key)
    data_step = pt.data_step
    want_loss, want_params = _jax_next_step(jx, jt, data_step)
    jt.close()
    log = pt.run(1)
    pt.close()
    np.testing.assert_allclose(log[-1]["loss"], want_loss, rtol=LOSS_RTOL)
    assert_tree_close(pt.params, jax_keyed(jx, want_params), rel=1e-5)


def test_jax_trainer_restores_a_port_checkpoint(jx, tmp_path):
    pt = _port_trainer(tmp_path / "run")
    pt.run(2)
    pt.close()
    pt = _port_trainer(tmp_path / "run")
    jt = _jax_trainer(jx, tmp_path / "run")
    assert jt.step == pt.step == 2 and pt.data_step == 2
    want = jax_keyed(jx, {"params": jt.params, "opt": jt.opt_state})
    for key, t in keyed_leaves({"params": pt.params, "opt": pt.opt_state}):
        np.testing.assert_array_equal(t.numpy(), want[key], key)
    jax_loss, jax_params = _jax_next_step(jx, jt, pt.data_step)
    jt.close()
    log = pt.run(1)
    pt.close()
    np.testing.assert_allclose(log[-1]["loss"], jax_loss, rtol=LOSS_RTOL)
    assert_tree_close(pt.params, jax_keyed(jx, jax_params), rel=1e-5)


def test_restart_resumes_the_data_stream_exactly(tmp_path):
    """Two steps, a restart from the checkpoint, two more: the losses of
    an uninterrupted run of four, bit for bit."""
    whole = _port_trainer(tmp_path / "whole", ckpt_interval=1000)
    want = [m["loss"] for m in whole.run(4)]
    whole.close()
    first = _port_trainer(tmp_path / "cut")
    got = [m["loss"] for m in first.run(2)]
    first.close()
    second = _port_trainer(tmp_path / "cut")
    assert second.step == 2 and second.data_step == 2
    got += [m["loss"] for m in second.run(2)]
    second.close()
    assert got == want


def test_trainer_with_smartconf_runs_and_restarts(tmp_path):
    """Both controllers live, as the launcher runs them."""
    tr = _port_trainer(tmp_path, enable_smartconf=True, total_steps=5,
                       batch_size=4, seq_len=32)
    log = tr.run()
    assert len(log) == 5 and all(np.isfinite(m["loss"]) for m in log)
    assert tr.sc_prefetch is not None and tr.sc_ckpt is not None
    saved = tr.ckpt.last_saved
    tr.close()
    tr = _port_trainer(tmp_path, enable_smartconf=True, total_steps=5,
                       batch_size=4, seq_len=32)
    assert tr.step == saved
    tr.run(1)
    assert tr.step == saved + 1
    tr.close()


def test_preemption_writes_a_checkpoint_and_stops(tmp_path):
    tr = _port_trainer(tmp_path, total_steps=50, ckpt_interval=1000)
    tr.run(2)
    tr.preemption.trigger()
    tr.run(10)
    assert tr.step == 2 and tr.ckpt.last_saved == 2
    tr.close()


def test_trainer_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is taken")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(reduced(get_config("yi-6b")), adamw.AdamWConfig(),
                TrainerConfig(workdir=str(tmp_path)))


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "h2o-danube-3-4b", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "training h2o-danube-3-4b-smoke" in out
    # the first write moves train.ckpt_interval_steps to at least 5
    assert "last ckpt @ step 1" in out


def test_trainer_config_is_the_reference_default(jx):
    ours = dataclasses.asdict(TrainerConfig())
    ref = dataclasses.asdict(jx.TrainerConfig())
    ours.pop("workdir"), ref.pop("workdir")
    assert ours == ref
    assert dataclasses.asdict(adamw.AdamWConfig()) == dataclasses.asdict(
        jx.adamw.AdamWConfig())
