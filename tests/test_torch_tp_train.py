"""Tensor-parallel training over ``model`` on a mesh of gloo processes,
on the CPU.

One ``MeshPool`` of four ranks (one thread each) serves every case; a
``1x2`` mesh runs on its first two ranks.  The ranks import only the
port (``tests/torch_train_ranks.py``).  The JAX package's side
(``tests/torch_jax_side.py``'s ``tp_train`` job: its jitted
single-device ``make_train_step`` on seed-0 weights, which the port
takes through the bridge) starts in a subprocess when the module does
and is read by the first case that needs it.  Reduced configs, AdamW
at ``eps = 1`` (``torch_jax_side.DP_OPT``: a parameter's step reads its
gradient), ``tp_batch``'s 4 rows of 16 tokens (and a frontend's patches
or frames).

* the six archs under ``1x2``, yi-6b under ``2x2`` (FSDP on and off, at
  ``vocab_size=16384`` so FSDP applies) and under ``1x4``, and the three
  replicated forms under ``1x2`` (one KV head: ``wk``/``wv`` replicated
  and summed over ``model``; an odd vocab: embed and head replicated;
  whisper-tiny at 3/3 heads: the attention replicated, the MLP split),
  each against the one-process port (``make_train_step`` at the same
  rows a microbatch: loss and grad norm within 1e-5 relative, every
  parameter and moment within 1e-5 of its leaf's largest magnitude) and
  against the JAX step (``tests/test_torch_train.py``'s 2e-5 and 2e-4).
  The moments (and the parameters that start at zero: biases,
  ``pos_emb``) carry the gradients themselves, and on gemma3-4b and
  whisper-tiny some pass 1e-5 (up to 2.9e-5): where a leaf does, the
  worst gap of the case must stay within the f32 noise floor of the
  one-process step itself, the worst gap that multiplying every weight
  by ``1 + 1e-7 N(0, 1)`` (``chip_smoke.nudged``'s perturbation, two
  draws) makes against the same step.  Loss and grad norm are held to
  1e-5 alone.  The gaps are printed (``-s``); ROADMAP Queue 3 names the
  leaves past 1e-5;
* each rank holds only its placement's slices; the only collectives of
  a ``1x2`` step are all-reduces over the ``model`` group, as many as
  the step's ``ModelParallel`` counts;
* the autograd pair, the vocab-parallel embedding and cross-entropy
  against one process's products, ``embedding`` and
  ``F.cross_entropy``, with gradients;
* ``gather_leaves`` over ``data`` alone and over both axes of a leaf
  split on two dims;
* a ``1x2`` checkpoint restored bit for bit in one process and on
  ``2x2``;
* ``Trainer(mesh=)`` on ``1x2`` for three steps, its losses within 1e-5
  of one process's; ``launch/train.py --mesh 1x2 --device cpu``;
* ``chip_smoke.py --tp-trace``'s rank functions: the ``2x2`` step reads
  as the mean of two one-row ``1x2`` steps, and the decomposition in
  f64 is exact.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import torch_jax_side as side
import torch_train_ranks as ranks
from repro_torch.checkpoint import latest_step, restore
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding as shd
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import MeshPool
from repro_torch.models import zoo
from repro_torch.models.bridge import keyed_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

TP_REL = 1e-5
LOSS_RTOL = 2e-5
GRAD_REL = 2e-4
NUDGE = 1e-7
NUDGE_SEEDS = (29, 30)
ONE_BY_TWO = side.TP_ARCHS + ["yi-6b/kv1", "yi-6b/v511", "whisper-tiny/h3"]


class _JaxSide:
    """The ``tp_train`` job, started at once, read when first asked."""

    def __init__(self, tmp, job: str = "tp_train"):
        import os
        import subprocess
        import sys
        self.out = tmp / f"{job}.pkl"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=str(side.ROOT / "src"))
        self.proc = subprocess.Popen(
            [sys.executable, side.__file__, job, str(self.out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        self._got = None

    def get(self) -> dict:
        if self._got is None:
            import pickle
            text, _ = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, text
            with open(self.out, "rb") as fh:
                self._got = pickle.load(fh)
        return self._got


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    job = _JaxSide(tmp_path_factory.mktemp("jax_tp"))
    yield job
    if job.proc.poll() is None:
        job.proc.kill()
        job.proc.wait()


@pytest.fixture(scope="module")
def jx(jax_side):
    return jax_side.get()


@pytest.fixture(scope="module")
def pool(jax_side):
    p = MeshPool(4, 1, device="cpu", timeout_s=60.0,
                 threads=1)
    yield p
    p.close()


def case_cfg(case: str):
    arch, over = side.tp_case(case)
    return arch, over, reduced(get_config(arch), **over)


def inputs(jx, case):
    arch, over, cfg = case_cfg(case)
    return arch, over, jx[case]["weights"], side.tp_batch(cfg)


_RUNS: dict = {}


def run_once(pool, key, fn, *args):
    """``pool.run`` memoised: cases share the runs they compare."""
    if key not in _RUNS:
        _RUNS[key] = pool.run(fn, *args)
    return _RUNS[key]


def one(pool, jx, case, n_micro=1, nudge=None):
    """One process's state and metrics (with the weights nudged from the
    seed ``nudge``)."""
    arch, over, weights, batch = inputs(jx, case)
    if nudge is not None:
        rng = np.random.default_rng(nudge)
        weights = tree_map(lambda a: (a * (1 + NUDGE * rng.standard_normal(
            a.shape))).astype(a.dtype), weights)
    return run_once(pool, ("one", case, n_micro, nudge), ranks.one_process,
                    arch, over, weights, batch, n_micro, side.DP_OPT)[0]


def tp(pool, jx, case, data, model, fsdp=True):
    return run_once(pool, ("tp", case, data, model, fsdp), ranks.tp_step,
                    *inputs(jx, case), data, model, fsdp, side.DP_OPT)


def gaps(got: dict, want: dict) -> dict:
    return {k: float(np.abs(got[k] - a).max() / max(np.abs(a).max(), 1e-30))
            for k, a in want.items()}


def assert_near_one_process(pool, jx, case, data, model, fsdp=True):
    """Loss, grad norm and every leaf of the gathered state against one
    process at ``data`` microbatches (see the module docstring)."""
    state, metrics = one(pool, jx, case, n_micro=data)
    out = tp(pool, jx, case, data, model, fsdp)
    full, m = out[0][0], out[0][1]
    assert [r[1] for r in out[:data * model]] == [m] * (data * model)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(m[k], metrics[k], rtol=TP_REL, err_msg=k)
    assert set(full) == set(state)
    gap = gaps(full, state)
    wide = {k: v for k, v in gap.items() if v > TP_REL}
    worst = max(gap, key=gap.get)
    print(f"\n{case} {data}x{model} fsdp {fsdp}: loss gap "
          f"{abs(m['loss'] - metrics['loss']) / metrics['loss']:.3e}, worst "
          f"leaf {worst} {gap[worst]:.3e}; past {TP_REL}: {len(wide)}")
    if wide:
        floor = max(max(gaps(one(pool, jx, case, data, seed)[0],
                             state).values()) for seed in NUDGE_SEEDS)
        print(f"  f32 noise floor {floor:.3e}; past {TP_REL}: "
              + ", ".join(f"{k} {v:.3e}" for k, v in
                          sorted(wide.items(), key=lambda kv: -kv[1])[:4]))
        assert gap[worst] <= floor, (worst, gap[worst], floor)


def assert_near_jax(got, want):
    full, m = got[0][0], got[0][1]
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(m[k], want["metrics"][k], rtol=LOSS_RTOL)
    assert set(full) == set(want["state"])
    for k, v in gaps(full, want["state"]).items():
        assert v <= GRAD_REL, (k, v)


def test_autograd_pair_and_vocab_cross_entropy(pool):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 8)).astype(np.float32)
    w1 = rng.standard_normal((8, 6)).astype(np.float32)
    w2 = rng.standard_normal((6, 8)).astype(np.float32)
    logits = (rng.standard_normal((7, 10)) * 3).astype(np.float32)
    labels = rng.integers(0, 10, 7)
    table = rng.standard_normal((10, 4)).astype(np.float32)
    ids = rng.integers(0, 10, (2, 9))
    got = pool.run(ranks.tp_pair, x, w1, w2, logits, labels, table, ids)[:2]
    t = {k: torch.from_numpy(v).requires_grad_()
         for k, v in dict(x=x, w1=w1, w2=w2, logits=logits,
                          table=table).items()}
    y = torch.tanh(t["x"] @ t["w1"]) @ t["w2"]
    ce = torch.nn.functional.cross_entropy(t["logits"],
                                           torch.from_numpy(labels),
                                           reduction="sum")
    emb = t["table"][torch.from_numpy(ids)]
    (y.square().sum() + ce + (emb * emb).sum()).backward()
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["y"], y.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g["ce"], ce.item(), rtol=1e-6)
        np.testing.assert_array_equal(g["emb"], emb.detach().numpy())
        np.testing.assert_allclose(g["d_x"], t["x"].grad.numpy(),
                                   rtol=1e-5, atol=1e-5)
        for k, dim in (("w1", 1), ("w2", 0), ("logits", 1), ("table", 0)):
            want = torch.chunk(t[k].grad, 2, dim=dim)[r].numpy()
            np.testing.assert_allclose(g["d_" + k], want, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_gather_leaves_over_data_and_both_axes(pool):
    rng = np.random.default_rng(6)
    leaves = {"both": rng.standard_normal((4, 6, 3)).astype(np.float32),
              "data": rng.standard_normal((8, 2)).astype(np.float32),
              "model": np.arange(12, dtype=np.int32).reshape(3, 4),
              "whole": rng.standard_normal(5).astype(np.float32)}
    specs = {"both": ("data", "model", None), "data": ("data", None),
             "model": (None, "model"), "whole": (None,)}
    for data, both, (d, m) in pool.run(ranks.gather_case, leaves, specs):
        for k, v in leaves.items():
            np.testing.assert_array_equal(both[k], v)
        # the data dim gathered, the model dim still this rank's half
        np.testing.assert_array_equal(
            data["both"], np.split(leaves["both"], 2, axis=1)[m])
        np.testing.assert_array_equal(data["data"], leaves["data"])
        np.testing.assert_array_equal(
            data["model"], np.split(leaves["model"], 2, axis=1)[m])
        assert data["both"].shape == (4, 3, 3) and d in (0, 1)


def test_trainer_1x2_matches_one_process(pool, tmp_path):
    arch, over = "yi-6b", {}
    alone = pool.run(ranks.tp_trainer, str(tmp_path / "one"), arch, over,
                     1, 1, 3)[0]
    out = pool.run(ranks.tp_trainer, str(tmp_path / "tp"), arch, over,
                   1, 2, 3)
    assert out[0] == out[1] and out[2:] == [None, None]
    np.testing.assert_allclose(out[0], alone, rtol=TP_REL)


def test_launcher_mesh_1x2(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        launch_train.main(["--arch", "yi-6b", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "16",
                           "--mesh", "1x2", "--workdir",
                           str(tmp_path / "w")])
    text = out.getvalue()
    assert "on mesh 1x2 (2 rows a rank, FSDP, tensor-parallel over 2)" \
        in text
    saved = int(text.rsplit("last ckpt @ step ", 1)[1])
    assert latest_step(str(tmp_path / "w" / "ckpt")) == saved


def test_straddling_gqa_chunk_raises():
    """12 query heads in 3 KV groups of 4 over 2 model ranks: chunks of 6
    straddle two groups, and the KV heads (3) stay replicated."""
    import types
    cfg = reduced(get_config("yi-6b"), num_heads=12, num_kv_heads=3)
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": 2},
                                 data_index=0, model_index=0, rank=0)
    with pytest.raises(ValueError, match="straddle"):
        ts.make_mesh_train_step(cfg, adamw.AdamWConfig(), mesh)
    assert shd.model_split(zoo.init_axes(cfg), ts.state_placement(
        cfg, mesh).specs["params"], mesh) == {
        "vocab": True, "heads": True, "kv_heads": False, "mlp": True}


@pytest.mark.parametrize("case", ONE_BY_TWO)
def test_1x2_matches_one_process(pool, jx, case):
    assert_near_one_process(pool, jx, case, 1, 2)


@pytest.mark.parametrize("case", ONE_BY_TWO)
def test_1x2_matches_jax_step(pool, jx, case):
    assert_near_jax(tp(pool, jx, case, 1, 2), jx[case])


@pytest.mark.parametrize("fsdp", [True, False])
def test_2x2_matches_one_process_and_jax(pool, jx, fsdp):
    case = "yi-6b/v16384"
    assert_near_one_process(pool, jx, case, 2, 2, fsdp)
    assert_near_jax(tp(pool, jx, case, 2, 2, fsdp), jx[case])


def test_1x4_matches_one_process_and_jax(pool, jx):
    assert_near_one_process(pool, jx, "yi-6b", 1, 4)
    assert_near_jax(tp(pool, jx, "yi-6b", 1, 4), jx["yi-6b"])


def _placement(case, data, model, fsdp=True):
    import types
    _, _, cfg = case_cfg(case)
    out = []
    for r in range(data * model):
        mesh = types.SimpleNamespace(
            axis_names=("data", "model"), shape={"data": data,
                                                 "model": model},
            data_index=r // model, model_index=r % model, rank=r)
        out.append((cfg, mesh, ts.state_placement(cfg, mesh, fsdp=fsdp)))
    return out


@pytest.mark.parametrize("case,data,model", [
    ("gemma3-4b", 1, 2), ("whisper-tiny", 1, 2), ("internvl2-1b", 1, 2),
    ("yi-6b/kv1", 1, 2), ("yi-6b/v511", 1, 2), ("whisper-tiny/h3", 1, 2),
    ("yi-6b/v16384", 2, 2), ("yi-6b", 1, 4)])
def test_gradients_in_f64_equal_one_process(pool, jx, case, data, model):
    """With every float of the model in f64, the gradients AdamW receives
    equal one process's within 2e-7 of each leaf's largest magnitude
    (the gradient sums' f32 casts and adds, each within 2^-24 of a
    value): each tensor-parallel form computes the one-device function,
    and the f32 gaps above are rounding alone."""
    arch, over, weights, batch = inputs(jx, case)
    want = pool.run(ranks.tp_grads_f64, arch, over, weights, batch, data,
                    1)[0]
    got = pool.run(ranks.tp_grads_f64, arch, over, weights, batch, data,
                   model)[0]
    gap = gaps(got, want)
    worst = max(gap, key=gap.get)
    print(f"\n{case} {data}x{model} in f64: worst gradient {worst} "
          f"{gap[worst]:.3e}")
    assert gap[worst] <= 2e-7, (worst, gap[worst])


@pytest.mark.parametrize("case,data,model,fsdp", [
    ("yi-6b/v16384", 2, 2, True), ("yi-6b/v16384", 2, 2, False),
    ("yi-6b/kv1", 1, 2, True), ("yi-6b/v511", 1, 2, True),
    ("whisper-tiny/h3", 1, 2, True), ("internvl2-1b", 1, 2, True)])
def test_each_rank_holds_its_placement_slices(pool, jx, case, data, model,
                                              fsdp):
    out = tp(pool, jx, case, data, model, fsdp)
    for (cfg, _, pl), r in zip(_placement(case, data, model, fsdp), out):
        like = zoo.abstract_params(cfg)[0]
        tree = pl.local({"params": like, "opt": adamw.init(like)})
        assert r[2] == {k: tuple(v.shape) for k, v in keyed_leaves(tree)}
    shapes = out[0][2]
    attn = "['params']['groups'][0]['attn']"
    head = cfg.num_heads // model
    if case == "yi-6b/kv1":          # KV replicated, used in part: summed
        assert shapes[attn + "['wq']"][2] == head
        assert shapes[attn + "['wk']"][2] == 1
        assert pl.partial == {attn + "['wk']", attn + "['wv']"}
    elif case == "yi-6b/v511":       # embed and head whole on every rank
        assert shapes["['params']['embed']"] == (511, cfg.d_model)
        assert shapes["['params']['head']"] == (cfg.d_model, 511)
        assert not pl.partial
    elif case == "whisper-tiny/h3":  # attention replicated, MLP split
        assert shapes[attn + "['wq']"][2] == 3
        assert shapes["['params']['cross']['attn']['wo']"][1] == 3
        assert shapes["['params']['groups'][0]['mlp']['w_up']"][2] == 64
    elif case == "internvl2-1b":     # heads and KV heads (2) split
        assert shapes["['params']['connector']['w2']"] == (64, 64)
        assert shapes[attn + "['wk']"][2] == cfg.num_kv_heads // 2
    else:                            # FSDP over data beside TP over model
        want = (cfg.vocab_size // model, cfg.d_model // (data if fsdp
                                                         else 1))
        assert shapes["['params']['embed']"] == want
        assert shapes[attn + "['wq']"][2] == head
    assert out[0][3][0] > 0


def test_only_model_all_reduces_in_a_1x2_step(pool, jx):
    """Every collective of a ``1x2`` step (no FSDP at one data rank) is an
    all-reduce over the two ranks of ``model``: the conjugate pair, the
    vocab-parallel embedding and cross-entropy and the norm, as many as
    the step's ``ModelParallel`` counts, the same on both ranks, and
    carrying the bytes it counts (what the dry-run reads of it); the
    serving wrappers' all-gathers never run."""
    out = pool.run(ranks.tp_collectives, *inputs(jx, "yi-6b"), side.DP_OPT)
    (calls, n, sent, counted), (calls1, n1, sent1, _) = out[:2]
    assert calls == calls1 and n == n1 == len(calls)
    assert set(calls) == {("all_reduce", (0, 1))}
    assert sent == sent1 == counted > 0


def test_tp_trace_on_the_cpu(pool):
    """``chip_smoke.py --tp-trace``'s rank functions on an f32
    ``reduced()`` yi-6b, 2 rows of 64 tokens: the ``2x2`` step's
    gradients and norm read as the mean of two ``1x2`` one-row steps'
    (the data axis adds nothing), the decomposition in f64 is exact, and
    every traced tensor and leaf gradient of the f32 runs is within 1e-5
    of one process's."""
    import dataclasses
    import chip_smoke as C
    cfg = dataclasses.replace(reduced(get_config("yi-6b")),
                              dtype="float32")
    batch = C.tp_batch(cfg.vocab_size, 2, 64)
    out = [r for r in pool.run(C.tp_trace_rank, cfg, batch, "cpu") if r][0]
    step = [r for r in pool.run(C.tp_trace_mesh_rank, cfg, batch, "cpu")
            if r][0]
    mean = out["mean of rows 0 and 1"]
    np.testing.assert_allclose(step["norm"]["tp"],
                               mean["norm"]["tp"]["placement"], rtol=1e-6)
    for k, (gap, _) in step["leaves"].items():
        assert abs(gap - mean["leaves"][k][0]) <= 1e-7, k
    truth = out["row 1 against f64"]
    assert truth["f64 tp worst leaf"] <= 1e-12
    assert truth["f64 tp worst tensor"] <= 1e-12
    for case in ("row 0", "row 1", "rows 0-1"):
        assert max(g for _, g, _ in out[case]["tensors"]) <= TP_REL, case
        assert max(g for g, _ in out[case]["leaves"].values()) <= TP_REL


def test_checkpoint_1x2_restores_in_one_process_and_on_2x2(pool, jx,
                                                           tmp_path):
    case = "yi-6b/v16384"
    arch, over, cfg = case_cfg(case)
    d = str(tmp_path / "ckpt")
    written = pool.run(ranks.tp_step, *inputs(jx, case), 1, 2, True,
                       side.DP_OPT, 1, d)[0][0]
    params = zoo.init(cfg, torch.Generator().manual_seed(1), "cpu")
    tree, _, step = restore(d, None, {"params": params,
                                      "opt": adamw.init(params)})
    assert step == 1
    got = ranks.keyed_numpy(tree)
    assert list(got) == list(written)
    for k in written:
        np.testing.assert_array_equal(got[k], written[k], err_msg=k)
    out = pool.run(ranks.restore_on, d, arch, over, 2, True, 2)
    for k in written:
        np.testing.assert_array_equal(out[0][0][k], written[k], err_msg=k)
    # rank 3 (data 1, model 1): a quarter of embed (vocab over model,
    # d over data), wq's heads halved
    assert out[3][1]["['params']['embed']"] == (8192, cfg.d_model // 2)
    assert out[3][1]["['params']['groups'][0]['attn']['wq']"][2] == 2

