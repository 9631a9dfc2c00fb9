"""Data-parallel training on a mesh of gloo processes, on the CPU.

One ``MeshPool`` of four ranks (one thread each) serves every case; a
``2x1`` mesh runs on its first two ranks.  The ranks import only the
port (``tests/torch_train_ranks.py``); the JAX package's side
(``tests/torch_jax_side.py``'s ``dp_train`` job) runs once, in a
subprocess with eight fake CPU devices: its single-device
``make_train_step`` at ``n_micro = 2`` on seed-0 weights, which the port
takes through the bridge, and its ``compressed_psum_grads`` under
``shard_map`` on four devices.  Reduced configs at ``vocab_size=16384``,
so embed and head reach ``FSDP_THRESHOLD`` (yi-6b, deepseek-moe-16b,
rwkv6-7b at ``d_model=128``; deepseek's experts split ``moe_ff`` over
data at any size).

* ``2x1``, FSDP on and off, equals one rank at ``n_micro = 2`` (the same
  thread count) bit for bit: loss, aux, grad norm and every parameter
  and moment after one step (deepseek-moe-16b on one row a rank:
  ``torch_jax_side.DP_ONE_ROW``);
* a ``2x1`` rank of deepseek-moe-16b holding 2 x 320 tokens at capacity
  1.25 caps its MoE layer over all of its rows, as the reference's
  expert-parallel body does: its step matches the reference's step under
  a ``1x1`` mesh at two microbatches, and not one process's, whose
  groups of a row drop other assignments; at the other cases' 2 x 24
  tokens a rank it matches that mesh step too;
* ``4x1`` is within 1e-6 of each leaf's largest magnitude of one rank
  at ``n_micro = 4`` (gloo sums four ranks in its own order);
* the ``2x1`` step against JAX's: loss within ``2e-5`` relative, every
  parameter and moment within ``2e-4`` of its largest magnitude (the
  bounds of ``tests/test_torch_train.py``).  AdamW runs at ``eps = 1``
  (``torch_jax_side.DP_OPT``), where a parameter's step reads its
  gradient;
* the 4-rank compressed mean equals JAX's bit for bit, and is within
  0.02 of the exact mean's largest magnitude (the reference's bound);
* a ``2x1`` checkpoint restores bit for bit in one process and on
  ``4x1`` (the elastic restore, each rank holding its slices);
* ``Trainer(mesh=)``'s ranks take every checkpoint on the same step, and
  a fresh Trainer resumes from the gathered checkpoint;
* ``launch/train.py --mesh 2x1 --device cpu`` runs;
* a mesh with ``model > 1`` takes the recurrent and the MoE archs (the
  MoE ones through the launcher too); it raises ``ValueError`` where a
  chunk of query heads would straddle two GQA groups, and so does a
  mesh with an axis other than ``data`` and ``model``.
"""

import io
import types
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_jax_side as side
import torch_train_ranks as ranks
from repro_torch.checkpoint import latest_step, restore
from repro_torch.configs import get_config, reduced
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import MeshPool
from repro_torch.models import zoo
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

LOSS_RTOL = 2e-5
GRAD_REL = 2e-4
FOUR_REL = 1e-6


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return side.run("dp_train", tmp_path_factory.mktemp("jax_dp"))


@pytest.fixture(scope="module")
def pool():
    p = MeshPool(4, 1, device="cpu", timeout_s=60.0,
                 threads=1)
    yield p
    p.close()


def inputs(jx, arch, data=2):
    cfg = reduced(get_config(arch), **side.DP_OVERRIDES[arch])
    return (arch, side.DP_OVERRIDES[arch], jx["train"][arch]["weights"],
            side.dp_batch(cfg.vocab_size, side.dp_rows(arch, data)))


_RUNS: dict = {}


def run_once(pool, key, fn, *args):
    """``pool.run`` memoised: cases share the runs they compare."""
    if key not in _RUNS:
        _RUNS[key] = pool.run(fn, *args)
    return _RUNS[key]


def baseline(pool, jx, arch, n_micro):
    return run_once(pool, ("one", arch, n_micro), ranks.one_process,
                    *inputs(jx, arch, n_micro), n_micro, side.DP_OPT)[0]


def dp(pool, jx, arch, data, fsdp):
    return run_once(pool, ("dp", arch, data, fsdp), ranks.dp_step,
                    *inputs(jx, arch, data), data, fsdp, side.DP_OPT)


def assert_equal_state(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", side.DP_ARCHS)
def test_2x1_equals_one_rank_bit_for_bit(pool, jx, arch, fsdp):
    state, metrics = baseline(pool, jx, arch, 2)
    out = dp(pool, jx, arch, 2, fsdp)
    assert out[2:] == [None, None]
    full, m, shapes = out[0]
    assert_equal_state(full, state)
    for r in out[:2]:
        assert r[1] == metrics
    # FSDP cut the big leaves (and their moments) in two; off, only the
    # experts' moe_ff (the default rules put it on data at any size)
    halved = [k for k, s in shapes.items() if s != state[k].shape]
    if fsdp:
        assert "['params']['embed']" in halved
        assert ".m['embed']" in "".join(halved)
    else:
        assert all("moe" in k for k in halved)
        assert bool(halved) == (arch == "deepseek-moe-16b")


@pytest.mark.parametrize("arch", side.DP_ARCHS)
def test_fsdp_on_equals_fsdp_off(pool, jx, arch):
    on = dp(pool, jx, arch, 2, True)[0]
    off = dp(pool, jx, arch, 2, False)[0]
    assert_equal_state(on[0], off[0])
    assert on[1] == off[1]


@pytest.mark.parametrize("arch", side.DP_ARCHS)
def test_4x1_within_f32_rounding_of_one_rank(pool, jx, arch):
    state, metrics = baseline(pool, jx, arch, 4)
    out = dp(pool, jx, arch, 4, True)
    full, m, _ = out[0]
    assert [r[1] for r in out] == [m] * 4
    np.testing.assert_allclose(m["loss"], metrics["loss"], rtol=FOUR_REL)
    np.testing.assert_allclose(m["grad_norm"], metrics["grad_norm"],
                               rtol=FOUR_REL)
    for k, want in state.items():
        err = np.abs(full[k] - want).max()
        assert err <= FOUR_REL * max(np.abs(want).max(), 1e-30), (k, err)


@pytest.mark.parametrize("arch", side.DP_ARCHS)
def test_2x1_matches_jax_step(pool, jx, arch):
    full, m, _ = dp(pool, jx, arch, 2, True)[0]
    want = jx["train"][arch]
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(m[k], want["metrics"][k], rtol=LOSS_RTOL)
    assert set(full) == set(want["state"])
    for k, a in want["state"].items():
        err = np.abs(full[k] - a).max()
        assert err <= GRAD_REL * max(np.abs(a).max(), 1e-30), (k, err)


def test_dx1_moe_rank_caps_over_its_rows(pool, jx):
    arch = side.DP_MOE_ARCH
    want = jx["moe_capacity"]
    args = (arch, side.DP_OVERRIDES[arch], want["weights"],
            side.dp_batch(16384, side.DP_MOE_ROWS, seq=side.DP_MOE_SEQ))
    full, m, _ = pool.run(ranks.dp_step, *args, 2, True, side.DP_OPT)[0]
    one_state, one = pool.run(ranks.one_process, *args, 2,
                              side.DP_OPT)[0]

    def worst(state):
        return max(np.abs(state[k] - a).max() / max(np.abs(a).max(), 1e-30)
                   for k, a in want["state"].items())
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(m[k], want["metrics"][k], rtol=LOSS_RTOL)
    assert worst(full) <= GRAD_REL
    # one process's groups of 320 drop other assignments
    print(f"worst leaf: 2x1 {worst(full):.3g}, one process "
          f"{worst(one_state):.3g}; loss {m['loss']!r} vs one process's "
          f"{one['loss']!r}")
    assert worst(one_state) > 10 * GRAD_REL


def test_dx1_moe_rank_of_two_rows_matches_jax_mesh_step(pool, jx):
    """The data-parallel cases' input size with two rows a rank: the 2x1
    ranks' step against the reference's step under a 1x1 mesh, whose MoE
    layer caps over each microbatch's rows as a rank's does."""
    arch = side.DP_MOE_ARCH
    want = jx["moe_capacity_rows"]
    full, m, _ = pool.run(ranks.dp_step, arch, side.DP_OVERRIDES[arch],
                          jx["moe_capacity"]["weights"],
                          side.dp_batch(16384, side.DP_ROWS), 2, True,
                          side.DP_OPT)[0]
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(m[k], want["metrics"][k], rtol=LOSS_RTOL)
    assert set(full) == set(want["state"])
    for k, a in want["state"].items():
        err = np.abs(full[k] - a).max()
        assert err <= GRAD_REL * max(np.abs(a).max(), 1e-30), (k, err)


def test_compressed_mean_matches_jax(pool, jx):
    grads = side.compressed_case()
    out = pool.run(ranks.compressed, grads, side.COMPRESSED_RANKS)
    want = jx["compressed"]
    for r, (got, exact) in enumerate(out):
        for k in grads:
            np.testing.assert_array_equal(got[k], want[k][r], err_msg=k)
            scale = np.abs(exact[k]).max() + 1e-9
            assert np.abs(got[k] - exact[k]).max() / scale < 0.02
    assert np.all(out[0][0]["z"] == 0.0)


def test_elastic_restore_bit_for_bit(pool, jx, tmp_path):
    arch = "yi-6b"
    d = str(tmp_path / "ckpt")
    written = pool.run(ranks.dp_step, *inputs(jx, arch), 2, True,
                       side.DP_OPT, 1, d)[0][0]
    # one process: the whole tree
    cfg = reduced(get_config(arch), **side.DP_OVERRIDES[arch])
    params = zoo.init(cfg, torch.Generator().manual_seed(1),
                      "cpu")
    tree, _, step = restore(d, None, {"params": params,
                                      "opt": adamw.init(params)})
    assert step == 1
    assert_equal_state(ranks.keyed_numpy(tree), written)
    # four ranks: each its quarter of the FSDP leaves
    out = pool.run(ranks.restore_on, d, arch, side.DP_OVERRIDES[arch], 4,
                   True)
    assert_equal_state(out[0][0], written)
    assert out[1][1]["['params']['embed']"] == (16384, 16)


def test_trainer_ranks_agree_on_every_checkpoint(pool, tmp_path):
    arch, over = "yi-6b", {"vocab_size": 16384}
    work = str(tmp_path / "train")
    out = pool.run(ranks.trainer_steps, work, arch, over, 2, 7, True)
    (trail, rows), (trail1, rows1) = out[:2]
    assert out[2:] == [None, None]
    assert trail == trail1 and rows == rows1 == 2
    saved = sorted({t[2] for t in trail if t[2] is not None})
    assert saved and trail[-1][3] == len(saved)
    resumed = pool.run(ranks.trainer_resume, work, arch, over, 2, True)
    assert resumed[0][0] == resumed[1][0] == trail[-1][2]
    cfg = reduced(get_config(arch), **over)
    params = zoo.init(cfg, torch.Generator().manual_seed(1),
                      "cpu")
    tree, _, _ = restore(work + "/ckpt", None,
                         {"params": params, "opt": adamw.init(params)})
    assert_equal_state(resumed[0][1], ranks.keyed_numpy(tree))


def test_launcher_mesh_runs(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        launch_train.main(["--arch", "yi-6b", "--device", "cpu", "--steps",
                           "3", "--batch", "4", "--seq", "16", "--mesh",
                           "2x1", "--workdir", str(tmp_path / "w")])
    text = out.getvalue()
    assert "on mesh 2x1 (2 rows a rank, FSDP)" in text
    saved = int(text.rsplit("last ckpt @ step ", 1)[1])
    assert latest_step(str(tmp_path / "w" / "ckpt")) == saved


def test_rank_module_imports_no_jax():
    """The ranks run ``torch_train_ranks``, which must stand alone as
    ``torch_mesh_ranks`` does (``tests/test_torch_import.py``)."""
    from test_torch_import import _imports
    path = Path(ranks.__file__)
    assert [n for n in _imports(path) if n.split(".")[0] in
            ("jax", "jaxlib", "repro", "benchmarks")] == []


def test_model_axis_raises(tmp_path):
    """Tensor-parallel training takes every arch
    (``tests/test_torch_tp_train.py``,
    ``tests/test_torch_tp_train_recurrent.py``,
    ``tests/test_torch_tp_train_moe.py``): on a mesh with ``model > 1``
    the recurrent archs build the placement and the step, with leaves
    used in part, and so do the MoE ones, with none (the router is split
    with the experts), and the launcher trains them; a mesh whose chunks
    of query heads straddle two GQA groups raises, and so does an axis
    other than ``data`` and ``model``."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": 2},
                                 data_index=0, model_index=0, rank=0)
    for arch, owner in (("recurrentgemma-9b", "rglru"),
                        ("rwkv6-7b", "tm_cm")):
        cfg = reduced(get_config(arch))
        assert ts.state_placement(cfg, mesh).partial
        assert ts.make_mesh_train_step(cfg, adamw.AdamWConfig(),
                                       mesh).tp.split[owner]
    for arch in ("deepseek-moe-16b", "llama4-maverick-400b-a17b"):
        cfg = reduced(get_config(arch))
        assert not ts.state_placement(cfg, mesh).partial
        split = ts.make_mesh_train_step(cfg, adamw.AdamWConfig(),
                                        mesh).tp.split
        assert split["experts"] and split["shared"] and split["mlp"]
        out = io.StringIO()
        with redirect_stdout(out):
            launch_train.main(["--arch", arch, "--device", "cpu", "--mesh",
                               "1x2", "--steps", "1", "--batch", "2",
                               "--seq", "16", "--workdir",
                               str(tmp_path / arch)])
        assert "tensor-parallel over 2" in out.getvalue()
        ts.state_placement(cfg, types.SimpleNamespace(
            axis_names=("data", "model"), shape={"data": 2, "model": 1},
            data_index=0, model_index=0, rank=0))
    straddle = reduced(get_config("yi-6b"), num_heads=12, num_kv_heads=3)
    with pytest.raises(ValueError, match="straddle"):
        ts.make_mesh_train_step(straddle, adamw.AdamWConfig(), mesh)
    ts.state_placement(reduced(get_config("yi-6b")), mesh)
    with pytest.raises(ValueError, match="data and model only"):
        ts.check_train_mesh({"pod": 2, "data": 1, "model": 2})
