"""Tensor-parallel training over ``model`` of the MoE archs
(deepseek-moe-16b, llama4-maverick-400b-a17b): the MoE layer
expert-parallel through forward and backward (``moe.moe_apply_tp``), on
a mesh of gloo processes, on the CPU.

The helpers, the bounds and the pool are ``tests/test_torch_tp_train.py``'s
(and ``tests/test_torch_tp_train_recurrent.py``'s hold against one
process); the JAX side is ``tests/torch_jax_side.py``'s ``tp_train_moe``
job (its jitted single-device ``make_train_step`` on seed-0 weights,
``TP_MOE_CASES``; the reference's ``moe_apply_ep`` falls back to
``moe_apply`` there), started in a subprocess when the module starts.
Reduced configs at ``capacity_factor`` 8.0, where neither ``moe_apply``'s
groups nor the expert-parallel body's capacity over a rank's tokens
drops an assignment, so a mesh step computes one process's function;
AdamW at ``eps = 1``, 4 rows of 16 tokens.

* both archs under ``1x2``, ``2x2`` (FSDP on and off, at
  ``vocab_size=16384``, two microbatches) and ``1x4``, against one
  process: the loss, the aux loss and the grad norm within 1e-5, every
  leaf within 1e-5 or its nudged f32 floor; and against the JAX step
  within 2e-5 / 2e-4;
* in f64 (the gradient sums too) every gradient leaf within 1e-7 of one
  process's, the router's and the experts' among them: a sum over
  ``model`` missed, or the aux loss counted ``M`` times, would miss by
  its share;
* one MoE layer in f64: the aux loss, its gradients alone to the router
  and to the layer's input, and the output's to the router, the input
  and the experts, on each rank of ``1x2`` and ``1x4`` against one
  process's ``moe_apply``, and the collectives over ``model`` it runs;
* the form that stays whole: deepseek-moe-16b with 6 experts under
  ``1x4`` (experts and router replicated, ``moe_apply`` on every rank;
  the shared experts and the dense MLP split);
* each rank holds its placement's slices (the router's columns and the
  experts of its ``E / M``, the experts' ``moe_ff / D``), uses no leaf
  in part, and a ``1x2`` step runs exactly the collectives over
  ``model`` its ``ModelParallel`` counts, the dry-run reckoning the
  same;
* at the arch's own capacity 1.25 both paths' dropped assignments
  (``moe_apply``'s groups, the expert-parallel body's whole rank) are
  printed beside the ``1x2`` step's loss gap (ROADMAP Queue 3);
* ``launch/train.py --arch llama4-maverick-400b-a17b --mesh 1x2``.
"""

import io
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import test_torch_tp_train as base
import test_torch_tp_train_recurrent as rec
import torch_jax_side as side
import torch_train_ranks as ranks
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import MeshPool, ShapeMesh
from repro_torch.models import moe, zoo
from repro_torch.models.bridge import keyed_leaves, params_from_numpy
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

F64_REL = 1e-7
# one MoE layer in f64 against one process's
LAYER_F64_REL = 1e-12
ARCHS = ["deepseek-moe-16b", "llama4-maverick-400b-a17b"]
ONE_BY_TWO = [f"{a}/c8" for a in ARCHS]
TWO_BY_TWO = [f"{a}/c8v16384" for a in ARCHS]
WHOLE = "deepseek-moe-16b/c8e6"
MOE = "['params']['groups'][0]['moe']"


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    job = base._JaxSide(tmp_path_factory.mktemp("jax_tp_moe"),
                        "tp_train_moe")
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


def arch_of(case: str) -> str:
    return side.tp_case(case)[0]


def _mesh(data, model, rank=0):
    return types.SimpleNamespace(
        axis_names=("data", "model"), shape={"data": data, "model": model},
        data_index=rank // model, model_index=rank % model, rank=rank)


def assert_near(pool, jx, case, data, model, fsdp=True):
    """One process (the loss, the grad norm and every leaf, as
    ``test_torch_tp_train_recurrent`` holds them, and the aux loss within
    1e-5) and the JAX step (2e-5 / 2e-4)."""
    rec.assert_near_one_process(pool, jx, case, data, model, fsdp)
    _, metrics = base.one(pool, jx, case, n_micro=data)
    got = base.tp(pool, jx, case, data, model, fsdp)
    np.testing.assert_allclose(got[0][1]["aux"], metrics["aux"],
                               rtol=base.TP_REL)
    base.assert_near_jax(got, jx[case])


@pytest.mark.parametrize("case", ONE_BY_TWO)
def test_1x2_matches_one_process_and_jax(pool, jx, case):
    assert_near(pool, jx, case, 1, 2)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("case", TWO_BY_TWO)
def test_2x2_matches_one_process_and_jax(pool, jx, case, fsdp):
    assert_near(pool, jx, case, 2, 2, fsdp)


@pytest.mark.parametrize("case", ONE_BY_TWO)
def test_1x4_matches_one_process_and_jax(pool, jx, case):
    assert_near(pool, jx, case, 1, 4)


def test_experts_left_whole_under_1x4(pool, jx):
    """Four model ranks and 6 experts: the experts and the router stay
    whole on every rank and ``moe_apply`` runs replicated, as the
    reference falls back; the shared experts and the dense MLP split."""
    _, _, cfg = base.case_cfg(WHOLE)
    step = ts.make_mesh_train_step(cfg, adamw.AdamWConfig(), _mesh(1, 4))
    split = step.tp.split
    assert not split["experts"] and split["shared"] and split["mlp"]
    assert step.placement.partial == frozenset()
    shapes = base.tp(pool, jx, WHOLE, 1, 4)[0][2]
    assert shapes[MOE + "['w_gate']"] == (1, 6, cfg.d_model, cfg.moe_d_ff)
    assert shapes[MOE + "['router']"] == (1, cfg.d_model, 6)
    assert shapes[MOE + "['shared']['w_up']"] == (1, cfg.d_model,
                                                  cfg.moe_d_ff // 4)
    assert_near(pool, jx, WHOLE, 1, 4)


@pytest.mark.parametrize("case,data,model", [
    ("deepseek-moe-16b/c8", 1, 2), ("llama4-maverick-400b-a17b/c8", 1, 2),
    ("deepseek-moe-16b/c8", 1, 4), ("llama4-maverick-400b-a17b/c8", 1, 4),
    ("deepseek-moe-16b/c8v16384", 2, 2),
    ("llama4-maverick-400b-a17b/c8v16384", 2, 2), (WHOLE, 1, 4)])
def test_gradients_in_f64_equal_one_process(pool, jx, case, data, model):
    """With every float of the model and the gradient sums in f64, the
    gradients AdamW receives equal one process's within 1e-7 of each
    leaf's largest magnitude."""
    arch, over, weights, batch = base.inputs(jx, case)
    want = pool.run(ranks.tp_grads_f64, arch, over, weights, batch, data,
                    1)[0]
    got = pool.run(ranks.tp_grads_f64, arch, over, weights, batch, data,
                   model)[0]
    gap = base.gaps(got, want)
    worst = max(gap, key=gap.get)
    print(f"\n{case} {data}x{model} in f64: worst gradient {worst} "
          f"{gap[worst]:.3e}")
    assert gap[worst] <= F64_REL, (worst, gap[worst])


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_counts_once(pool, arch, model):
    """One MoE layer in f64: on every rank the aux loss and its gradients
    alone to the router's columns and to the input equal one process's
    (summed over ``model`` they would be ``M`` times it), and so do the
    output's gradients; the layer runs five all-reduces over ``model``
    (the routed and shared sums forward, their inputs' and the router's
    gradient backward) and one all-gather (the router), of the bytes it
    counts."""
    out = pool.run(ranks.tp_moe_aux, arch, {"capacity_factor": 8.0},
                   model)[:model]
    cfg = reduced(get_config(arch))
    act = 2 * 16 * cfg.d_model * 4
    router = cfg.d_model * cfg.num_experts * 4
    for gaps, counts in out:
        for name, gap in gaps.items():
            assert gap <= LAYER_F64_REL, (name, gap)
        # an all-reduce counts f32 bytes, an all-gather its input's: the
        # rank's f64 columns of the router
        assert counts == {"all-reduce": [5, 4 * act + router],
                          "all-gather": [1, 2 * router // model]}


@pytest.mark.parametrize("case,data,model,fsdp", [
    ("deepseek-moe-16b/c8", 1, 2, True),
    ("llama4-maverick-400b-a17b/c8", 1, 4, True),
    ("deepseek-moe-16b/c8v16384", 2, 2, True),
    ("llama4-maverick-400b-a17b/c8v16384", 2, 2, False)])
def test_each_rank_holds_its_placement_slices(pool, jx, case, data, model,
                                              fsdp):
    out = base.tp(pool, jx, case, data, model, fsdp)[:data * model]
    _, _, cfg = base.case_cfg(case)
    for r, got in enumerate(out):
        pl = ts.state_placement(cfg, _mesh(data, model, r), fsdp=fsdp)
        like = zoo.abstract_params(cfg)[0]
        tree = pl.local({"params": like, "opt": adamw.init(like)})
        assert got[2] == {k: tuple(v.shape) for k, v in keyed_leaves(tree)}
        assert pl.partial == frozenset()
    shapes, e, d = out[0][2], cfg.num_experts, cfg.d_model
    # deepseek's MoE layers are group 0 (after a dense prefix layer),
    # maverick's group 1 (dense and MoE layers alternate)
    layer = MOE if arch_of(case) == "deepseek-moe-16b" else MOE.replace(
        "[0]", "[1]")
    assert shapes[layer + "['router']"] == (1, d, e // model)
    assert shapes[layer + "['w_gate']"] == (1, e // model, d,
                                            cfg.moe_d_ff // data)
    assert shapes[layer + "['w_down']"] == (1, e // model,
                                            cfg.moe_d_ff // data, d)
    assert shapes[layer + "['shared']['w_down']"] == (
        1, cfg.moe_d_ff * cfg.num_shared_experts // model, d)
    assert out[0][3][0] > 0


@pytest.mark.parametrize("case", ONE_BY_TWO)
def test_1x2_step_runs_the_collectives_it_counts(pool, jx, case):
    """Every collective of a ``1x2`` step is an all-reduce or an
    all-gather over the two ranks of ``model``, as many and as large as
    the step's ``ModelParallel`` counts, the same on both ranks; the
    dry-run reckons the same step on ``meta`` with those counts."""
    arch, over, weights, batch = base.inputs(jx, case)
    out = pool.run(ranks.tp_collectives, arch, over, weights, batch,
                   side.DP_OPT)
    (calls, n, sent, counted), (calls1, n1, sent1, _) = out[:2]
    assert calls == calls1 and n == n1 == len(calls)
    assert set(calls) == {("all_reduce", (0, 1)), ("all_gather", (0, 1))}
    assert sent == sent1 == counted > 0
    cfg = reduced(get_config(arch), **over)
    rows, seq = batch["tokens"].shape
    rec_ = dryrun.reckon(cfg, ShapeConfig("t", seq, rows, "train"),
                         ShapeMesh((1, 2), ("data", "model")))
    coll = rec_["collectives"]
    assert rec_["split"] == "tensor-parallel rank"
    assert coll["count"] == n
    assert coll["all-gather"] + coll["all-reduce"] == counted
    assert coll["all-gather"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_drops_at_the_arch_capacity(pool, jx, arch):
    """At the arch's own capacity factor (1.25) the two paths drop
    different assignments: ``moe_apply`` caps each 16-token group (one
    process, and a ``Dx1`` mesh), the expert-parallel body all of a
    rank's tokens at once (``D x M``, ``M > 1``), as the reference's do.
    Both counts are printed beside the ``1x2`` step's loss gap from one
    process; at 8.0 (the other tests) neither drops."""
    case = f"{arch}/c8"
    _, over, weights, batch = base.inputs(jx, case)
    cfg = reduced(get_config(arch))
    seen = []
    real = moe.moe_apply_ep

    def record(params, x, *a, **kw):
        seen.append((params["router"], x))
        return real(params, x, *a, **kw)
    moe.moe_apply_ep = record
    try:
        params = params_from_numpy(weights, "cpu")
        with torch.no_grad():
            zoo.loss_fn(cfg, params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    finally:
        moe.moe_apply_ep = real
    drops = [sum(moe.dropped_assignments(r, x, cfg, grouped=g)
                 for r, x in seen) for g in (True, False)]
    for grouped in (True, False):
        assert sum(moe.dropped_assignments(
            r, x, reduced(get_config(arch), **over), grouped=grouped)
            for r, x in seen) == 0
    plain = {k: v for k, v in over.items() if k != "capacity_factor"}
    one = pool.run(ranks.one_process, arch, plain, weights, batch, 1,
                   side.DP_OPT)[0][1]
    mesh = pool.run(ranks.tp_step, arch, plain, weights, batch, 1, 2, True,
                    side.DP_OPT)[0][1]
    assigned = batch["tokens"].size * cfg.top_k
    print(f"\n{arch} at capacity {cfg.capacity_factor}: of {assigned} "
          f"assignments moe_apply's groups drop {drops[0]}, the "
          f"expert-parallel body's whole rank {drops[1]}; the 1x2 step's "
          f"loss {abs(mesh['loss'] - one['loss']) / one['loss']:.3e} from "
          "one process's")
    assert all(0 <= n < assigned for n in drops)
    assert np.isfinite(mesh["loss"])


def test_launcher_mesh_1x2_maverick(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        launch_train.main(["--arch", "llama4-maverick-400b-a17b", "--device",
                           "cpu", "--steps", "2", "--batch", "2", "--seq",
                           "16", "--mesh", "1x2", "--workdir",
                           str(tmp_path / "w")])
    assert "on mesh 1x2 (2 rows a rank, FSDP, tensor-parallel over 2)" \
        in out.getvalue()
