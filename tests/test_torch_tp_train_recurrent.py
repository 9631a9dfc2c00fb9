"""Tensor-parallel training over ``model`` of the recurrent archs
(recurrentgemma-9b's RG-LRU blocks, rwkv6-7b's RWKV-6 blocks) on a mesh
of gloo processes, on the CPU.

The helpers, the bounds and the JAX side are
``tests/test_torch_tp_train.py``'s: one ``MeshPool`` of four ranks (one
thread each), the ranks importing only the port
(``tests/torch_train_ranks.py``), and ``tests/torch_jax_side.py``'s
``tp_train_recurrent`` job (its jitted single-device ``make_train_step``
on seed-0 weights, ``TP_RECURRENT_CASES``) and the same in f64, each
started in a subprocess when the module starts.  Reduced configs, AdamW
at ``eps = 1``, 4 rows of 16 tokens.

* both archs under ``1x2`` (recurrentgemma-9b's ``dr`` of 64 and its one
  KV head; rwkv6 at ``d_model`` 64, one head, which two ranks straddle:
  ``ff`` split, ``heads`` whole), rwkv6 at ``d_model`` 256 (four heads)
  under ``1x2`` and ``1x4``, and both under ``2x2`` with FSDP on and off
  (at ``vocab_size=16384``; rwkv6 at ``d_model`` 128), each against one
  process: the loss within 1e-5; the grad norm and every leaf within
  1e-5 of its largest magnitude, or, past it, the grad norm within its
  own nudged f32 floor (its largest change over two one-process steps on
  weights nudged by 1e-7), each leaf within ``LEAF_TIMES`` times its own
  floor and the worst leaf within the worst floor;
* against the JAX step (2e-5 / 2e-4, at the 2x2 cases' two
  microbatches), for every metric and leaf that one process's own step
  meets them on; for the others, against the JAX step in f64 (job
  ``tp_train_recurrent_f64``), the grad norm within the bound or its
  nudged floor.  In f64 one process's step equals the JAX step (within
  ``JAX_F64_REL``; rwkv6's grad norm to 1e-13), so the f32 misses are
  rounding of one function: rwkv6 at d 256, whose f32 grad norm JAX's
  own step misses by 1.1e-4, and at d 128 over two microbatches, which
  one process's misses by 5.4e-5 (ROADMAP Queue 3);
* in f64 (the gradient sums too) every gradient leaf within 1e-7 of one
  process's: the forms compute the one-device function;
* ``sum_to_slice`` and ``gather_from_slice``: outputs and gradients
  against one process's products; in f32 the blocks' forms equal one
  process's slices bit for bit up to their first sum over ``model``
  (the RG-LRU's gate inputs, RWKV-6's ``wo`` row sum), the first
  rounding;
* each rank holds only its placement's slices, the leaves it uses in
  part are the ones its step sums over ``model``, and a ``1x2`` step runs
  exactly the all-reduces and all-gathers over ``model`` its
  ``ModelParallel`` counts, the dry-run reckoning the same;
* recurrentgemma-9b at ``M = 3`` (``d_ff`` 96, ``recurrentgemma-9b/ff96``):
  three ranks split the MLP and leave the RG-LRU's ``dr`` of 64 whole,
  as the reference's ``_resolve`` does; the RG-LRU runs replicated and
  the step equals one process (f64 within 1e-7, f32 within the bounds
  above) and the JAX step.  At full size (``dr`` 4096, ``d_ff`` 12288)
  the placement and the step build; two ``ff`` leaves of one block that
  ``model`` splits differently still raise (rwkv6-7b at ``M = 7``:
  ``d`` 4096 whole, ``d_ff`` 14336 split);
* ``launch/train.py --arch rwkv6-7b --mesh 1x2 --device cpu``.
"""

import io
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import test_torch_tp_train as base
import torch_jax_side as side
import torch_train_ranks as ranks
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import MeshPool, ShapeMesh
from repro_torch.models import zoo
from repro_torch.models.bridge import keyed_leaves
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

F64_REL = 1e-7
# past TP_REL, a leaf may be this many times its own nudged floor
# (chip_smoke.py's 18b and 18e, TP_LEAF_TIMES); the case's worst leaf
# may not pass the worst floor, nor the grad norm its own
LEAF_TIMES = 3
# one process's f64 step against the JAX step in f64: the port keeps
# AdamW's moments and the rotary frequencies in f32 there
JAX_F64_REL = 2e-6
ONE_BY_TWO = ["recurrentgemma-9b", "rwkv6-7b", "rwkv6-7b/d256"]
TWO_BY_TWO = ["recurrentgemma-9b/v16384", "rwkv6-7b/d128v16384"]
RG = "['params']['groups'][{}]['rglru']"
TM = "['params']['groups'][0]['tm_cm']"


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    job = base._JaxSide(tmp_path_factory.mktemp("jax_tp_recurrent"),
                        "tp_train_recurrent")
    yield job
    if job.proc.poll() is None:
        job.proc.kill()
        job.proc.wait()


@pytest.fixture(scope="module")
def jx(jax_side):
    return jax_side.get()


@pytest.fixture(scope="module")
def jax_exact(tmp_path_factory):
    """The JAX step in f64 (``tp_train_recurrent_f64``), started beside
    the f32 job."""
    job = base._JaxSide(tmp_path_factory.mktemp("jax_tp_recurrent_f64"),
                        "tp_train_recurrent_f64")
    yield job
    if job.proc.poll() is None:
        job.proc.kill()
        job.proc.wait()


@pytest.fixture(scope="module")
def jx64(jax_exact):
    return jax_exact.get()


@pytest.fixture(scope="module")
def pool(jax_side, jax_exact):
    p = MeshPool(4, 1, device="cpu", timeout_s=60.0,
                 threads=1)
    yield p
    p.close()


def _mesh(data, model, rank=0):
    return types.SimpleNamespace(
        axis_names=("data", "model"), shape={"data": data, "model": model},
        data_index=rank // model, model_index=rank % model, rank=rank)


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def floors(pool, jx, case, data):
    """One process's nudged f32 floors: each leaf's and the grad norm's
    largest gap between its step and the steps on weights nudged by
    ``NUDGE`` from ``NUDGE_SEEDS``, the scale at which f32 rounding
    moves this step (memoised with the runs)."""
    state, metrics = base.one(pool, jx, case, n_micro=data)
    nudged = [base.one(pool, jx, case, data, seed)
              for seed in base.NUDGE_SEEDS]
    leaf = {k: max(base.gaps(n[0], state)[k] for n in nudged)
            for k in state}
    norm = max(rel(n[1]["grad_norm"], metrics["grad_norm"])
               for n in nudged)
    return leaf, norm


def assert_near_one_process(pool, jx, case, data, model, fsdp=True):
    """Loss, grad norm and every leaf of the gathered state against one
    process at ``data`` microbatches (see the module docstring)."""
    state, metrics = base.one(pool, jx, case, n_micro=data)
    out = base.tp(pool, jx, case, data, model, fsdp)
    full, m = out[0][0], out[0][1]
    assert [r[1] for r in out[:data * model]] == [m] * (data * model)
    for k in ("loss", "ce"):
        np.testing.assert_allclose(m[k], metrics[k], rtol=base.TP_REL,
                                   err_msg=k)
    assert set(full) == set(state)
    gap = base.gaps(full, state)
    worst = max(gap, key=gap.get)
    norm = rel(m["grad_norm"], metrics["grad_norm"])
    print(f"\n{case} {data}x{model} fsdp {fsdp}: loss gap "
          f"{rel(m['loss'], metrics['loss']):.3e}, grad norm {norm:.3e}, "
          f"worst leaf {worst} {gap[worst]:.3e}")
    if gap[worst] <= base.TP_REL and norm <= base.TP_REL:
        return
    leaf, norm_floor = floors(pool, jx, case, data)
    print(f"  nudged floors: grad norm {norm_floor:.3e}, worst leaf "
          f"{max(leaf.values()):.3e}; the largest leaf over its own floor "
          f"or TP_REL {max(v / max(base.TP_REL, leaf[k]) for k, v in gap.items()):.2f}x")
    assert norm <= max(base.TP_REL, norm_floor), (norm, norm_floor)
    assert gap[worst] <= max(base.TP_REL, max(leaf.values())), (
        worst, gap[worst])
    for k, v in gap.items():
        assert v <= max(base.TP_REL, LEAF_TIMES * leaf[k]), (k, v, leaf[k])


def assert_near_jax(pool, jx, jx64, case, data, model, fsdp=True):
    """Loss, grad norm, lr and every leaf of the gathered state against
    the JAX step within ``LOSS_RTOL`` / ``GRAD_REL``; each one that one
    process's own step misses by more against the JAX step in f64,
    within the bound or its nudged floor (see the module docstring)."""
    full, m = base.tp(pool, jx, case, data, model, fsdp)[0][:2]
    state, metrics = base.one(pool, jx, case, n_micro=data)
    want, exact = jx[case], jx64[case]
    leaf, norm_floor = None, 0.0
    for k, bound in (("loss", base.LOSS_RTOL), ("ce", base.LOSS_RTOL),
                     ("grad_norm", base.LOSS_RTOL), ("lr", base.LOSS_RTOL)):
        if rel(metrics[k], want["metrics"][k]) <= bound:
            got = rel(m[k], want["metrics"][k])
            assert got <= bound, (k, got)
            continue
        if leaf is None:
            leaf, norm_floor = floors(pool, jx, case, data)
        got = rel(m[k], exact["metrics"][k])
        print(f"\n{case} {data}x{model}: one process's {k} is "
              f"{rel(metrics[k], want['metrics'][k]):.3e} from JAX's "
              f"(JAX's own {rel(want['metrics'][k], exact['metrics'][k]):.3e}"
              f" from its f64 step), the tensor-parallel step's {got:.3e} "
              f"from JAX's f64 step (nudged floor {norm_floor:.3e})")
        assert got <= max(bound, norm_floor if k == "grad_norm" else 0.0), (
            k, got, norm_floor)
    assert set(full) == set(want["state"])
    one_gap = base.gaps(state, want["state"])
    tp_gap = base.gaps(full, want["state"])
    tp_exact = base.gaps(full, exact["state"])
    for k, v in tp_gap.items():
        if one_gap[k] <= base.GRAD_REL:
            assert v <= base.GRAD_REL, (k, v)
        else:
            assert tp_exact[k] <= base.GRAD_REL, (k, v, tp_exact[k])


@pytest.mark.parametrize("case", ONE_BY_TWO)
def test_1x2_matches_one_process(pool, jx, case):
    assert_near_one_process(pool, jx, case, 1, 2)


@pytest.mark.parametrize("case", ONE_BY_TWO)
def test_1x2_matches_jax_step(pool, jx, jx64, case):
    assert_near_jax(pool, jx, jx64, case, 1, 2)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("case", TWO_BY_TWO)
def test_2x2_matches_one_process_and_jax(pool, jx, jx64, case, fsdp):
    assert_near_one_process(pool, jx, case, 2, 2, fsdp)
    assert_near_jax(pool, jx, jx64, case, 2, 2, fsdp)


def test_1x4_heads_split_matches_one_process_and_jax(pool, jx, jx64):
    case = "rwkv6-7b/d256"
    assert_near_one_process(pool, jx, case, 1, 4)
    assert_near_jax(pool, jx, jx64, case, 1, 4)


def test_1x3_mlp_split_rglru_whole_matches_one_process_and_jax(pool, jx,
                                                               jx64):
    """recurrentgemma-9b at ``d_ff`` 96 on three model ranks: the MLP's
    ``d_ff`` splits, the RG-LRU's ``dr`` (64) and the heads (4) do not,
    so the RG-LRU and the attention run whole on every rank and nothing
    is used in part; the step equals one process's and the JAX step."""
    case = "recurrentgemma-9b/ff96"
    _, _, cfg = base.case_cfg(case)
    step = ts.make_mesh_train_step(cfg, adamw.AdamWConfig(), _mesh(1, 3))
    assert step.tp.split["mlp"] and not step.tp.split["rglru"]
    assert not step.tp.split["heads"] and step.placement.partial == set()
    assert_near_one_process(pool, jx, case, 1, 3)
    assert_near_jax(pool, jx, jx64, case, 1, 3)


@pytest.mark.parametrize("case,data,model", [
    ("recurrentgemma-9b", 1, 2), ("rwkv6-7b", 1, 2), ("rwkv6-7b/d256", 1, 2),
    ("rwkv6-7b/d256", 1, 4), ("recurrentgemma-9b/v16384", 2, 2),
    ("rwkv6-7b/d128v16384", 2, 2), ("recurrentgemma-9b/ff96", 1, 3)])
def test_gradients_in_f64_equal_one_process(pool, jx, case, data, model):
    """With every float of the model and the gradient sums in f64, the
    gradients AdamW receives equal one process's within 1e-7 of each
    leaf's largest magnitude: a leaf used in part and left out of the
    sums over ``model``, or a slice gradient not put together, would
    miss by its share."""
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


@pytest.mark.parametrize("kind,d,width,heads_split", [
    ("rglru", 64, 64, False), ("rwkv6", 256, 256, True),
    ("rwkv6", 64, 64, False)])
def test_first_rounding_is_a_sum_over_model(pool, kind, d, width,
                                            heads_split):
    """In f32 on ``1x2``, every traced tensor of the block forms before
    the first sum over ``model`` equals one process's slice bit for bit:
    the RG-LRU's conv output; the RWKV-6 projections, the decay and the
    chunk loop's output, head-parallel or on gathered whole heads.  The
    first tensor that differs is the first sum in another order: the
    RG-LRU's gate inputs (two partial products of ``u @ wa`` and ``u @
    wx``), RWKV-6's output (``wo``'s row-parallel sum); it and all that
    follows stay within 2e-6 of their largest magnitudes."""
    out = pool.run(ranks.tp_block_trace, kind, d, width, heads_split)[:2]
    first = "u @ wa (gate input)" if kind == "rglru" else \
        "output (summed over model)"
    for trace in out:
        names = [n for n, _, _ in trace]
        cut = names.index(first)
        print(f"\n{kind} d {d}: " + ", ".join(
            f"{n} {np.abs(g - w).max() / np.abs(w).max():.2e}"
            for n, g, w in trace))
        for name, got, want in trace[:cut]:
            np.testing.assert_array_equal(got, want, err_msg=name)
        assert not np.array_equal(trace[cut][1], trace[cut][2])
        for name, got, want in trace[cut:]:
            assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max(), \
                name


def test_slice_pair_matches_one_process(pool):
    rng = np.random.default_rng(30)
    x, w1, w2, c = (rng.standard_normal(s).astype(np.float32) for s in (
        (3, 5, 8), (8, 6), (6, 10), (10,)))
    got = pool.run(ranks.tp_slice_pair, x, w1, w2, c)[:2]
    t = {k: torch.from_numpy(v).requires_grad_()
         for k, v in dict(x=x, w1=w1, w2=w2).items()}
    s = torch.tanh(t["x"] @ t["w1"]) @ t["w2"]
    a = torch.tanh(s)
    loss = (torch.softmax(a, -1) * torch.from_numpy(c)).sum() \
        + a.square().sum()
    loss.backward()
    for r, (g, counts) in enumerate(got):
        np.testing.assert_allclose(g["s"], torch.chunk(s, 2, -1)[r]
                                   .detach().numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["z"], a.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(g["loss"], loss.item(), rtol=1e-6)
        np.testing.assert_allclose(g["d_x"], t["x"].grad.numpy(),
                                   rtol=1e-5, atol=1e-6)
        for k, dim in (("w1", 1), ("w2", 0)):
            want = torch.chunk(t[k].grad, 2, dim=dim)[r].numpy()
            np.testing.assert_allclose(g["d_" + k], want, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        # all-reduces: s and the loss forward, z's and x's gradients
        # backward; all-gathers: z forward, s's gradient backward (f32
        # elements of [3, 5, 10], [3, 5, 5], [3, 5, 8])
        assert counts == {"all-reduce": [4, 4 * (150 + 1 + 150 + 120)],
                          "all-gather": [2, 4 * (75 + 75)]}


@pytest.mark.parametrize("case,data,model,fsdp", [
    ("recurrentgemma-9b", 1, 2, True), ("rwkv6-7b", 1, 2, True),
    ("rwkv6-7b/d256", 1, 4, True), ("recurrentgemma-9b/v16384", 2, 2, True),
    ("rwkv6-7b/d128v16384", 2, 2, False)])
def test_each_rank_holds_its_placement_slices(pool, jx, case, data, model,
                                              fsdp):
    out = base.tp(pool, jx, case, data, model, fsdp)[:data * model]
    _, _, cfg = base.case_cfg(case)
    for r, got in enumerate(out):
        pl = ts.state_placement(cfg, _mesh(data, model, r), fsdp=fsdp)
        like = zoo.abstract_params(cfg)[0]
        tree = pl.local({"params": like, "opt": adamw.init(like)})
        assert got[2] == {k: tuple(v.shape) for k, v in keyed_leaves(tree)}
    shapes, partial = out[0][2], pl.partial
    if case.startswith("recurrentgemma"):
        dr, d = cfg.num_heads * cfg.resolved_head_dim, cfg.d_model
        assert shapes[RG.format(0) + "['w_in']"] == (1, d, dr // model)
        assert shapes[RG.format(1) + "['wa']"] == (1, dr // model, dr)
        assert shapes[RG.format(0) + "['ba']"] == (1, dr)
        attn = "['params']['groups'][2]['attn']"
        want = {RG.format(i) + f"[{n!r}]" for i in (0, 1)
                for n in ("ba", "bx", "lam")}
        want |= {attn + "['wk']", attn + "['wv']"}
    else:
        heads, n = cfg.d_model // 64, cfg.num_layers
        split = heads % model == 0
        assert shapes[TM + "['wr']"][2] == cfg.d_model // model
        assert shapes[TM + "['u']"] == (n, heads // model if split
                                        else heads, 64)
        assert shapes[TM + "['w_lora_b']"] == (n, 64, cfg.d_model)
        want = {TM + f"[{n!r}]" for n in (
            "mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0", "w_lora_a",
            "w_lora_b", "ln_scale") + (() if split else ("u",))}
    assert partial == want
    assert out[0][3][0] > 0


@pytest.mark.parametrize("case", ["recurrentgemma-9b", "rwkv6-7b"])
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
    rec = dryrun.reckon(cfg, ShapeConfig("t", seq, rows, "train"),
                        ShapeMesh((1, 2), ("data", "model")))
    coll = rec["collectives"]
    assert rec["split"] == "tensor-parallel rank"
    assert coll["count"] == n
    assert coll["all-gather"] + coll["all-reduce"] == counted
    assert coll["all-gather"] > 0


def test_ff_family_disagreement_raises():
    """recurrentgemma-9b at ``M = 3``: ``model`` divides the MLP's
    ``d_ff`` (12288) but not the RG-LRU's ``dr`` (4096), both of the
    ``ff`` family.  The split is decided block by block, as the
    reference's ``_resolve`` decides it dim by dim: the placement and the
    step build, the MLP split and the RG-LRU whole (no leaf used in
    part); at ``M = 2`` and ``4`` both split.  Two ``ff`` leaves of one
    block still raise when ``model`` places them differently: rwkv6-7b at
    ``M = 7`` divides its channel mix's ``d_ff`` (14336), not ``d``
    (4096)."""
    cfg = get_config("recurrentgemma-9b")
    pl = ts.state_placement(cfg, _mesh(1, 3))
    assert pl.partial == set()
    split = ts.make_mesh_train_step(cfg, adamw.AdamWConfig(),
                                    _mesh(1, 3)).tp.split
    assert split["mlp"] and not split["rglru"] and not split["heads"]
    for m in (2, 4):
        # ba, bx and lam of the two stacked RG-LRU groups and the two
        # remainder layers; the swa layers' wk and wv (one KV head)
        pl = ts.state_placement(cfg, _mesh(1, m))
        assert len(pl.partial) == 3 * 2 + 3 * 2 + 2
    rwkv = get_config("rwkv6-7b")
    for call in (lambda m: ts.state_placement(rwkv, m),
                 lambda m: ts.make_mesh_train_step(rwkv, adamw.AdamWConfig(),
                                                   m)):
        with pytest.raises(ValueError, match=r"(?s)tm_cm.*tm_cm.*tm_cm's "
                           r"'ff' dim differently"):
            call(_mesh(1, 7))


def test_launcher_mesh_1x2_rwkv6(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        launch_train.main(["--arch", "rwkv6-7b", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "16",
                           "--mesh", "1x2", "--workdir",
                           str(tmp_path / "w")])
    assert "on mesh 1x2 (2 rows a rank, FSDP, tensor-parallel over 2)" \
        in out.getvalue()


@pytest.mark.parametrize("case", list(side.TP_RECURRENT_CASES))
def test_one_process_f64_matches_jax_f64(pool, jx, jx64, case):
    """With every float in f64 on both sides, one process's port step
    equals the JAX step: where an f32 step misses the JAX step by more
    than ``LOSS_RTOL`` / ``GRAD_REL`` (rwkv6 at d 256, where JAX's own
    f32 grad norm is 1.1e-4 from its f64 step), that is f32 rounding of
    one function, not a fault of the port's form."""
    arch, over, weights, batch = base.inputs(jx, case)
    data = side.TP_MICRO.get(case, 1)
    got, gm = base.run_once(pool, ("one f64", case, data),
                            ranks.one_process_f64, arch, over, weights,
                            batch, data, side.DP_OPT)[0]
    want = jx64[case]
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert rel(gm[k], want["metrics"][k]) <= JAX_F64_REL, k
    gap = base.gaps(got, want["state"])
    worst = max(gap, key=gap.get)
    print(f"\n{case} in f64: grad norm "
          f"{rel(gm['grad_norm'], want['metrics']['grad_norm']):.3e}, worst "
          f"leaf {worst} {gap[worst]:.3e}; in f32 JAX's own grad norm is "
          f"{rel(jx[case]['metrics']['grad_norm'], want['metrics']['grad_norm']):.3e}"
          " from its f64 step")
    assert gap[worst] <= JAX_F64_REL, (worst, gap[worst])
