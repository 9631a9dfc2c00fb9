"""The port's dry-run (``repro_torch.launch.dryrun``) on reduced cells.

* A reduced yi-6b train cell and decode cell (and a prefill cell) on a
  ``1x1`` and a ``2x2`` stand-in mesh: each record is ``ok``, with the
  reference's keys, and its argument bytes a rank equal the sum of the
  sliced leaves, each cut by ``sharding.Placement.leaf_local`` at rank
  0.
* On ``1x1`` the counted product FLOPs against the reference's
  ``hlo_cost.analyze_module(...)["flops"]`` of the same reduced cell,
  computed in a subprocess (``tests/torch_jax_tooling.py``): within 25%;
  decode equal; prefill equal once the flash kernel's causal skip is
  added back (the reference's XLA attention multiplies every pair); the
  train cell under ``remat="dots"`` (the default: the products without
  batch dims saved, as the reference saves them) within 5%, its gap
  stated term by term: the loss chunk's logits, which the port computes
  again in the backward pass and the compiled reference once, and the
  flash kernels' products over the causal pairs against the reference's
  over all of them.  ``"dots"`` reckons more than ``"none"`` and fewer
  than ``"full"`` for every family.
* The production meshes' shapes, the CLI's record path, and a cell that
  cannot run on ``meta`` recorded ``ok: false`` with its op.
* The tensor-parallel train cells: yi-6b, starcoder2-15b, gemma3-4b and
  internvl2-1b ``train_4k`` on ``pod16x16`` reckoned as ``(16, 16)``
  ranks, their argument bytes their placements' slices; the recurrent
  archs on ``(16, 16)`` and the MoE archs on ``(16, 1)``.
"""

import json

import numpy as np
import pytest
import torch

import torch_jax_tooling as tooling
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.models import zoo
from repro_torch.roofline import op_cost
from repro_torch.train import train_step as ts

CELLS = {name: ShapeConfig(name, s, b, kind)
         for name, s, b, kind in tooling.FLOP_CELLS}
MESHES = {"1x1": (1, 1), "2x2": (2, 2)}


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return tooling.run("hlo_flops", tmp_path_factory.mktemp("jax_flops"))


@pytest.fixture(scope="module")
def cfg():
    return reduced(get_config("yi-6b"))


def sliced_bytes(tree, specs, mesh) -> int:
    place = shd.Placement(mesh, specs)
    return sum(t.numel() * t.element_size() for t in
               _leaves(place.map(place.leaf_local, tree)))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        for v in tree:
            yield from _leaves(v)


def model_sums(cfg, rows: int, seq: int) -> tuple[int, int]:
    """The f32 bytes and calls of one rank's all-reduces over ``model`` in
    a tensor-parallel train step of ``cfg`` (heads, ``ff`` and vocab all
    split, no partial leaves, one microbatch, remat on) at ``rows x seq``
    tokens ``t``: the embedding's lookup (``t x d``); per layer the
    attention's and the MLP's row-parallel outputs, the gradients of
    their inputs (``copy_to_model``), and the attention's output again in
    the recomputed forward (the checkpoint stops recomputing after the
    MLP's last product, before its sum); per loss chunk the head input's
    gradient and the row maxima, ``sum exp`` and gold logits of its
    ``rows x chunk`` tokens, in the forward and in its recompute; the
    norm's one scalar."""
    t, n_chunks = rows * seq, seq // min(tf.LOSS_CHUNK, seq)
    floats = t * cfg.d_model * (2 + 5 * cfg.num_layers) + 6 * t + 1
    return 4 * floats, 2 + 5 * cfg.num_layers + 7 * n_chunks


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_record_and_argument_bytes(cfg, cell, mesh_name, tmp_path):
    shape, mesh = CELLS[cell], ShapeMesh(MESHES[mesh_name],
                                         ("data", "model"))
    rec = dr.run_cell("yi-6b", cell, mesh=mesh, shape=shape, cfg=cfg,
                      out_dir=str(tmp_path))
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == mesh_name and rec["n_chips"] == mesh.size
    train = shape.kind == "train"
    tp = train and mesh.shape["model"] > 1
    assert rec["split"] == ("tensor-parallel rank" if tp
                            else "ideal over model")
    for key in ("flops_per_chip", "bytes_per_chip", "bytes_raw_per_chip",
                "collectives", "collective_bytes_per_chip", "memory",
                "roofline", "model_flops_global", "useful_flops_ratio"):
        assert key in rec
    assert (tmp_path / f"{mesh_name}__yi-6b__{cell}.json").exists()
    # argument bytes a rank, against the leaves cut at rank 0 (a train
    # cell's on the mesh the port trains it on: yi-6b tensor-parallel)
    fsdp = True if train else "residual"
    if train:
        assert rec["train_mesh"] == mesh_name
    with shd.use_mesh(mesh, fsdp=fsdp):
        aparams, pspecs, aopt, ospecs = ts.state_shardings(
            cfg, mesh, fsdp=fsdp, with_opt=train)
        bspecs = ts.batch_pspecs(cfg, shape, mesh)
    want = sliced_bytes(aparams, pspecs, mesh) + sliced_bytes(
        dr.input_specs(cfg, shape), bspecs, mesh)
    if train:
        want += sliced_bytes(aopt.m, ospecs.m, mesh) + sliced_bytes(
            aopt.v, ospecs.v, mesh)
    mem = rec["memory"]
    assert mem["argument_bytes"] == want
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["temp_bytes"] > 0
    if mesh.shape["data"] > 1:
        assert rec["rows_per_chip"] == shape.global_batch // 2
    # the f32 gradient sum over data of a rank's model slices (one call)
    # and the sums over model, counted by hand
    coll = rec["collectives"]
    if train and mesh.size > 1:
        model_only = ShapeMesh((1, mesh.shape["model"]), ("data", "model"))
        n_local = sliced_bytes(aparams, pspecs, model_only) // 4
        nbytes, calls = model_sums(cfg, rec["rows_per_chip"], shape.seq_len)
        assert coll["all-reduce"] == 4 * n_local + nbytes
        assert coll["count"] == 1 + calls
    elif mesh.size == 1:
        assert rec["collective_bytes_per_chip"] == 0


def test_mesh_train_peak_holds_the_gather_and_the_f32_sum(cfg,
                                                          monkeypatch):
    """On a ``2x1`` mesh the reckoning runs the port's mesh train step on
    rank 0's slices: its peak holds them, the parameters gathered whole
    and the full gradients, and the sum's f32 copies come on top of the
    one-device step's peak at the same rows.  (The FSDP threshold is cut
    so that the reduced config's leaves are sliced at all.)"""
    monkeypatch.setattr(shd, "FSDP_THRESHOLD", 1024)
    shape = CELLS["train"]
    r = dr.reckon(cfg, shape, ShapeMesh((2, 1), ("data", "model")))
    half = ShapeConfig("t", shape.seq_len, shape.global_batch // 2, "train")
    one = dr.reckon(cfg, half, ShapeMesh((1, 1), ("data", "model")))
    assert r["rows"] == one["rows"] and r["train_mesh"] == "2x1"
    with shd.use_mesh(ShapeMesh((2, 1), ("data", "model"))):
        aparams, pspecs, _, _ = ts.state_shardings(cfg, ShapeMesh(
            (2, 1), ("data", "model")), fsdp=True, with_opt=False)
    sliced = [t for t, _ in dr._sliced_leaves(aparams, pspecs, ShapeMesh(
        (2, 1), ("data", "model")))]
    assert sliced and r["collectives"]["count"] == len(sliced) + 1
    n_par = sum(t.numel() for t in _leaves(aparams))
    full = sum(t.numel() * t.element_size() for t in sliced)
    assert r["argument_bytes"] < one["argument_bytes"]
    assert r["peak_bytes"] >= r["argument_bytes"] + full + 4 * n_par
    assert r["temp_bytes"] > one["temp_bytes"]


def port_flops(cfg, cell):
    mesh = ShapeMesh((1, 1), ("data", "model"))
    return dr.reckon(cfg, CELLS[cell], mesh)["cost"]["flops"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_flops_against_reference_hlo(jx, cfg, cell):
    got, want = port_flops(cfg, cell), jx[cell]["flops"]
    assert want > 0
    assert abs(got - want) <= 0.25 * want, (got, want)


def test_decode_flops_equal_reference(jx, cfg):
    assert port_flops(cfg, "decode") == jx["decode"]["flops"]


def test_prefill_gap_is_the_causal_skip(jx, cfg):
    """The flash forward counts the causal pairs; the reference's XLA
    attention multiplies all S x S: adding the difference back gives the
    reference's count exactly."""
    s, b = CELLS["prefill"].seq_len, CELLS["prefill"].global_batch
    h, d = cfg.num_heads, cfg.resolved_head_dim
    skipped = (2 * 2 * d * b * h * (s * s - op_cost.flash_pairs(s, True, 0))
               * cfg.num_layers)
    assert port_flops(cfg, "prefill") + skipped == jx["prefill"]["flops"]


def test_train_flops_within_5pct_of_reference(jx, cfg):
    """The default step saves the products the reference's dots policy
    saves (+19.2% when every group layer recomputed all of them)."""
    got, want = port_flops(cfg, "train"), jx["train"]["flops"]
    assert abs(got - want) <= 0.05 * want, (got, want)


def test_train_gap_is_the_loss_recompute_and_the_causal_pairs(jx, cfg):
    """Term by term, the train cell's gap under ``"dots"``: the port's
    loss chunk computes its logits again in the backward pass, where the
    compiled reference computes them once (XLA merges the checkpoint's
    recompute with the forward: ``prevent_cse=False``); and each layer's
    attention, recomputed in both, runs the flash kernels' 2 + 2 + 3 + 4
    products (forward, its recompute, dQ, dK/dV) over the causal pairs
    where the reference's XLA attention runs 2 + 2 + 4 over all S x S."""
    s, b = CELLS["train"].seq_len, CELLS["train"].global_batch
    h, d = cfg.num_heads, cfg.resolved_head_dim
    unit = 2 * d * b * h * cfg.num_layers
    logits = 2 * b * s * cfg.d_model * cfg.vocab_size
    port_attn = (2 + 2 + 3 + 4) * unit * op_cost.flash_pairs(s, True, 0)
    ref_attn = (2 + 2 + 4) * unit * s * s
    assert port_flops(cfg, "train") == (jx["train"]["flops"] + logits
                                        + port_attn - ref_attn)


@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-4b", "recurrentgemma-9b",
                                  "rwkv6-7b", "deepseek-moe-16b",
                                  "internvl2-1b", "whisper-tiny"])
def test_dots_reckons_between_none_and_full(arch):
    """``"dots"`` recomputes only what has batch dims or none at all (the
    attention, the elementwise work), ``"full"`` every product too."""
    c = reduced(get_config(arch))
    mesh = ShapeMesh((1, 1), ("data", "model"))
    flops = {r: dr.reckon(c, CELLS["train"], mesh, remat=r)["cost"]["flops"]
             for r in ("none", "dots", "full")}
    assert flops["none"] < flops["dots"] < flops["full"], flops


def test_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.size == 512
    assert dr._mesh_name(single) == "pod16x16"
    assert dr._mesh_name(multi) == "pod2x16x16"


def test_full_size_train_cell_on_meta(tmp_path):
    """yi-6b ``train_4k`` on ``pod16x16`` at full size: one rank's 16 rows
    on meta in seconds, trained as the port trains it, tensor-parallel on
    ``16x16``: its arguments 1/256 of the state (FSDP over data, heads,
    ff and vocab over model) but for wk and wv, whose 4 KV heads stay
    whole over model, and the norms."""
    rec = dr.run_cell("yi-6b", "train_4k", out_dir=str(tmp_path))
    assert rec["ok"], rec.get("traceback")
    assert rec["rows_per_chip"] == 16
    cfg = get_config("yi-6b")
    state = cfg.param_count() * (2 + 8)          # bf16 params, f32 moments
    mem = rec["memory"]
    assert rec["train_mesh"] == "pod16x16"
    assert rec["split"] == "tensor-parallel rank"
    # wk and wv (4 KV heads) stay whole over model, the norms whole; the
    # batch's tokens and labels
    kv = cfg.num_layers * 2 * cfg.d_model * cfg.num_kv_heads * 128 * 10
    norms = (2 * cfg.num_layers + 1) * cfg.d_model * 10
    batch = 2 * 16 * 4096 * 4
    assert mem["argument_bytes"] == pytest.approx(
        (state - kv - norms) / 256 + kv / 16 + norms + batch, rel=1e-4)
    assert mem["temp_bytes"] > cfg.param_count() * (2 + 4) / 16
    assert 0.5 < rec["useful_flops_ratio"] <= 1.0
    assert rec["collectives"]["all-reduce"] > 0
    again = json.loads((tmp_path / "pod16x16__yi-6b__train_4k.json")
                       .read_text())
    assert again == rec


@pytest.mark.parametrize("arch", ["yi-6b", "starcoder2-15b", "gemma3-4b",
                                  "internvl2-1b"])
def test_tp_train_cells_on_pod16x16(arch, tmp_path):
    """``train_4k`` on ``pod16x16`` at full size as ``(16, 16)`` ranks:
    the replicated KV heads (yi-6b's 4, starcoder2-15b's 4), the
    replicated attention (gemma3-4b's 8 heads, internvl2-1b's 14) and
    the replicated vocab (internvl2-1b's 151655) at M = 16; each rank's
    argument bytes equal its placement's slices."""
    rec = dr.run_cell(arch, "train_4k", out_dir=str(tmp_path))
    assert rec["ok"], rec.get("traceback")
    assert rec["train_mesh"] == "pod16x16"
    cfg = get_config(arch)
    mesh = make_production_mesh()
    shape = dr.SHAPES["train_4k"]
    with shd.use_mesh(mesh, fsdp=True):
        aparams, pspecs, aopt, ospecs = ts.state_shardings(
            cfg, mesh, fsdp=True, with_opt=True)
        bspecs = ts.batch_pspecs(cfg, shape, mesh)
    want = (sliced_bytes(aparams, pspecs, mesh)
            + sliced_bytes(dr.input_specs(cfg, shape), bspecs, mesh)
            + sliced_bytes(aopt.m, ospecs.m, mesh)
            + sliced_bytes(aopt.v, ospecs.v, mesh))
    assert rec["memory"]["argument_bytes"] == want
    split = shd.model_split(zoo.init_axes(cfg), pspecs, mesh)
    assert split["heads"] == (cfg.num_heads % 16 == 0)
    assert split["vocab"] == (cfg.vocab_size % 16 == 0)
    assert not split["kv_heads"]


def test_recurrent_and_moe_train_cells_stay_data_parallel():
    """The recurrent archs, trained tensor-parallel since ROADMAP item
    11f, and the MoE archs, since item 11g, take the ``(16, 16)`` train
    mesh, as every arch does."""
    mesh = make_production_mesh()
    for arch, model in (("recurrentgemma-9b", 16), ("rwkv6-7b", 16),
                        ("deepseek-moe-16b", 16),
                        ("llama4-maverick-400b-a17b", 16)):
        got = dr.train_mesh(get_config(arch), dr.SHAPES["train_4k"], mesh)
        assert got.shape == {"data": 16, "model": model}, arch
    got = dr.train_mesh(get_config("whisper-tiny"), dr.SHAPES["train_4k"],
                        mesh)
    assert got.shape == {"data": 16, "model": 16}


def test_data_dependent_cell_is_recorded_with_its_op(cfg, tmp_path,
                                                    monkeypatch):
    def reads_back(*a, **k):
        return torch.empty(3, device="meta").sum().item()
    monkeypatch.setattr(ts, "make_serve_step", lambda cfg: reads_back)
    rec = dr.run_cell("yi-6b", "decode", mesh=ShapeMesh((1, 1), (
        "data", "model")), shape=CELLS["decode"], cfg=cfg,
        out_dir=str(tmp_path))
    assert rec["ok"] is False
    assert rec["op"] == "aten._local_scalar_dense"
    assert "DataDependentOp" in rec["error"] and rec["traceback"]


def test_n_micro_keeps_arguments_and_flops(cfg):
    mesh = ShapeMesh((1, 1), ("data", "model"))
    shape = ShapeConfig("t", 64, 8, "train")
    one = dr.reckon(cfg, shape, mesh)
    four = dr.reckon(cfg, shape, mesh, n_micro=4)
    assert one["argument_bytes"] == four["argument_bytes"]
    assert np.isclose(one["cost"]["flops"], four["cost"]["flops"],
                      rtol=1e-9)


@pytest.mark.parametrize("mesh,groups", [((1, 1), 0), ((2, 1), 1),
                                         ((1, 2), 1), ((2, 2), 2)])
def test_train_reckoning_holds_the_ipc_arenas(cfg, mesh, groups,
                                              monkeypatch):
    """A train cell's rank on a card it shares with its peers holds two
    CUDA IPC slots for each group its step's collectives use (``data``
    and ``model``, where each has more than one rank), for its life: they
    are part of its temporaries.  Ranks on cards of their own hold
    none."""
    from repro_torch.distributed import ipc
    shape, m = CELLS["train"], ShapeMesh(mesh, ("data", "model"))
    r = dr.reckon(cfg, shape, m, one_card=True)
    assert r["arena_bytes"] == groups * 2 * ipc.SLOT_BYTES
    assert r["peak_bytes"] == r["argument_bytes"] + r["temp_bytes"]
    apart = dr.reckon(cfg, shape, m)
    assert apart["arena_bytes"] == 0
    assert r["temp_bytes"] - apart["temp_bytes"] == r["arena_bytes"]
    monkeypatch.setattr(ipc, "SLOT_BYTES", 0)
    assert dr.reckon(cfg, shape, m, one_card=True)["temp_bytes"] == \
        apart["temp_bytes"]


@pytest.mark.parametrize("mesh", [(1, 1), (2, 2)])
def test_cell_record_holds_no_arena_across_cards(cfg, mesh, tmp_path):
    """A cell's record (a production deployment, its ranks on cards of
    their own) holds no IPC arena, its heads gathered over ``model`` or
    not."""
    rec = dr.run_cell("yi-6b", "decode", mesh=ShapeMesh(
        mesh, ("data", "model")), shape=CELLS["decode"], cfg=cfg,
        out_dir=str(tmp_path))
    assert rec["ok"], rec.get("traceback")
    assert rec["memory"]["arena_bytes"] == 0
    assert (rec["collectives"]["all-gather"] > 0) == (mesh != (1, 1))
