"""Multi-pod dry-run of the port: every (arch x shape x mesh) cell reckoned
on the ``meta`` device.  The port of ``src/repro/launch/dryrun.py``.

The reference lowers and compiles each cell's step under 512 fake XLA
devices and reads the compiled program.  The port has no compiler to ask:
per cell it

  * derives the reference's specs (``train_step.state_shardings`` and
    ``batch_pspecs`` under ``use_mesh(mesh, fsdp=True)`` for training,
    ``fsdp="residual"`` for serving) on a shape-only mesh
    (:func:`~repro_torch.launch.mesh.make_production_mesh`), and from them
    the bytes of one rank's arguments, exactly.  A train cell takes the
    specs of the mesh the port trains it on, :func:`train_mesh` (the
    record's ``train_mesh``): ``(D, M)``, the cell's data ranks by its
    ``model`` ranks, for every arch;
  * runs the step itself on ``meta`` tensors at one rank's rows under
    :class:`~repro_torch.roofline.op_cost.OpCost`: the port's train step
    with AdamW's update (``make_train_step`` on one rank,
    ``make_mesh_train_step`` on rank 0's slices of the train mesh, its
    gather, gradient sums and sums over ``model`` carrying nothing on
    ``meta``), the one-shot prefill, or one decode step on dense caches.
    The kernels charge their own counts there
    (:mod:`repro_torch.kernels`).  That gives the step's FLOPs and
    bytes: a tensor-parallel rank's own
    (the record says ``"split": "tensor-parallel rank"``), else divided
    over ``model`` as an ideal split (``"ideal over model"``); and its
    temporaries: the peak of live bytes less the arguments, and, where
    the ranks share one card (``one_card``), the CUDA IPC arenas
    (:mod:`repro_torch.distributed.ipc`, two slots each) of the groups a
    train step's collectives use, which a rank holds for its life
    (``arena_bytes``: the ``data`` and ``model`` groups where each has
    more than one rank; a production mesh spans cards and holds none,
    and serving cells, whose collectives are not reckoned, count none
    either).  A training
    rank's peak is what that rank of the port holds: the parameters
    gathered over ``data`` (its ``model`` slices), the f32 gradient sum
    and the update on its slice.  A serving cell's temporaries are the
    one-device step's at the rank's rows, not cut to the rank's heads;
  * reckons the collectives from the specs, as the port's mesh steps run
    them: FSDP's all-gather of each sliced leaf over ``data`` (its
    ``model`` slice), the f32 gradient sum over the data axes, the
    tensor-parallel step's all-reduces and all-gathers over ``model`` (as
    its ``ModelParallel`` counts them on ``meta``; the record keeps them
    apart too, ``collectives_over_model``), and on serving cells
    the head-parallel all-gather
    of each attention layer's output over ``model``;
  * and from those the roofline terms at the H100's
    :data:`~repro_torch.roofline.analysis.HW`, ``model_flops`` and the
    useful-FLOPs ratio.

A cell whose step cannot run on ``meta`` (an op that needs the data, a
kernel without a meta branch) is recorded ``ok: false`` with its error,
traceback and, where known, the op; nothing works around it.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all        # every cell, both meshes

Records go to ``experiments/dryrun_torch/<mesh>__<arch>__<shape>.json``
(git-ignored) and are reused unless ``--force``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import ipc
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh
from repro_torch.models import zoo
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as roof
from repro_torch.roofline import op_cost
from repro_torch.train import train_step as ts

__all__ = ["OUT_DIR", "input_specs", "local_bytes", "rows_per_rank",
           "train_mesh", "reckon", "run_cell", "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
ATTENTION_KINDS = ("full", "swa", "local", "global")


def input_specs(cfg, shape: ShapeConfig) -> dict:
    """Every model input of this cell as ``meta`` tensors, as the
    reference's ``zoo.input_specs``: tokens and labels int32, a decode
    cell's token, position and dense caches, the frontends' f32 patches
    and frames."""
    b, s = shape.global_batch, shape.seq_len
    st = zoo.token_seq_len(cfg, s)
    meta = torch.device("meta")
    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = torch.empty((b, st), dtype=torch.int32, device=meta)
        if shape.kind == "train":
            specs["labels"] = torch.empty((b, st), dtype=torch.int32,
                                          device=meta)
    else:
        specs["token"] = torch.empty((b,), dtype=torch.int32, device=meta)
        specs["pos"] = torch.empty((b,), dtype=torch.int32, device=meta)
        specs["caches"] = zoo.init_cache(cfg, b, s, meta)
    if cfg.frontend == "vision" and shape.kind != "decode":
        specs["patches"] = torch.empty((b, cfg.num_patches, cfg.frontend_dim),
                                       dtype=torch.float32, device=meta)
    if cfg.encoder_decoder and shape.kind != "decode":
        specs["frames"] = torch.empty((b, cfg.enc_seq, cfg.d_model),
                                      dtype=torch.float32, device=meta)
    return specs


def _axes_size(entry, mesh) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return math.prod(mesh.shape[n] for n in names)


def local_bytes(t: torch.Tensor, spec, mesh) -> int:
    """Bytes of one rank's slice of ``t`` under ``spec`` (a tuple with an
    axis name, a tuple of them or None a dim; ``()`` replicated)."""
    n = 1
    for i, size in enumerate(t.shape):
        parts = _axes_size(spec[i], mesh) if i < len(spec) else 1
        n *= -(-size // parts)
    return n * t.element_size()


def _tree_local_bytes(tree, specs, mesh) -> int:
    if isinstance(tree, torch.Tensor):
        return local_bytes(tree, specs, mesh)
    if isinstance(tree, dict):
        return sum(_tree_local_bytes(tree[k], specs[k], mesh) for k in tree)
    return sum(_tree_local_bytes(t, s, mesh) for t, s in zip(tree, specs))


def _sliced_leaves(tree, specs, mesh, axes=("pod", "data")):
    """(leaf, spec) pairs whose spec splits a dim over one of ``axes``
    (of more than one rank on ``mesh``)."""
    return [(t, s) for t, s in _leaves_specs(tree, specs)
            if any(_axes_size(e, mesh) > 1 and set(
                (e,) if isinstance(e, str) else e) & set(axes)
                for e in s if e is not None)]


def _leaves_specs(tree, specs):
    """(leaf, spec) pairs of a tree and its spec tree."""
    if isinstance(tree, torch.Tensor):
        return [(tree, specs)]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves_specs(tree[k], specs[k])]
    return [x for t, s in zip(tree, specs) for x in _leaves_specs(t, s)]


def _rows(shape: ShapeConfig, bspecs: dict, mesh) -> int:
    key = "tokens" if shape.kind != "decode" else "token"
    return shape.global_batch // _axes_size(bspecs[key][0], mesh)


def rows_per_rank(cfg, shape: ShapeConfig, mesh) -> int:
    """The batch rows one rank's step takes: the global batch over the
    data axes that divide it (``batch_pspecs``)."""
    with shd.use_mesh(mesh):
        return _rows(shape, ts.batch_pspecs(cfg, shape, mesh), mesh)


def _head_gather_bytes(cfg, mesh, tokens: int) -> int:
    """The port's head-parallel serving: each attention layer's output
    ``[tokens, H, D]`` all-gathered over ``model`` when ``model`` divides
    both head counts."""
    m = mesh.shape.get("model", 1)
    if m == 1 or cfg.num_heads % m or cfg.num_kv_heads % m:
        return 0
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)]
             for i in range(cfg.num_layers)]
    n_attn = sum(k in ATTENTION_KINDS for k in kinds)
    esz = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    return n_attn * tokens * cfg.num_heads * cfg.resolved_head_dim * esz


def train_mesh(cfg, shape: ShapeConfig, mesh) -> ShapeMesh:
    """The mesh the port trains a train cell on: ``(D, M)``, ``D`` the
    ranks the cell's batch rows are split over (pod x data) and ``M`` the
    mesh's ``model`` ranks, each holding its tensor-parallel slices."""
    with shd.use_mesh(mesh):
        d = _axes_size(ts.batch_pspecs(cfg, shape, mesh)["tokens"][0], mesh)
    return ShapeMesh((d, mesh.shape.get("model", 1)), ("data", "model"))


def reckon(cfg, shape: ShapeConfig, mesh, *, n_micro: int = 1,
           remat: str = "dots", one_card: bool = False) -> dict:
    """One cell's reckoning (see the module docstring): counts, memory,
    collectives; a train cell's step under the ``remat`` policy, its
    groups' IPC arenas counted when ``one_card`` (the ranks share one
    card).  Raises what the step raises on ``meta``."""
    is_train = shape.kind == "train"
    m = mesh.shape.get("model", 1)
    if is_train:
        mesh = train_mesh(cfg, shape, mesh)
        if mesh.shape["model"] > 1:
            m = 1       # the step runs on the rank's own slices
    fsdp = True if is_train else "residual"
    with shd.use_mesh(mesh, fsdp=fsdp):
        aparams, pspecs, aopt, ospecs = ts.state_shardings(
            cfg, mesh, fsdp=fsdp, with_opt=is_train)
        bspecs = ts.batch_pspecs(cfg, shape, mesh)
    rows = _rows(shape, bspecs, mesh)
    local = ShapeConfig(shape.name, shape.seq_len, rows, shape.kind)
    batch = input_specs(cfg, local)
    glob = input_specs(cfg, shape) if rows != shape.global_batch else batch
    arg_bytes = (_tree_local_bytes(aparams, pspecs, mesh)
                 + _tree_local_bytes(glob, bspecs, mesh))
    if is_train:
        arg_bytes += _tree_local_bytes(aopt.m, ospecs.m, mesh) \
            + _tree_local_bytes(aopt.v, ospecs.v, mesh)
        if mesh.size == 1:
            step = ts.make_train_step(cfg, adamw.AdamWConfig(),
                                      n_micro=n_micro, remat=remat)
            args = (aparams, aopt, batch)
        else:
            step = ts.make_mesh_train_step(cfg, adamw.AdamWConfig(), mesh,
                                           n_micro=n_micro, remat=remat)
            state = step.placement.local({"params": aparams, "opt": aopt})
            args = (state["params"], state["opt"], batch)
    elif shape.kind == "prefill":
        step = ts.make_prefill_step(cfg, cache_len=shape.seq_len)
        args = (aparams, batch)
    else:
        step = ts.make_serve_step(cfg)
        args = (aparams, batch["caches"], batch["token"], batch["pos"])
    cost, counter = op_cost.analyze(step, *args)
    temp = cost["peak_live_bytes"] - cost["argument_bytes"]
    coll = dict.fromkeys(op_cost.COLLECTIVES, 0.0)
    coll["count"] = 0
    sliced = _sliced_leaves(aparams, pspecs, mesh)
    # a leaf's slice over model alone: what the gathers and the data sum
    # of a tensor-parallel rank carry
    model_only = ShapeMesh((1, mesh.shape.get("model", 1)),
                           ("data", "model")) if is_train else None
    if sliced:
        coll["all-gather"] += sum(
            local_bytes(t, s, model_only) if is_train
            else t.numel() * t.element_size() for t, s in sliced)
        coll["count"] += len(sliced)
    data = _axes_size(bspecs["tokens" if shape.kind != "decode"
                             else "token"][0], mesh)
    if is_train and data > 1:
        coll["all-reduce"] += 4.0 * sum(
            local_bytes(t, s, model_only) // t.element_size()
            for t, s in _leaves_specs(aparams, pspecs))
        coll["count"] += 1
    tp = getattr(step, "tp", None)
    over_model = {}
    if tp is not None and tp.size > 1:  # the collectives over model
        for kind, (calls, nbytes) in tp.counts.items():
            coll[kind] += nbytes
            coll["count"] += calls
            over_model[kind] = {"count": calls, "bytes": nbytes}
    if not is_train:
        tokens = rows * (shape.seq_len if shape.kind == "prefill" else 1)
        g = _head_gather_bytes(cfg, mesh, tokens)
        if g:
            coll["all-gather"] += g
            coll["count"] += 1
    groups = (data > 1) + (mesh.shape["model"] > 1) if is_train else 0
    arena = groups * 2 * ipc.SLOT_BYTES if one_card else 0
    temp += arena
    return {"cost": cost, "counter": counter, "rows": rows, "model": m,
            "split": ("tensor-parallel rank" if is_train
                      and mesh.shape["model"] > 1 else "ideal over model"),
            "train_mesh": _mesh_name(mesh) if is_train else None,
            "argument_bytes": int(arg_bytes), "temp_bytes": int(temp),
            "arena_bytes": arena,
            "peak_bytes": int(arg_bytes + temp), "collectives": coll,
            "collectives_over_model": over_model,
            "collective_bytes": sum(coll[k] for k in op_cost.COLLECTIVES)}


def _mesh_name(mesh) -> str:
    """``pod16x16`` / ``pod2x16x16`` for the production meshes, else the
    sizes (``1x1``, ``2x2``)."""
    for multi, name in ((False, "pod16x16"), (True, "pod2x16x16")):
        if dict(mesh.shape) == make_production_mesh(multi_pod=multi).shape:
            return name
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: str = OUT_DIR, force: bool = False, mesh=None,
             shape: ShapeConfig | None = None, cfg=None) -> dict:
    """Reckon one cell and write its record (reused unless ``force``).
    ``mesh``/``shape``/``cfg`` override the production ones (small
    stand-in meshes in tests)."""
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    mesh_name = _mesh_name(mesh)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir,
                            f"{mesh_name}__{arch_id}__{shape_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as fh:
            return json.load(fh)
    cfg = cfg or get_config(arch_id)
    shape = shape or SHAPES[shape_name]
    n_chips = mesh.size
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "ok": False, "device": "meta"}
    t0 = time.time()
    try:
        r = reckon(cfg, shape, mesh)
        cost, m = r["cost"], r["model"]
        flops, nbytes = cost["flops"] / m, cost["bytes"] / m
        terms = roof.roofline_terms(
            {"flops": flops, "bytes accessed": nbytes},
            r["collective_bytes"])
        mf = roof.model_flops(cfg, shape)
        flops_global = flops * n_chips
        rec.update(
            ok=True,
            n_chips=n_chips,
            rows_per_chip=r["rows"],
            split=r["split"],
            train_mesh=r["train_mesh"],
            flops_per_chip=flops,
            bytes_per_chip=nbytes,
            bytes_raw_per_chip=cost["bytes_raw"] / m,
            collectives=r["collectives"],
            collectives_over_model=r["collectives_over_model"],
            collective_bytes_per_chip=r["collective_bytes"],
            memory={"argument_bytes": r["argument_bytes"],
                    "temp_bytes": r["temp_bytes"],
                    "arena_bytes": r["arena_bytes"],
                    "peak_bytes": r["peak_bytes"],
                    "step_peak_live_bytes": cost["peak_live_bytes"]},
            roofline=terms,
            model_flops_global=mf,
            useful_flops_ratio=(mf / flops_global if flops_global else None),
            top_ops=r["counter"].attribute(top=8),
        )
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["op"] = getattr(e, "op", None)
        rec["traceback"] = traceback.format_exc(limit=8)
    rec["total_s"] = round(time.time() - t0, 2)
    with open(out_path, "w") as fh:
        json.dump(rec, fh, indent=1)
    status = "OK " if rec["ok"] else "FAIL"
    print(f"[{status}] {mesh_name} {arch_id} {shape_name} "
          f"({rec['total_s']}s)"
          + ("" if rec["ok"] else f" :: {rec.get('error')}"), flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    targets = []
    arch_list = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    for aid in arch_list:
        for shape_name, _ in cells(aid):
            if args.shape and shape_name != args.shape:
                continue
            for mp in meshes:
                targets.append((aid, shape_name, mp))

    n_ok = 0
    for aid, shape_name, mp in targets:
        rec = run_cell(aid, shape_name, multi_pod=mp,
                       out_dir=args.out_dir, force=args.force)
        n_ok += bool(rec["ok"])
    print(f"\n{n_ok}/{len(targets)} cells reckoned")
    if n_ok < len(targets):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
