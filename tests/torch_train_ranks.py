"""What each rank of the mesh-training tests runs (``launch.mesh
.MeshPool``).

Spawned ranks import this module by name; it imports the port and numpy
only, never JAX.  Inputs arrive and results leave as numpy arrays and
plain values.  A function for a mesh smaller than the pool runs on its
first ranks; the others return None.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_config, reduced
from repro_torch.core import ControllerModel, GoalSpec
from repro_torch.core import tensor_controller as tc
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import make_host_mesh, world
from repro_torch.models import zoo
from repro_torch.models.bridge import keyed_leaves, params_from_numpy
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig


def config(arch: str, overrides: dict):
    return reduced(get_config(arch), **overrides)


def _mesh(data: int, model: int = 1):
    """This rank's mesh, or None on a rank past ``data * model``."""
    if world()[1] >= data * model:
        try:
            make_host_mesh(data=data, model=model)   # builds the groups
        except ValueError:
            return None
    return make_host_mesh(data=data, model=model)


def keyed_numpy(tree) -> dict:
    return {k: v.detach().float().numpy() if v.dtype == torch.bfloat16
            else v.detach().numpy() for k, v in keyed_leaves(tree)}


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def _batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def one_process(arch, overrides, weights, batch, n_micro, opt):
    """Rank 0 alone: ``make_train_step`` at ``n_micro`` on the whole batch
    (with the ranks' thread count): the full state after one step and
    the metrics."""
    if world()[1] != 0:
        return None
    cfg = config(arch, overrides)
    params = params_from_numpy(weights, "cpu")
    state = adamw.init(params)
    params, state, m = ts.make_train_step(
        cfg, adamw.AdamWConfig(**opt), n_micro=n_micro)(params, state,
                                                         _batch(batch))
    return keyed_numpy({"params": params, "opt": state}), _metrics(m)


def dp_step(arch, overrides, weights, batch, data, fsdp, opt, n_micro=1,
            ckpt_dir=None):
    """One ``make_mesh_train_step`` step on a ``data x 1`` mesh, this rank
    holding its slices and rows: rank 0 returns the gathered full state
    (and with ``ckpt_dir`` writes it there as step 1), every rank its
    metrics and the shapes of the leaves it holds."""
    mesh = _mesh(data)
    if mesh is None:
        return None
    cfg = config(arch, overrides)
    step = ts.make_mesh_train_step(cfg, adamw.AdamWConfig(**opt), mesh,
                                   fsdp=fsdp, n_micro=n_micro)
    pl = step.placement
    params = pl.local({"params": params_from_numpy(weights, "cpu")})["params"]
    state = adamw.init(params)
    params, state, m = step(params, state, ts.local_rows(_batch(batch),
                                                         mesh))
    mine = {"params": params, "opt": state}
    shapes = {k: tuple(v.shape) for k, v in keyed_leaves(mine)}
    full = pl.gather(mine)
    if ckpt_dir is not None and mesh.rank == 0:
        save(ckpt_dir, 1, full)
    return (keyed_numpy(full) if mesh.rank == 0 else None, _metrics(m),
            shapes)


def restore_on(ckpt_dir, arch, overrides, data, fsdp):
    """The elastic restore of ``ckpt_dir``'s latest step on a ``data x 1``
    mesh: every rank's slices, gathered; rank 0 returns the full tree,
    every rank the shapes of its slices."""
    mesh = _mesh(data)
    if mesh is None:
        return None
    cfg = config(arch, overrides)
    pl = ts.state_placement(cfg, mesh, fsdp=fsdp)
    params = zoo.init(cfg, torch.Generator().manual_seed(1), "cpu")
    like = pl.local({"params": params, "opt": adamw.init(params)})
    tree, _, step = restore(ckpt_dir, None, like, placement=pl)
    shapes = {k: tuple(v.shape) for k, v in keyed_leaves(tree)}
    full = pl.gather(tree)
    return (keyed_numpy(full) if mesh.rank == 0 else None), shapes, step


def compressed(grads, data):
    """``compressed_psum_grads`` of rank r's tree (row r of every leaf)
    over ``data``, and the exact f32 mean."""
    mesh = _mesh(data)
    if mesh is None:
        return None
    mine = {k: torch.from_numpy(v[mesh.data_index]) for k, v in grads.items()}
    got = collectives.compressed_psum_grads(mine, mesh, "data")
    exact = {k: collectives.all_reduce(v, mesh, "data") / data
             for k, v in mine.items()}
    return ({k: v.numpy() for k, v in got.items()},
            {k: v.numpy() for k, v in exact.items()})


def trainer_steps(workdir, arch, overrides, data, steps, fsdp):
    """A ``Trainer(mesh=)`` run one step at a time, SmartConf live: after
    each step the checkpoint interval, the last saved step, the number of
    writes and the loss; and the rows a rank draws a step."""
    mesh = _mesh(data)
    if mesh is None:
        return None
    cfg = config(arch, overrides)
    tr = Trainer(cfg, adamw.AdamWConfig(warmup_steps=1), TrainerConfig(
        workdir=workdir, total_steps=steps, ckpt_interval=2, batch_size=4,
        seq_len=16), device="cpu", mesh=mesh, fsdp=fsdp)
    trail = []
    for _ in range(steps):
        tr.run(1)
        trail.append((tr.step, tr.ckpt.interval_steps, tr.ckpt.last_saved,
                      tr.ckpt.writes, tr.metrics_log[-1]["loss"]))
    rows = tr.source.local_batch
    tr.close()
    return trail, rows


def trainer_resume(workdir, arch, overrides, data, fsdp):
    """A fresh ``Trainer(mesh=)`` over ``workdir``: the step it resumed at
    and its state gathered (rank 0)."""
    mesh = _mesh(data)
    if mesh is None:
        return None
    cfg = config(arch, overrides)
    tr = Trainer(cfg, adamw.AdamWConfig(warmup_steps=1), TrainerConfig(
        workdir=workdir, batch_size=4, seq_len=16, enable_smartconf=False),
        device="cpu", mesh=mesh, fsdp=fsdp)
    full = tr.placement.gather({"params": tr.params, "opt": tr.opt_state})
    step = tr.step
    tr.close()
    return step, (keyed_numpy(full) if mesh.rank == 0 else None)


def sharded_controllers(cases, initial, measurements, data, model, axis):
    """``sharded_coordinated_step`` over ``axis`` of a ``data x model``
    mesh, each rank holding its contiguous slice of the controllers."""
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    n = mesh.axis_size(axis)
    i = mesh.data_index if axis == "data" else mesh.model_index
    per = len(cases) // n
    mine = slice(i * per, (i + 1) * per)
    specs = tc.stack_specs([
        tc.make_spec(ControllerModel(**c["model"]), GoalSpec(**c["goal"]),
                     metric_id=c["metric_id"], device="cpu")
        for c in cases[mine]])
    states = tc.init_state(torch.tensor(initial[mine], dtype=torch.float32))
    step = tc.sharded_coordinated_step(mesh, axis)
    _, confs = step(specs, states, torch.tensor(measurements[mine],
                                                dtype=torch.float32))
    return i, confs.numpy()
