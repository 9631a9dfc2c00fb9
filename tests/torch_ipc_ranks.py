"""What the ranks of ``tests/test_torch_ipc_collectives.py`` run
(``launch.mesh.MeshPool``, on the CPU and on the card).

Spawned ranks import this module by name; it imports the port, torch and
numpy only.  Inputs arrive and results leave as numpy arrays and plain
values.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import collectives, ipc
from repro_torch.distributed.sharding import Placement
from repro_torch.launch.mesh import make_host_mesh

# the tree each rank gathers: a leaf split over data, one over model, one
# over both axes at once and one on two dims; odd sizes, three dtypes
TREE_SPECS = {"a": ("data", None), "b": (None, "model"),
              "c": (("data", "model"), None), "d": ("data", "model", None)}


def full_tree(seed: int) -> dict:
    """The whole tree, the same on every rank (numpy)."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 7)).astype(np.float32),
            "b": rng.integers(-9, 9, (3, 6)).astype(np.int32),
            "c": rng.standard_normal((8, 3)).astype(np.float16),
            "d": rng.standard_normal((4, 2, 5)).astype(np.float32)}


def cpu_collectives(seed: int) -> dict:
    """On a ``2x2`` mesh of CPU ranks, each rank's input drawn from
    ``seed + rank``: a SUM over ``model``, a MAX over the whole mesh, an
    all-gather over ``data`` along dim 1, ``reduce_f32_buckets`` over
    ``data`` and ``gather_leaves`` of :func:`full_tree`; the inputs, the
    results and the arenas this rank holds after them."""
    mesh = make_host_mesh(data=2, model=2)
    rng = np.random.default_rng(seed + mesh.rank)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    t = torch.from_numpy(x)
    leaves = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              for n in (11, 1)]
    pl = Placement(mesh, TREE_SPECS)
    mine = pl.local({k: torch.from_numpy(v)
                     for k, v in full_tree(seed).items()})
    gathered = collectives.gather_leaves(mine, pl)
    return dict(
        rank=mesh.rank, x=x, leaves=[v.numpy() for v in leaves],
        sum_model=collectives.all_reduce(t, mesh, "model").numpy(),
        max_all=collectives.all_reduce(
            t, mesh, ("data", "model"),
            op=torch.distributed.ReduceOp.MAX).numpy(),
        gather_data=collectives.all_gather(t, mesh, "data", 1).numpy(),
        buckets=[v.numpy() for v in collectives.reduce_f32_buckets(
            leaves, mesh, "data")],
        gathered={k: v.numpy() for k, v in gathered.items()},
        arenas=ipc.arena_count())


def fail_between_collectives(device: str) -> None:
    """On a ``1x2`` mesh: an all-reduce over ``model``, then rank 1 raises
    while rank 0 goes on into a second one."""
    mesh = make_host_mesh(data=1, model=2)
    x = torch.ones(1000, device=device)
    collectives.all_reduce(x, mesh, "model")
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails between two collectives")
    collectives.all_reduce(x, mesh, "model")


def card_sum(device: str) -> list:
    """On a ``1x2`` mesh: ``rank + 1`` summed over ``model``, two
    elements."""
    mesh = make_host_mesh(data=1, model=2)
    x = torch.full((2,), float(mesh.rank + 1), device=device)
    return collectives.all_reduce(x, mesh, "model").cpu().tolist()
