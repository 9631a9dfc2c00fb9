"""Serving meshes of processes: one rank per ``(data, model)`` position.

The reference runs one JAX program over a device mesh; the port runs one
process per mesh position (SPMD), joined by ``torch.distributed`` groups
on gloo.  Every rank runs the same host scheduler over the same requests
and meets the others only in the collectives of
:mod:`repro_torch.distributed.collectives`.

* :func:`make_host_mesh` — the reference's validation, against the
  process group's world size ("visible devices"), and a :class:`ServeMesh`
  for this rank.  Ranks are laid out row-major, as
  ``jax.make_mesh((D, M), ("data", "model"))`` lays out devices: rank
  ``d * M + m`` sits at ``(d, m)``.
* :class:`MeshPool` / :func:`spawn_mesh` — start ``D * M`` ranks on a
  free localhost port and run functions on all of them.
* :func:`make_production_mesh` — the reference's production meshes
  (``(data=16, model=16)``, ``(pod=2, data=16, model=16)``) as
  :class:`ShapeMesh`, shapes alone, for the dry-run's spec derivation:
  no process group.

The mesh is the port's own object and not ``init_device_mesh``: on CUDA
that one reaches for NCCL, which refuses two ranks on one GPU, and the
card this port is measured on is one H100.  The process groups are
gloo's.  Gloo carries the collectives of CPU tensors and a barrier a
chunk for those of CUDA tensors, which the ranks, all on card 0, sum and
gather on the card through CUDA IPC (:mod:`repro_torch.distributed.ipc`;
each group's arena is closed on every rank before its slots are freed,
when the pool stops its ranks, behind a barrier on a group no arena
uses).
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.distributed import ipc

__all__ = ["ServeMesh", "make_host_mesh", "world", "MeshPool", "spawn_mesh",
           "ShapeMesh", "make_production_mesh"]

AXES = ("data", "model")
DEFAULT_TIMEOUT_S = 120.0

# process groups by (data, model), built once per process: every rank
# builds the same meshes in the same order, so the cache stays in step
_GROUPS: dict[tuple[int, int], dict] = {}


class ServeMesh:
    """This rank's view of a ``(data, model)`` mesh: ``shape`` (``{"data":
    D, "model": M}``), ``axis_names``, its ``data_index`` and
    ``model_index``, and one process group per axis (:meth:`group`)."""

    def __init__(self, data: int, model: int, rank: int, groups: dict):
        self.shape = {"data": data, "model": model}
        self.axis_names = AXES
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, model)
        self._groups = groups

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def group(self, axes):
        """The process group over ``axes`` (an axis name or a tuple of
        them) that holds this rank; None for a group of one rank."""
        key = frozenset((axes,) if isinstance(axes, str) else axes)
        return self._groups.get(key)

    def axis_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else axes
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def __repr__(self) -> str:
        return (f"ServeMesh({self.shape['data']}x{self.shape['model']}, "
                f"rank {self.rank} at data {self.data_index}, model "
                f"{self.model_index})")


class ShapeMesh:
    """A mesh's shape alone: ``axis_names``, ``shape`` (axis -> size) and
    ``size``, what the spec functions of
    :mod:`repro_torch.distributed.sharding` read.  It also reads as rank
    0's view of a ``(data, model)`` mesh without a process group (the
    indices, :meth:`axis_size`, :meth:`group`), which is how the dry-run
    runs the mesh train step on ``meta`` tensors: there the collectives
    keep their outputs' shapes and carry nothing."""

    data_index = model_index = 0

    def __init__(self, sizes, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def axis_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else axes
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def group(self, axes):
        return None

    def __repr__(self) -> str:
        return f"ShapeMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """Single pod: 256 chips as ``(data=16, model=16)``; two pods: 512 as
    ``(pod=2, data=16, model=16)``, the pod axis carrying data
    parallelism only."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))


def world() -> tuple[int, int]:
    """``(world size, rank)`` of the process group; ``(1, 0)`` without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _build_groups(data: int, model: int, n: int) -> dict:
    """Every rank calls ``new_group`` for every group, in one order."""
    rows = [[d * model + m for m in range(model)] for d in range(data)]
    cols = [[d * model + m for d in range(data)] for m in range(model)]
    everyone = list(range(data * model))
    out = {}
    for key, sets in ((frozenset({"model"}), rows),
                      (frozenset({"data"}), cols),
                      (frozenset(AXES), [everyone])):
        for ranks in sets:
            if len(ranks) == 1:
                continue
            g = (dist.group.WORLD if len(ranks) == n
                 else dist.new_group(ranks))
            if dist.get_rank() in ranks:
                out[key] = g
    return out


def make_host_mesh(*, data: int | None = None, model: int = 1) -> ServeMesh:
    """A ``(data, model)`` mesh over the process group's ranks.

    Validates the shape against the world size (the reference's visible
    devices; 1 without a process group) with the reference's messages,
    instead of building a degenerate mesh.  A rank past ``data * model``
    raises after the groups are built (every rank must take part in
    building them)."""
    n, rank = world()
    if model < 1:
        raise ValueError(f"make_host_mesh: model={model} must be >= 1")
    if model > n:
        raise ValueError(
            f"make_host_mesh: model={model} exceeds the {n} visible "
            f"device(s); start {model} ranks (or more) with "
            f"launch.mesh.spawn_mesh or shrink the model axis")
    if data is None:
        if n % model:
            raise ValueError(
                f"make_host_mesh: model={model} does not divide the {n} "
                f"visible device(s) evenly; pass data= explicitly or pick "
                f"a model size that divides {n}")
        data = n // model
    if data < 1:
        raise ValueError(f"make_host_mesh: data={data} must be >= 1")
    if data * model > n:
        raise ValueError(
            f"make_host_mesh: mesh ({data}x{model}) needs {data * model} "
            f"devices but only {n} are visible; start {data * model} ranks "
            f"with launch.mesh.spawn_mesh or shrink the mesh")
    if (data, model) not in _GROUPS:
        _GROUPS[(data, model)] = (_build_groups(data, model, n) if n > 1
                                  else {})
    if rank >= data * model:
        raise ValueError(f"make_host_mesh: rank {rank} lies outside the "
                         f"{data}x{model} mesh")
    return ServeMesh(data, model, rank, _GROUPS[(data, model)])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_device(device) -> str:
    """What the ranks run on: CUDA unless the caller asks for something
    else, as ``models.transformer.resolve_device`` rules; asking for CUDA
    without a card raises here, before any rank starts.  (The parent
    only names the device: each rank takes card 0 itself.)"""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    return str(device)


def _rank_main(rank, n, data, model, port, device, timeout_s, threads,
               tasks, results) -> None:
    """One rank: join the group, build the mesh, run what it is fed
    (``(fn, args)``, ``None`` ends) and report ``(rank, ok, result)``."""
    try:
        if threads:
            torch.set_num_threads(threads)
        if torch.device(device).type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"rank {rank}: no CUDA device")
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
        # the arenas' teardown barrier, on a group no arena uses
        teardown = (dist.new_group(backend="gloo")
                    if torch.device(device).type == "cuda" else None)
        make_host_mesh(data=data, model=model)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, None))
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            fn, args = item
            try:
                results.put((rank, True, fn(*args)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        if teardown is not None:
            ipc.close_arenas(teardown)
        dist.destroy_process_group()


class MeshPool:
    """``data * model`` ranks started once (spawned processes on one host,
    a gloo group on a free localhost port), each running every function
    :meth:`run` feeds it.  ``timeout_s`` bounds each collective (gloo's
    timeout: a collective that deadlocks fails instead of waiting for
    gloo's 30-minute default) and each :meth:`run`.  After a failed run
    the pool starts its ranks anew at the next one: a rank that raised
    can leave its group out of step.  The ranks run on the card unless
    ``device`` names another (``"cpu"``); without a card the default
    raises."""

    def __init__(self, data: int, model: int, *, device=None,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 threads: int | None = None) -> None:
        self.data, self.model = data, model
        self.n = data * model
        self.device = _rank_device(device)
        self.timeout_s = timeout_s
        self.threads = threads
        self._procs: list = []

    def _start(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        self._tasks = [ctx.Queue() for _ in range(self.n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.n, self.data, self.model, port, self.device,
                  self.timeout_s, self.threads, self._tasks[r],
                  self._results)) for r in range(self.n)]
        for p in self._procs:
            p.start()
        self._collect("start")

    def _collect(self, what: str) -> list:
        deadline = time.monotonic() + self.timeout_s + 30.0
        got: dict[int, tuple[bool, object]] = {}
        while len(got) < self.n:
            try:
                rank, ok, val = self._results.get(timeout=1.0)
                got[rank] = (ok, val)
                if not ok:
                    # the others may wait in a collective the failed rank
                    # never enters: give them a moment to report, not
                    # gloo's whole timeout
                    deadline = min(deadline, time.monotonic() + 5.0)
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(self._procs)
                    if not p.is_alive() and r not in got]
            if dead or time.monotonic() > deadline:
                self.close()
                why = (f"rank(s) {dead} died" if dead else
                       f"ranks {sorted(set(range(self.n)) - set(got))} "
                       "silent")
                errs = [v for ok, v in got.values() if not ok]
                raise RuntimeError(f"mesh {self.data}x{self.model} {what}: "
                                   f"{why}" + "".join("\n" + e for e in errs))
        errs = [f"rank {r}:\n{v}" for r, (ok, v) in sorted(got.items())
                if not ok]
        if errs:
            self.close()
            raise RuntimeError(f"mesh {self.data}x{self.model} {what} "
                               "failed:\n" + "\n".join(errs))
        return [got[r][1] for r in range(self.n)]

    def run(self, fn, *args) -> list:
        """``fn(*args)`` on every rank; returns the results by rank.  ``fn``
        must be importable by name and return something picklable (numpy
        arrays and plain values, not tensors).  Any rank that raises fails
        the call with every rank's traceback."""
        if not self._procs:
            self._start()
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(getattr(fn, "__name__", "run"))

    def close(self) -> None:
        """Stop every rank: asked first, its late results drained (a rank
        cannot exit while its queue holds unread data), terminated after
        10 s."""
        procs, self._procs = self._procs, []
        for q, p in zip(getattr(self, "_tasks", []), procs):
            if p.is_alive():
                q.put(None)
        deadline = time.monotonic() + 10.0
        while any(p.is_alive() for p in procs) and \
                time.monotonic() < deadline:
            try:
                self._results.get(timeout=0.1)
            except queue.Empty:
                pass
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=5.0)

    def __enter__(self) -> "MeshPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def spawn_mesh(data: int, model: int, fn, *args, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S,
               threads: int | None = None) -> list:
    """Start ``data * model`` ranks, run ``fn(*args)`` on each, stop them,
    and return the results by rank (see :meth:`MeshPool.run`; on the card
    unless ``device`` names another).  Inside
    ``fn``, :func:`make_host_mesh` gives the rank its mesh; an engine
    built with ``ServeOptions(mesh="DxM")`` builds the same one."""
    with MeshPool(data, model, device=device, timeout_s=timeout_s,
                  threads=threads) as pool:
        return pool.run(fn, *args)
