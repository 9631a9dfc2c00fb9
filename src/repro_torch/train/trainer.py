"""Training loop with SmartConf-managed runtime PerfConfs, checkpoint and
restart, and preemption: the port of ``src/repro/train/trainer.py``.

PerfConfs wired here:
  * ``data.prefetch_depth``      — indirect, hard on host RSS;
  * ``train.ckpt_interval_steps`` — direct, soft on the share of wall time
    spent writing checkpoints (too frequent: slow steps; too rare: long
    recovery).

Parameters, gradients and optimizer state live on ``device`` (CUDA unless
the caller asks for another).  A step's time, which the checkpoint
controller reads, is taken once the step is complete on the device.
Checkpoints use the reference's format, so a run may restart from a
checkpoint written by the JAX trainer and the other way round.

A restart resumes the data stream exactly: the checkpoint records the
position of the next batch the loop will consume, and a restore sets the
source there before the prefetch thread starts.  (The reference starts
its prefetch thread before restoring, so the first batches after a
restart are the stream's first batches, and it records the producer's
look-ahead position instead of the consumed one.)

On a mesh of processes (``mesh=``, this rank's ``(data, model)``
``launch.mesh.make_host_mesh``) the loop runs ``train_step
.make_mesh_train_step`` on every rank: each holds its slices of the
parameters and moments (FSDP over ``data`` with ``fsdp``, and with
``model > 1`` its tensor-parallel share of the heads, ``ff`` columns,
vocab rows and experts) and draws its rows from the host-sharded stream (``host_id``
its data index: the ranks of one ``model`` column draw the same rows).  Every rank must take
the same host decisions or the group deadlocks: the step timer and the
checkpoint write seconds read ``collectives.agreed_clock`` (so
``train.ckpt_interval_steps`` moves alike and every rank saves on the
same steps), the preemption flag is agreed by a MAX before the forced
save, and a save gathers the full tree over both axes (a leaf split on
two dims among it), which rank 0 writes; a restore cuts each rank's
slices from it.
``data.prefetch_depth`` stays per host: it meets no collective.

The data stream yields tokens and labels only, as the reference's does,
so an arch with a modality frontend (the vision prefix's patches, the
encoder-decoder's frames) cannot train here: the constructor raises a
``ValueError`` naming the missing input, where the reference's trainer
stops at its first step on a ``KeyError``.  Such archs train through
``train_step.make_train_step`` on batches from ``zoo.make_batch``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import Checkpointer, latest_step, restore
from repro_torch.configs.base import ArchConfig
from repro_torch.core import (ControllerModel, GoalSpec, HBMAccountant,
                              SmartConf, SmartConfIndirect, StepTimer)
from repro_torch.core.smartconf import ConfRegistry
from repro_torch.data import PrefetchPipeline, SyntheticTokens
from repro_torch.distributed import collectives
from repro_torch.distributed.fault_tolerance import PreemptionHandler
from repro_torch.models import zoo
from repro_torch.models.transformer import resolve_device
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

__all__ = ["TrainerConfig", "Trainer"]


def _frontend_input(cfg: ArchConfig) -> str | None:
    """The batch key a modality frontend needs beyond tokens and labels."""
    if cfg.encoder_decoder:
        return "frames"
    if cfg.frontend == "vision":
        return "patches"
    return None


def _default_workdir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_train")


@dataclasses.dataclass
class TrainerConfig:
    workdir: str = dataclasses.field(default_factory=_default_workdir)
    total_steps: int = 100
    ckpt_interval: int = 50
    ckpt_keep: int = 2
    n_micro: int = 1
    remat: str = "dots"
    host_rss_budget: int = 512 * 1024 * 1024
    ckpt_overhead_goal: float = 0.05   # <=5% of wall time writing checkpoints
    seed: int = 0
    batch_size: int = 8
    seq_len: int = 128
    enable_smartconf: bool = True


class Trainer:
    def __init__(self, cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                 tc: TrainerConfig, device=None, *, mesh=None,
                 fsdp=True) -> None:
        missing = _frontend_input(cfg)
        if missing is not None:
            raise ValueError(
                f"{cfg.name}: the Trainer's data stream yields tokens and "
                f"labels only, and this arch needs batch[{missing!r}]; train "
                "it through train_step.make_train_step on zoo.make_batch")
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is None:
            self.step_fn = ts.make_train_step(cfg, opt_cfg,
                                              n_micro=tc.n_micro,
                                              remat=tc.remat)
            self.placement = None
        else:
            self.step_fn = ts.make_mesh_train_step(
                cfg, opt_cfg, mesh, fsdp=fsdp, n_micro=tc.n_micro,
                remat=tc.remat)
            self.placement = self.step_fn.placement
        clock = (collectives.agreed_clock(time.monotonic, mesh)
                 if mesh is not None else time.monotonic)
        self.registry = ConfRegistry()
        self.accountant = HBMAccountant(budget_bytes=tc.host_rss_budget)
        self.accountant.set("runtime", 64 * 1024 * 1024)  # base host footprint

        hosts = (0, 1) if mesh is None else (mesh.data_index,
                                             mesh.shape["data"])
        self.source = SyntheticTokens(cfg.vocab_size, tc.batch_size,
                                      tc.seq_len, seed=tc.seed,
                                      host_id=hosts[0], num_hosts=hosts[1])
        self.ckpt = Checkpointer(os.path.join(tc.workdir, "ckpt"),
                                 interval_steps=tc.ckpt_interval,
                                 keep_n=tc.ckpt_keep, clock=clock)
        self.timer = StepTimer(clock=clock)
        self.preemption = PreemptionHandler()

        # --- SmartConf controllers --------------------------------------
        self.sc_prefetch = None
        self.sc_ckpt = None
        if tc.enable_smartconf:
            batch_bytes = float(self.source.batch_nbytes())
            self.sc_prefetch = SmartConfIndirect(
                "data.prefetch_depth", metric="host_rss_bytes",
                goal=GoalSpec(float(tc.host_rss_budget), hard=True),
                initial=2.0, registry=self.registry,
                model=ControllerModel(alpha=batch_bytes, lam=0.08,
                                      delta=1.25, conf_min=1.0, conf_max=64))
            self.sc_ckpt = SmartConf(
                "train.ckpt_interval_steps", metric="ckpt_overhead_frac",
                goal=GoalSpec(tc.ckpt_overhead_goal, hard=False,
                              direction="upper"),
                initial=float(tc.ckpt_interval), registry=self.registry,
                # overhead ~ write_time / (interval * step_time): alpha<0
                model=ControllerModel(alpha=-1e-3, lam=0.1, delta=1.3,
                                      conf_min=5.0, conf_max=10000.0))

        # --- model/optimizer state ---------------------------------------
        gen = torch.Generator(self.device).manual_seed(tc.seed)
        self.params = zoo.init(cfg, gen, self.device)
        if mesh is not None:
            # every rank draws the same weights and keeps its slices
            self.params = self.placement.local(
                {"params": self.params})["params"]
        self.opt_state = adamw.init(self.params)
        self.step = 0
        self.metrics_log: list[dict] = []
        depth = self._maybe_restore()
        # the next batch the loop consumes (the source runs ahead of it)
        self.data_step = self.source.step
        self.pipeline = PrefetchPipeline(self.source, depth=depth,
                                         accountant=self.accountant)

    # ------------------------------------------------------------- restart
    def _maybe_restore(self) -> int:
        """Restore the latest checkpoint, if any, before the prefetch
        thread starts; returns the prefetch depth to start with."""
        d = self.ckpt.directory
        if latest_step(d) is None:
            return 2
        tree = {"params": self.params, "opt": self.opt_state}
        restored, extra, _ = restore(d, None, tree,
                                     placement=self.placement)
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.step = int(extra["step"])
        self.source.restore(extra["data"])
        if self.sc_ckpt is not None and "ckpt_interval" in extra:
            self.ckpt.set_interval(int(extra["ckpt_interval"]))
        return int(extra.get("prefetch_depth", 2))

    def _save(self, *, force: bool = False) -> None:
        if not force and not self.ckpt.due(self.step):
            return
        data = {"step": self.data_step, "seed": self.source.seed}
        extra = {"step": self.step, "data": data,
                 "ckpt_interval": self.ckpt.interval_steps,
                 "prefetch_depth": self.pipeline.depth}
        tree = {"params": self.params, "opt": self.opt_state}
        if self.placement is not None:
            tree = self.placement.gather(tree)     # every rank takes part
        self.ckpt.maybe_save(self.step, tree, extra=extra, force=True,
                             write=self.mesh is None or self.mesh.rank == 0)

    # ------------------------------------------------------------ controls
    def _update_controllers(self) -> None:
        if self.sc_prefetch is not None:
            self.sc_prefetch.set_perf(float(self.accountant.total()),
                                      self.pipeline.buffered())
            self.pipeline.set_depth(int(self.sc_prefetch.get_conf()))
        if self.sc_ckpt is not None and self.ckpt.writes:
            step_t = max(self.timer.mean(), 1e-6)
            per_write = self.ckpt.write_seconds / self.ckpt.writes
            overhead = per_write / (self.ckpt.interval_steps * step_t)
            self.sc_ckpt.set_perf(overhead)
            self.ckpt.set_interval(int(self.sc_ckpt.get_conf()))

    # ----------------------------------------------------------------- run
    def run(self, steps: int | None = None) -> list[dict]:
        steps = steps if steps is not None else self.tc.total_steps
        target = self.step + steps
        while self.step < target:
            preempted = self.preemption.triggered
            if self.mesh is not None:
                preempted = collectives.agreed_flag(preempted, self.mesh)
            if preempted:
                self._save(force=True)
                break
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.pipeline.get().items()}
            self.data_step += 1
            with self.timer:
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                rec = {k: float(v) for k, v in metrics.items()}  # waits
            self.step += 1
            self._update_controllers()
            self._save()
            rec["step"] = self.step
            self.metrics_log.append(rec)
        return self.metrics_log

    def close(self) -> None:
        self.pipeline.close()
        for sc in (self.sc_prefetch, self.sc_ckpt):
            if sc is not None:
                sc.close()
