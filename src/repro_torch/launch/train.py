"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]``.

Runs the SmartConf-governed :class:`~repro_torch.train.trainer.Trainer`
(both controllers live, checkpoints under ``--workdir``, SIGTERM writes a
checkpoint and stops) on CUDA, or with ``--device cpu`` on the CPU with
the kernels' plain versions.  Without ``--full-size`` the arch runs at
its ``reduced()`` size.  The attention archs (yi-6b, h2o-danube-3-4b,
gemma3-4b, starcoder2-15b), the recurrent ones (recurrentgemma-9b,
rwkv6-7b) and the MoE ones (deepseek-moe-16b, llama4-maverick-400b-a17b,
whose loss adds 0.01 x the load-balancing aux) train.  The modality archs
(internvl2-1b, whisper-tiny) need patches or frames that the data stream
does not yield, as the reference's does not: the Trainer raises a
``ValueError`` naming the input; ``train_step.make_train_step`` on
``zoo.make_batch`` trains them.

``--mesh Dx1`` trains data-parallel on ``D`` ranks on this host
(``launch.mesh.spawn_mesh``; gloo, CUDA tensors staged through the
host): each rank takes ``--batch / D`` rows of the host-sharded stream,
FSDP slices the large parameters and their moments over the ranks, and
rank 0's summary is printed.  A mesh with a model axis above 1 raises:
tensor-parallel training is not ported.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import os
import tempfile

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import reduced
from repro_torch.launch.mesh import make_host_mesh, spawn_mesh, world
from repro_torch.optim import adamw
from repro_torch.serve.block_store import parse_mesh_spec
from repro_torch.train.train_step import check_train_mesh
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--full-size", action="store_true",
                    help="the full architecture (its weights, grads and "
                         "moments must fit the card)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "cpu runs the plain versions)")
    ap.add_argument("--mesh", default=None, metavar="Dx1",
                    help="train data-parallel on D ranks on this host, "
                         "e.g. 2x1 (FSDP over them); prints rank 0's "
                         "output")
    args = ap.parse_args(argv)
    if args.mesh is None:
        run(args)
        return
    data, model = parse_mesh_spec(args.mesh)
    check_train_mesh({"data": data, "model": model})
    # by module name: under `python -m` this module is __main__, which a
    # spawned rank cannot import by that name
    rank_fn = importlib.import_module("repro_torch.launch.train")._mesh_rank
    print(spawn_mesh(data, model, rank_fn, args,
                     device=args.device or "cuda")[0], end="")


def _mesh_rank(args) -> str:
    """One rank of ``--mesh``: :func:`run` on its mesh, the output of rank
    0 kept."""
    data, model = parse_mesh_spec(args.mesh)
    mesh = make_host_mesh(data=data, model=model)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run(args, mesh)
    return out.getvalue() if world()[1] == 0 else ""


def run(args, mesh=None) -> None:
    """Train as the parsed ``args`` say, in this process (this rank of
    ``mesh`` when one is given)."""
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    print(f"training {cfg.name}: ~{cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch}x{args.seq}"
          + ("" if mesh is None else
             f" on mesh {args.mesh} ({args.batch // mesh.shape['data']} "
             "rows a rank, FSDP)"))
    tc = TrainerConfig(workdir=args.workdir, total_steps=args.steps,
                       ckpt_interval=max(args.steps // 5, 1),
                       batch_size=args.batch, seq_len=args.seq,
                       n_micro=args.microbatches)
    opt = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                            total_steps=args.steps)
    tr = Trainer(cfg, opt, tc, device=args.device, mesh=mesh)
    tr.preemption.install()
    log = tr.run()
    if log:
        print(f"loss {log[0]['loss']:.4f} -> {log[-1]['loss']:.4f}; "
              f"last ckpt @ step {tr.ckpt.last_saved}")
    tr.close()


if __name__ == "__main__":
    main()
