"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]``.

Runs the SmartConf-governed :class:`~repro_torch.train.trainer.Trainer`
(both controllers live, checkpoints under ``--workdir``, SIGTERM writes a
checkpoint and stops) on CUDA, or with ``--device cpu`` on the CPU with
the kernels' plain versions.  Without ``--full-size`` the arch runs at
its ``reduced()`` size.  The attention archs (yi-6b, h2o-danube-3-4b,
gemma3-4b, starcoder2-15b) and the recurrent ones (recurrentgemma-9b,
rwkv6-7b) train; the MoE and modality archs raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import reduced
from repro_torch.optim import adamw
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    print(f"training {cfg.name}: ~{cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch}x{args.seq}")
    tc = TrainerConfig(workdir=args.workdir, total_steps=args.steps,
                       ckpt_interval=max(args.steps // 5, 1),
                       batch_size=args.batch, seq_len=args.seq,
                       n_micro=args.microbatches)
    opt = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                            total_steps=args.steps)
    tr = Trainer(cfg, opt, tc, device=args.device)
    tr.preemption.install()
    log = tr.run()
    if log:
        print(f"loss {log[0]['loss']:.4f} -> {log[-1]['loss']:.4f}; "
              f"last ckpt @ step {tr.ckpt.last_saved}")
    tr.close()


if __name__ == "__main__":
    main()
