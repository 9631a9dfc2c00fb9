"""End-to-end training example: a small LM with the full substrate —
synthetic data pipeline (SmartConf-managed prefetch), AdamW, checkpointing
with controller-tuned interval, preemption-safe restart.

The port of ``examples/train_lm.py`` on ``repro_torch``.  On the card
(the default device) each step runs the flash attention forward and
backward kernels; ``--device cpu`` runs their plain versions.  Default
invocation is CI-sized; ``--preset 100m --steps 300`` is the real run
(a ~100M model for a few hundred steps).

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps N] [--device cpu]
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig


def build_cfg(preset: str):
    base = get_config("yi-6b")           # llama-family backbone
    if preset == "100m":
        return dataclasses.replace(
            base, name="lm-100m", num_layers=12, d_model=512, num_heads=8,
            num_kv_heads=8, head_dim=64, d_ff=2048, vocab_size=32000,
            dtype="float32")             # ~92M params
    return reduced(base)                 # CI-sized


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = build_cfg(args.preset)
    print(f"model: {cfg.name}  ~{cfg.param_count()/1e6:.1f}M params")
    tc = TrainerConfig(workdir=args.workdir, total_steps=args.steps,
                       ckpt_interval=max(args.steps // 4, 1),
                       batch_size=args.batch, seq_len=args.seq)
    opt = adamw.AdamWConfig(lr=3e-4, warmup_steps=max(args.steps // 10, 1),
                            total_steps=args.steps)
    tr = Trainer(cfg, opt, tc, device=args.device)
    if tr.step:
        print(f"resumed from checkpoint at step {tr.step}")
    log = tr.run()
    for m in log[:: max(len(log) // 10, 1)]:
        print(f"step {m['step']:4d}  loss {m['loss']:.4f}  lr {m['lr']:.2e}  "
              f"gnorm {m['grad_norm']:.2f}")
    print(f"final loss: {log[-1]['loss']:.4f} (from {log[0]['loss']:.4f})")
    print(f"prefetch depth now: {tr.pipeline.depth}; "
          f"ckpt interval now: {tr.ckpt.interval_steps}")
    tr.close()


if __name__ == "__main__":
    main()
