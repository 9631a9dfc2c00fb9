"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the continuous-batching engine with SmartConf-governed admission and
KV budgets against a synthetic batch of requests, on the CUDA device
unless ``--device cpu`` is given (reduced config unless ``--full-size``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import reduced
from repro_torch.models import zoo
from repro_torch.models.bridge import tree_leaves
from repro_torch.models.transformer import resolve_device
from repro_torch.serve import Request, ServeEngine, ServeOptions


def build_engine(cfg, *, max_batch: int, cache_len: int,
                 budget_headroom_bytes: float,
                 latency_goal_s: float | None, device=None,
                 seed: int = 0, prefill_mode: str = "auto",
                 params: dict | None = None) -> ServeEngine:
    """Random weights from ``seed`` on ``device`` (or ``params``, weights
    already there) and an engine whose HBM goal is the weights plus
    ``budget_headroom_bytes`` — the launcher's setup, shared with the chip
    smoke run."""
    device = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = zoo.init(cfg, gen, device)
    weights = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params))
    budget = int(weights + budget_headroom_bytes)
    return ServeEngine(cfg, params, device=device, options=ServeOptions(
        max_batch=max_batch, cache_len=cache_len, hbm_budget_bytes=budget,
        latency_goal_s=latency_goal_s, prefill_mode=prefill_mode))


def serve_requests(eng: ServeEngine, prompts: list[np.ndarray],
                   max_new_tokens: int, max_ticks: int = 2000,
                   on_tick=None) -> list[dict]:
    """Submit every prompt, tick until all finish (or ``max_ticks``), and
    return the per-tick stats; ``on_tick(eng, stats)`` runs after each
    tick."""
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p.astype(np.int32), max_new_tokens))
    stats = []
    while len(eng.finished) < len(prompts) and len(stats) < max_ticks:
        stats.append(eng.tick())
        if on_tick is not None:
            on_tick(eng, stats[-1])
    return stats


def summary(eng: ServeEngine, n_requests: int, ticks: int) -> str:
    """The reference launcher's summary line."""
    budget = eng.accountant.budget_bytes or 0
    kv = "paged" if eng.paged else "dense"
    return (f"{eng.cfg.name}: {len(eng.finished)}/{n_requests} done in "
            f"{ticks} ticks; HBM violations {eng.accountant.violations}; "
            f"peak {eng.accountant.peak_bytes/1e6:.1f}/{budget/1e6:.1f} MB; "
            f"TTFT {eng.ttft.mean()*1e3:.0f}ms; prefill[{eng.prefill_impl}] "
            f"{eng.prefill_calls} calls / {eng.model_programs} programs, "
            f"{eng.model_dispatches/max(1, ticks):.2f} dispatches/tick, "
            f"pad_fraction {eng.pad_fraction:.2f}; "
            f"kv[{kv}] {eng.pool.used_blocks} blocks used, "
            f"{eng.preemptions} preemptions")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--budget-headroom-mb", type=float, default=2.0)
    ap.add_argument("--latency-goal-ms", type=float, default=None,
                    help="decode-latency p99 goal: makes the "
                         "serve.prefill_chunk_tokens knob live")
    ap.add_argument("--prefill-mode", default="auto",
                    choices=["auto", "bucketed", "packed", "one_shot"],
                    help="packed (auto) = unified ticks: one token-packed "
                         "stream per tick carrying prefill chunks and every "
                         "running slot's decode token; bucketed = a padded "
                         "power-of-two chunk per prefilling slot, then a "
                         "decode step; one_shot = whole-prompt prefill per "
                         "admitted request into dense KV, then decode steps")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda); cpu runs the "
                         "kernels' plain versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    eng = build_engine(
        cfg, max_batch=args.max_batch, cache_len=args.cache_len,
        budget_headroom_bytes=args.budget_headroom_mb * 1e6,
        latency_goal_s=(None if args.latency_goal_ms is None
                        else args.latency_goal_ms / 1e3),
        device=args.device, seed=args.seed, prefill_mode=args.prefill_mode)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(8, 48)))
               for _ in range(args.requests)]
    stats = serve_requests(eng, prompts, args.max_new_tokens)
    print(summary(eng, args.requests, len(stats)))
    eng.close()


if __name__ == "__main__":
    main()
