"""Serving example: continuous batching with SmartConf-governed admission.

A burst of requests hits a small LM behind the engine; the interacting
``max_queue_tokens`` / ``kv_block_budget`` controllers keep device memory
under the hard budget while maximizing batch occupancy (the paper's
HB3813/HB6728 scenario on a real model).

The port of ``examples/serve_lm.py`` on ``repro_torch``.  On the card
(the default device) the engine's packed ticks run the paged segment and
paged decode kernels; ``--device cpu`` runs their plain versions.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import zoo
from repro_torch.models.bridge import tree_leaves
from repro_torch.serve import Request, ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)

    cfg = reduced(get_config("h2o-danube-3-4b"))
    params = zoo.init(cfg, torch.Generator(device=device).manual_seed(0),
                      device)
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in tree_leaves(params))
    budget = weight_bytes + 2_000_000
    print(f"model: {cfg.name}  weights {weight_bytes/1e6:.1f}MB  "
          f"HBM budget {budget/1e6:.1f}MB")

    eng = ServeEngine(cfg, params, max_batch=4, cache_len=128,
                      hbm_budget_bytes=budget, block_tokens=16, device=device)

    rng = np.random.default_rng(0)
    for i in range(16):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(8, 48)))
        eng.submit(Request(i, prompt.astype(np.int32), max_new_tokens=16))

    tick = 0
    while len(eng.finished) < 16 and tick < 400:
        stats = eng.tick()
        tick += 1
        if tick % 20 == 0:
            print(f"tick {tick:3d}  queued={stats['queued']:2d} "
                  f"running={stats['running']} "
                  f"finished={stats['finished']:2d} "
                  f"hbm={stats['hbm']/1e6:6.1f}MB "
                  f"queue_cap={eng.max_queue_tokens} "
                  f"kv_budget={eng.pool.max_blocks}")

    print(f"\nfinished {len(eng.finished)}/16 in {tick} ticks; "
          f"HBM violations: {eng.accountant.violations}; "
          f"peak {eng.accountant.peak_bytes/1e6:.1f}MB of "
          f"{budget/1e6:.1f}MB")
    print(f"mean TTFT {eng.ttft.mean()*1e3:.1f}ms; "
          f"decode p99 {eng.decode_latency.p99()*1e3:.1f}ms")
    print(f"prefill[{eng.prefill_impl}]: {eng.prefill_calls} calls, "
          f"{eng.model_programs} model call shapes for "
          f"{len({len(r.prompt) for r in eng.finished})} distinct prompt "
          "lengths")
    assert len(eng.finished) == 16
    assert eng.accountant.violations == 0
    eng.close()


if __name__ == "__main__":
    main()
