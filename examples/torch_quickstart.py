"""Quickstart: put one PerfConf under SmartConf control in ~20 lines.

A toy bounded queue feeds a fixed-rate worker; the queue cap trades
throughput (deeper queue = busier worker) against memory (items are 1MB).
SmartConf profiles the relationship, synthesizes the controller, and holds
memory at the user's goal through a workload shift — no hand tuning.

The port of ``examples/quickstart.py`` on ``repro_torch``: the same
numbers, the same lines (host code; no tensor, no device).

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""

import numpy as np

from repro_torch.core import GoalSpec, SmartConfIndirect, fit_model

rng = np.random.default_rng(0)

# ---- 1. profile: sweep the cap, record (queue depth, memory) samples ------
BASE_MB = 200.0
samples = []
for cap in (50, 100, 200, 400):
    q = 0.0
    for t in range(50):
        q = min(q + rng.poisson(30), cap)
        mem = BASE_MB + q * 1.0 + 28 * np.sin(t / 5) + rng.normal(0, 12)
        samples.append((q, mem))
        q = max(0.0, q - 25)

by_bin = {}
for dep, mem in samples:
    by_bin.setdefault(round(dep / 25) * 25, []).append(mem)
model = fit_model(sorted(by_bin), [by_bin[k] for k in sorted(by_bin)],
                  conf_min=0, conf_max=5000)
print(f"synthesized: alpha={model.alpha:.2f} MB/item, pole auto, "
      f"lambda={model.lam:.3f}")

# ---- 2. the user states a goal; the developer wires two calls -------------
sc = SmartConfIndirect("demo.max_queue", metric="memory_mb",
                       goal=GoalSpec(500.0, hard=True), initial=0.0,
                       model=model)

# ---- 3. run: the controller adapts the cap, even when items double in size
q, served, viol, cap = 0.0, 0, 0, 0.0
for t in range(300):
    # workload shift: item size ramps 1MB -> 2MB over ~30 ticks from t=150
    item_mb = 1.0 + min(max(t - 150, 0) / 30.0, 1.0)
    q = min(q + rng.poisson(30), max(cap, 0))  # admission at the current cap
    mem = BASE_MB + q * item_mb + rng.normal(0, 3)   # peak memory this tick
    viol += mem > 500.0
    sc.set_perf(mem, q)                        # paper: setPerf(actual, deputy)
    cap = sc.get_conf()                        # paper: getConf()
    take = min(q, 25)
    q -= take
    served += take
    if t % 60 == 0:
        print(f"t={t:3d} item={item_mb:.2f}MB cap={cap:4.0f} queue={q:4.0f} "
              f"mem={mem:5.0f}MB (goal 500)")

print(f"\nserved={served} violations={viol} "
      f"(virtual goal was {sc.controller.virtual_goal:.0f}MB)")
assert viol == 0
