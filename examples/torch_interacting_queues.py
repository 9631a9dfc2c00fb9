"""Paper §6.5 / Fig. 8 demo: two PerfConfs, one hard memory constraint.

A request queue (1MB items) and a response queue (1.8MB items) share a
495MB budget.  Writes dominate first; reads join at t=50.  Both controllers
are marked super-hard on the same metric, so SmartConf splits the error
(N = 2) and rebalances the caps as the mix shifts — memory never crosses
the red line.

The port of ``examples/interacting_queues.py`` on ``repro_torch``, with
its own copy of the two-queue environment and the profiling fit (the
JAX example takes them from ``benchmarks/bench_interacting.py``, which
imports the JAX package): the same numbers, the same lines.

Run:  PYTHONPATH=src python examples/torch_interacting_queues.py
"""

import dataclasses

import numpy as np

from repro_torch.core import GoalSpec, fit_model
from repro_torch.core import simenv as se
from repro_torch.core.smartconf import ConfRegistry, SmartConfIndirect

GOAL = GoalSpec(495.0, hard=True, super_hard=True)


class TwoQueueEnv:
    """Request queue (1MB items) + response queue (1.8MB items) in one
    memory budget.  Reads arrive at t>=50 (paper Fig. 8 recipe)."""

    base_mem = 150.0
    svc_req, svc_resp = 60.0, 50.0
    horizon = 400

    def run(self, policies, seed=1):
        rng = np.random.default_rng(seed)
        q1 = q2 = 0.0
        c1 = c2 = 0.0
        trace = {"mem": [], "c1": [], "c2": [], "q1": [], "q2": []}
        viol = 0
        served = 0.0
        for t in range(self.horizon):
            writes = rng.poisson(55.0)
            reads = rng.poisson(45.0) if t >= 50 else 0
            mem = (self.base_mem + 4.0 * rng.standard_normal()
                   + q1 * 1.0 + q2 * 1.8)
            c1 = policies[0](mem, q1, t)
            c2 = policies[1](mem, q2, t)
            # admissions at the new caps
            q1 += min(float(writes), max(0.0, c1 - q1))
            q2 += min(float(reads), max(0.0, c2 - q2))
            mem = (self.base_mem + 4.0 * rng.standard_normal()
                   + q1 * 1.0 + q2 * 1.8)
            viol += mem > GOAL.value
            s1 = min(q1, self.svc_req * (0.4 + 0.6 * min(1, q1 / 200))
                     * (1 + 0.05 * rng.standard_normal()))
            s2 = min(q2, self.svc_resp * (0.4 + 0.6 * min(1, q2 / 200))
                     * (1 + 0.05 * rng.standard_normal()))
            q1 -= max(s1, 0.0)
            q2 -= max(s2, 0.0)
            served += s1 + s2
            for k, v in (("mem", mem), ("c1", c1), ("c2", c2),
                         ("q1", q1), ("q2", q2)):
                trace[k].append(v)
        return viol, served, {k: np.asarray(v) for k, v in trace.items()}


def _profile_alpha(item_mb):
    # profiling: memory vs queue depth slope == item size
    return fit_model([50, 100, 200], [[150 + c * item_mb + d for d in (-8, 0, 8)]
                                      for c in [50, 100, 200]],
                     conf_min=0, conf_max=5000)


registry = ConfRegistry()
m1 = dataclasses.replace(_profile_alpha(1.0), lam=0.06)
m2 = dataclasses.replace(_profile_alpha(1.8), lam=0.06)
sc1 = SmartConfIndirect("req_queue.max", metric="mem", goal=GOAL,
                        initial=0.0, model=m1, registry=registry)
sc2 = SmartConfIndirect("resp_queue.max", metric="mem", goal=GOAL,
                        initial=0.0, model=m2, registry=registry)
print(f"controllers on 'mem': N = {sc1.controller.n_interacting} "
      f"(super-hard => error split)")

env = TwoQueueEnv()
viol, served, trace = env.run(
    [se.SmartConfPolicy(sc1, True), se.SmartConfPolicy(sc2, True)], seed=1)

for t in (10, 40, 60, 100, 200, 399):
    print(f"t={t:3d}  mem={trace['mem'][t]:5.0f}/495MB  "
          f"cap_req={trace['c1'][t]:5.0f} cap_resp={trace['c2'][t]:5.0f}  "
          f"q_req={trace['q1'][t]:4.0f} q_resp={trace['q2'][t]:4.0f}")

print(f"\nviolations: {viol} (hard goal held), served: {served:.0f}")
assert viol == 0
