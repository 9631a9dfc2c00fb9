"""Beyond-paper demo: the SmartConf controller beside the device work.

The host-side controller (paper §4) runs between engine ticks; knobs that
must react token-by-token (here: a decode token *budget* that throttles a
speculative branch when measured step cost rises) need the controller
where the step's numbers live.  ``repro_torch.core.tensor_controller`` is
that twin: tensors in and out, branchless two-pole logic, batchable.

The toy plant: per-token "HBM pressure" grows with the token budget; a hard
goal caps it.  The whole control loop — sensor, Eq. 2, two-pole switch,
actuation — runs on device tensors for 300 steps, and nothing is read
back to the host until the end: the port's counterpart of the reference's
single ``lax.scan`` (``examples/ingraph_controller.py``), with the same
violations and budgets.

Run:  PYTHONPATH=src python examples/torch_ingraph_controller.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core import ControllerModel, GoalSpec
from repro_torch.core import tensor_controller as tc

GOAL = 1000.0  # MB


def decode_trace(spec, state, device, steps=300):
    pressure, budget = [], []
    base = torch.tensor(300.0, device=device)
    for t in torch.arange(steps, dtype=torch.float32, device=device):
        # plant: pressure = base(t) + alpha * budget, with a mid-run shift
        base = torch.where(t == 150, base + 300.0, base)
        b = state.conf
        p = base + 8.0 * b + 20.0 * torch.sin(t / 7.0)
        state, _ = tc.controller_step(spec, state, p)
        pressure.append(p)
        budget.append(b)
    return torch.stack(pressure), torch.stack(budget)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)

    model = ControllerModel(alpha=8.0, delta=1.4, lam=0.07,
                            conf_min=1.0, conf_max=128.0, integer=False)
    spec = tc.make_spec(model, GoalSpec(GOAL, hard=True), device=device)
    state = tc.init_state(8.0, device=device)
    pressure, budget = decode_trace(spec, state, device)
    # the only reads back to the host
    pressure, budget = pressure.cpu(), budget.cpu()
    viol = int(torch.sum(pressure > GOAL))
    print(f"in-graph controller over 300 device steps: "
          f"violations={viol}, budget {float(budget[0]):.0f} -> "
          f"{float(budget[140]):.0f} (pre-shift) -> {float(budget[-1]):.0f} "
          f"(post-shift), pressure settles at "
          f"{float(pressure[-20:].mean()):.0f} "
          f"(virtual goal {float(spec.virtual_goal):.0f}, hard goal "
          f"{GOAL:.0f})")
    assert viol <= 2  # transient at the t=150 step disturbance only


if __name__ == "__main__":
    main()
