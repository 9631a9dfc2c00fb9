"""SmartConf for a launch-time PerfConf: the microbatch count, tuned with
the paper's controller against the dry-run's memory reckoning.  The port
of ``src/repro/launch/autotune.py``.

``train.microbatch_tokens`` cannot change inside a step, but the SmartConf
loop still applies offline.  The "plant" is the dry-run's reckoning of
one rank's peak bytes (:func:`repro_torch.launch.dryrun.reckon`: the
train step run on ``meta`` under
:class:`~repro_torch.roofline.op_cost.OpCost`; the reference compiles
instead), the configuration is the microbatch count, and the user goal
is the HBM budget (hard).  The controller's indirect form fits: the
deputy is the temporaries' share of the peak (what microbatching
divides), with an incremental transducer mapping desired temporary
bytes to a microbatch count.

    python -m repro_torch.launch.autotune --arch llama4-maverick-400b-a17b \\
        --budget-gb 15

The loop is the reference's, decision for decision: virtual goal from a
lambda, two poles, the best-effort alert when no divisor of the batch
fits.  The batch whose divisors it tries is the rows one rank's step
takes (the port's step splits a rank's own rows into microbatches): the
global batch on one card, 16 of ``train_4k``'s 256 on the 16 x 16 pod.
"""

import argparse
import json
import os

from repro_torch.core import ControllerModel, GoalSpec, SmartConfIndirect
from repro_torch.core.smartconf import ConfRegistry

__all__ = ["measure", "autotune", "main"]


def measure(arch: str, shape_name: str, n_micro: int, *, cfg=None,
            shape=None, mesh=None) -> dict:
    """One reckoning probe at the given microbatch count: ``{n_micro,
    peak_bytes, static_bytes, temp_bytes}`` a rank.  ``cfg`` (a cut of
    the arch, say), ``shape`` and ``mesh`` override the arch's config, the
    named shape and the single-pod production mesh."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_production_mesh

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=False)
    r = dr.reckon(cfg, shape, mesh, n_micro=n_micro)
    return {"n_micro": n_micro, "peak_bytes": int(r["peak_bytes"]),
            "static_bytes": int(r["argument_bytes"]),
            "temp_bytes": int(r["temp_bytes"])}


def _rows(arch: str, shape_name: str, *, cfg=None, shape=None,
          mesh=None) -> int:
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_production_mesh
    return dr.rows_per_rank(cfg or get_config(arch),
                            shape or SHAPES[shape_name],
                            mesh or make_production_mesh(multi_pod=False))


def autotune(arch: str, shape_name: str, budget_bytes: float,
             *, max_iters: int = 5, **measure_kw) -> list[dict]:
    """The reference's loop; ``measure_kw`` go to every :func:`measure`
    call (a cut config, shape or mesh)."""
    batch = _rows(arch, shape_name, **measure_kw)

    # Seed probe: peak = static + activations(n_micro=1)
    history = [measure(arch, shape_name, 1, **measure_kw)]
    static = history[0]["static_bytes"]
    act0 = max(history[0]["peak_bytes"] - static, 1)

    # Controller on the deputy "activation (temp) bytes"; the transducer is
    # INCREMENTAL — n_new = n * temp_now / temp_desired — so the controller
    # keeps integrating even where temp has a microbatch-independent floor
    # (paper: model error is disturbance, the loop corrects it).
    state = {"n": 1, "temp": float(act0)}

    def transduce(desired_temp: float) -> float:
        return state["n"] * state["temp"] / max(desired_temp, 1.0)

    model = ControllerModel(alpha=1.0, delta=1.3, lam=0.08,
                            conf_min=0.0, conf_max=float(act0), integer=False)
    registry = ConfRegistry()
    sc = SmartConfIndirect(
        "train.microbatch_tokens", metric="hbm_peak_bytes",
        goal=GoalSpec(budget_bytes, hard=True), initial=float(act0),
        model=model, registry=registry, transducer=transduce)
    from repro_torch.optim.accum import quantize_microbatches
    for it in range(max_iters):
        rec = history[-1]
        state["n"] = rec["n_micro"]
        state["temp"] = float(max(rec["peak_bytes"] - static, 1))
        sc.set_perf(float(rec["peak_bytes"]), state["temp"])
        n_new = quantize_microbatches(batch, max(1.0, float(sc.get_conf())))
        if n_new == rec["n_micro"] and rec["peak_bytes"] > budget_bytes:
            # quantization rounded back down while still over budget:
            # actuate to the next feasible divisor (integer actuator floor)
            from repro_torch.optim.accum import divisors
            bigger = [d for d in divisors(batch) if d > rec["n_micro"]]
            if not bigger:
                print("goal unreachable at max feasible microbatching "
                      "(controller best-effort alert)", flush=True)
                break
            n_new = bigger[0]
        elif n_new == rec["n_micro"]:
            break
        history.append(measure(arch, shape_name, n_new, **measure_kw))
        if history[-1]["peak_bytes"] <= budget_bytes:
            break
    return history


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama4-maverick-400b-a17b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--budget-gb", type=float, default=64.0)
    ap.add_argument("--out", default="experiments/autotune_microbatch_torch"
                                     ".json")
    args = ap.parse_args()

    history = autotune(args.arch, args.shape, args.budget_gb * 1e9)
    for rec in history:
        ok = "OK " if rec["peak_bytes"] <= args.budget_gb * 1e9 else "OVER"
        print(f"[{ok}] n_micro={rec['n_micro']:3d} "
              f"peak={rec['peak_bytes']/1e9:.2f}GB "
              f"(budget {args.budget_gb}GB)", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"arch": args.arch, "shape": args.shape,
                   "budget_gb": args.budget_gb, "history": history}, fh,
                  indent=1)


if __name__ == "__main__":
    main()
