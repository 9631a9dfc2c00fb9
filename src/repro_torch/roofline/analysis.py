"""Roofline terms for the H100: the port of ``src/repro/roofline/analysis.py``.

Terms (seconds, per training or serving step, per card):
    compute    = FLOPs_per_card / peak FLOP/s
    memory     = HBM-proxy bytes_per_card / HBM bandwidth
    collective = collective_bytes_per_card / inter-card link bandwidth

The counts come from :mod:`repro_torch.roofline.op_cost`, which runs a step
on the ``meta`` device and counts what its operations and kernels do (the
reference parses XLA HLO instead; that parser, ``parse_collectives``, has no
counterpart here).

Hardware model: NVIDIA H100 SXM5 80 GB, from its datasheet: 989 TFLOP/s
dense bf16 on the tensor cores, 67 TFLOP/s f32 outside them, 3.35 TB/s of
HBM3, and NVLink 4 at 900 GB/s a card, 450 GB/s a direction.  The key
names of the three shared terms are the reference's, so one ``hw`` dict
drives both packages' :func:`roofline_terms`.  The port's ranks share one
card and sum and gather through CUDA IPC on it
(:mod:`repro_torch.distributed.ipc`, tens of GB/s a rank), not over
NVLink between cards, so ``collective_s`` is the NVLink floor, not what a
mesh step takes.
"""

from __future__ import annotations

__all__ = ["HW", "roofline_terms", "model_flops"]

HW = {
    "peak_flops": 989e12,      # bf16 dense, tensor cores, per card
    "peak_flops_f32": 67e12,   # f32 outside the tensor cores
    "hbm_bw": 3.35e12,         # bytes/s per card, HBM3
    "ici_bw": 450e9,           # bytes/s a direction, NVLink 4
    "sms": 132,                # streaming multiprocessors (kernel plans)
}


def roofline_terms(cost: dict, collective_bytes: int, *, hw=HW) -> dict:
    flops = float(cost.get("flops", 0.0))
    raw_bytes = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / hw["peak_flops"]
    t_memory = raw_bytes / hw["hbm_bw"]
    t_collective = collective_bytes / hw["ici_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    total = max(t_compute, t_memory, t_collective)
    terms["bound_s"] = total
    return terms


def model_flops(cfg, shape) -> float:
    """Useful-math FLOPs for the cell: 6*N*D train (N = active params),
    2*N*D for a forward-only prefill, 2*N*B for one decode step."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # one decode token per seq
