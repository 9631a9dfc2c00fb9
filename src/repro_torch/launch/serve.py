"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the continuous-batching engine with SmartConf-governed admission and
KV budgets against a synthetic batch of requests, or with ``--trace``
against an open-loop arrival trace on a virtual clock (tier gating, SLO
accounting, optional fault injection, ``--replicas`` engines behind the
replica router), on the CUDA device unless ``--device cpu`` is given
(reduced config unless ``--full-size``).  The modality archs
(internvl2-1b, whisper-tiny) serve through the one-shot prefill on dense
KV, as ``prefill_mode="auto"`` resolves for them; internvl2-1b's
``num_patches`` positions (256 at full size) count against
``--cache-len`` beside each prompt and its new tokens.

``--mesh DxM`` serves on a ``(data, model)`` mesh: ``launch.mesh
.spawn_mesh`` starts ``D * M`` ranks on this host (a gloo group; on a
card they share it), each runs the same engine with
``ServeOptions(mesh="DxM")`` over the same requests, and rank 0's output
is printed, the summary line with the reference's mesh part.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import reduced
from repro_torch.core.telemetry import Telemetry
from repro_torch.launch.mesh import spawn_mesh, world
from repro_torch.models import zoo
from repro_torch.models.bridge import tree_leaves
from repro_torch.models.transformer import resolve_device
from repro_torch.serve.block_store import parse_mesh_spec
from repro_torch.serve import (ChaosMonkey, ChaosSpec, OpenLoopDriver,
                               ReplicaRouter, Request, ServeEngine,
                               ServeOptions, SLOSpec, TraceConfig,
                               VirtualClock, as_requests, synthesize_trace)


def build_engine(cfg, *, max_batch: int, cache_len: int,
                 budget_headroom_bytes: float,
                 latency_goal_s: float | None, device=None,
                 seed: int = 0, prefill_mode: str = "auto",
                 params: dict | None = None, slo: SLOSpec | None = None,
                 telemetry: Telemetry | None = None,
                 clock=time.monotonic, **options) -> ServeEngine:
    """Random weights from ``seed`` on ``device`` (or ``params``, weights
    already there) and an engine whose HBM goal is the weights plus
    ``budget_headroom_bytes`` — the launcher's setup, shared with the chip
    smoke run.  ``options`` are further ``ServeOptions`` fields (the KV
    mode, the prefix cache, speculation)."""
    device = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = zoo.init(cfg, gen, device)
    weights = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params))
    budget = int(weights + budget_headroom_bytes)
    return ServeEngine(cfg, params, device=device, clock=clock,
                       options=ServeOptions(
                           max_batch=max_batch, cache_len=cache_len,
                           hbm_budget_bytes=budget,
                           latency_goal_s=latency_goal_s,
                           prefill_mode=prefill_mode, slo=slo,
                           telemetry=telemetry, **options))


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
            f"{eng.preemptions} preemptions"
            + (f"; mesh {eng.options.mesh}: {eng.tp_shards}-way TP ticks, "
               f"{eng.kv_shard_bytes() / 1e6:.1f} MB KV per shard"
               if eng.mesh is not None else "")
            + (f"; prefix cache {eng._prefix_cache.blocks_held} blocks held, "
               f"hit rate {eng._prefix_cache.hit_rate:.2f}, "
               f"{eng.prefix_hit_tokens_total} prefill tokens reclaimed, "
               f"{eng.cow_copied_blocks} COW copies"
               if eng._prefix_cache is not None else "")
            + (f"; spec depth {eng.spec_depth}, "
               f"{eng.spec_accepted}/{eng.spec_proposed} drafts accepted"
               f" (accept rate "
               f"{eng.spec_accepted / max(1, eng.spec_proposed):.2f})"
               if eng.spec_enabled else ""))


def engine_options(args) -> dict:
    """The ``ServeOptions`` fields the KV-mode, prefix-cache and
    speculation flags set."""
    return dict(kv_mode=args.kv_mode, prefix_cache=args.prefix_cache,
                kv_cache_share=args.kv_cache_share,
                spec_depth=args.spec_depth,
                spec_depth_max=args.spec_depth_max,
                spec_adaptive=not args.no_spec_adaptive,
                accept_rate_goal=args.accept_rate_goal, mesh=args.mesh)


def run_trace(cfg, args, write: bool = True) -> None:
    """Open-loop mode: the arrival trace replayed on a virtual clock, with
    ``--chaos`` faults (with replicas they land on replica 0, and the
    router must route around them); prints the reference's trace summary
    line; exits non-zero if a tick raised."""
    vc = VirtualClock()
    slo = SLOSpec(ttft_s=args.ttft_slo_s) if args.ttft_slo_s else None
    # virtual-time timestamps: the artifacts are deterministic
    tel = Telemetry(enabled=True, clock=vc) if args.telemetry_dir else None

    def engine(params, telemetry):
        return build_engine(
            cfg, max_batch=args.max_batch, cache_len=args.cache_len,
            budget_headroom_bytes=args.budget_headroom_mb * 1e6,
            latency_goal_s=(None if args.latency_goal_ms is None
                            else args.latency_goal_ms / 1e3),
            device=args.device, seed=args.seed,
            prefill_mode=args.prefill_mode, params=params, slo=slo,
            telemetry=telemetry, clock=vc, **engine_options(args))

    first = engine(None, tel)
    if args.replicas > 1:
        # the telemetry hub (and its decision audit) goes to the router,
        # which owns the fleet-level loop, and to replica 0; the replicas
        # share one params dict
        engines = [first] + [engine(first.params, None)
                             for _ in range(args.replicas - 1)]
        eng = ReplicaRouter(engines, clock=vc, slo=slo,
                            adaptive=slo is not None, telemetry=tel)
    else:
        eng = first
    trace = synthesize_trace(TraceConfig(
        process=args.trace, rate_rps=args.rate_rps,
        horizon_s=args.horizon_s, seed=args.seed,
        prefix_groups=args.prefix_groups, prefix_len=args.prefix_len))
    chaos = None
    if args.chaos:
        chaos = ChaosMonkey(ChaosSpec(
            seed=args.seed, slow_tick_prob=0.04, slow_tick_s=0.15,
            budget_cut_tick=30, budget_cut_frac=0.6, budget_restore_tick=60,
            sensor_fault_tick=40, sensor_fault_ticks=10,
            preempt_tick=20, preempt_resume_ticks=3)).install(first)
    drv = OpenLoopDriver(
        eng, as_requests(trace, vocab=cfg.vocab_size, seed=args.seed),
        clock=vc, chaos=chaos)
    out = drv.run()
    slo_part = (f"goodput {out['goodput_tps']:.1f} tok/s under SLO "
                f"(throughput {out['throughput_tps']:.1f}); "
                if slo else "")
    print(f"{cfg.name}: open-loop {args.trace} trace, "
          f"{out['submitted']} arrivals over {args.horizon_s:.0f}s "
          f"(virtual elapsed {out['elapsed_s']:.1f}s, {out['ticks']} ticks); "
          f"{out['finished']} finished, {out['rejected']} rejected "
          f"{dict(out['reject_counts'])}; {slo_part}"
          f"{out['preemptions']} preemptions, "
          f"recompute {out['recompute_tokens']} tokens, "
          f"chaos events {len(chaos.events) if chaos else 0}, "
          f"unhandled {len(out['unhandled'])}"
          + (f"; prefix cache hit rate {first._prefix_cache.hit_rate:.2f}, "
             f"{first.prefix_hit_tokens_total} prefill tokens reclaimed"
             if first._prefix_cache is not None and args.replicas == 1
             else "")
          + (f"; {args.replicas} replicas: weights "
             f"{[round(w, 2) for w in eng.weights]}, "
             f"{eng.reroutes} rerouted on replica loss"
             if args.replicas > 1 else ""))
    if tel is not None and write:
        print_telemetry(tel.write(args.telemetry_dir))
    eng.close()
    if out["unhandled"]:
        # the driver caught what a tick raised (a kernel fault among them)
        # and stopped: the run failed
        raise SystemExit(f"unhandled exception in a tick: "
                         f"{out['unhandled'][0]}")


def print_telemetry(paths: dict) -> None:
    print(f"telemetry: {paths['trace']} (Chrome trace-event JSON, opens in "
          f"Perfetto), {paths['metrics']}, {paths['audit']}, "
          f"{paths['flight']}")


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
    ap.add_argument("--kv-mode", default="auto",
                    choices=["auto", "paged", "dense"],
                    help="paged = block-table KV store and the paged "
                         "kernels (attention-only archs); dense = per-slot "
                         "rings; auto = paged where the arch allows")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over refcounted paged KV "
                         "blocks: a request whose prompt shares a cached "
                         "prefix prefills only the uncovered suffix "
                         "(copy-on-write at the block boundary); the "
                         "cache's share of the block budget is the "
                         "SmartConf-actuated serve.kv_cache_share knob. "
                         "Needs paged KV")
    ap.add_argument("--kv-cache-share", type=float, default=0.5,
                    help="initial fraction of the KV block budget the "
                         "prefix cache may hold (SmartConf adjusts it)")
    ap.add_argument("--prefix-groups", type=int, default=0,
                    help="with --trace: shared-prefix tenant groups in the "
                         "synthesized workload (0 = none)")
    ap.add_argument("--prefix-len", type=int, default=32,
                    help="with --trace: each prefix group's common "
                         "preamble length (tokens)")
    ap.add_argument("--spec-depth", type=int, default=0,
                    help="self-speculative decode draft depth k (0 = off): "
                         "each running slot's decode segment carries up to "
                         "k n-gram drafts verified in the same dispatch; "
                         "with SmartConf on, the initial value of the "
                         "serve.spec_depth knob.  Needs packed prefill")
    ap.add_argument("--spec-depth-max", type=int, default=8,
                    help="ceiling of the serve.spec_depth knob")
    ap.add_argument("--accept-rate-goal", type=float, default=0.5,
                    help="sc_spec setpoint: the windowed draft accept rate "
                         "the depth controller holds the engine above")
    ap.add_argument("--no-spec-adaptive", action="store_true",
                    help="pin serve.spec_depth at --spec-depth instead of "
                         "letting SmartConf actuate it")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda); cpu runs the "
                         "kernels' plain versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="with --trace: N engine replicas behind one "
                         "ReplicaRouter (weighted-least-loaded dispatch; "
                         "with --ttft-slo-s the route.replica_weights are "
                         "SmartConf-actuated on each replica's TTFT-p99)")
    ap.add_argument("--trace", default=None,
                    choices=["poisson", "bursty", "diurnal"],
                    help="replay an open-loop arrival trace on a virtual "
                         "clock instead of the one-shot synthetic batch")
    ap.add_argument("--rate-rps", type=float, default=10.0,
                    help="mean arrival rate for --trace (requests/s)")
    ap.add_argument("--horizon-s", type=float, default=10.0,
                    help="trace horizon in virtual seconds")
    ap.add_argument("--ttft-slo-s", type=float, default=None,
                    help="TTFT p99 SLO: per-request goodput accounting and "
                         "the serve.admit_tier_max brownout controller")
    ap.add_argument("--chaos", action="store_true",
                    help="inject faults during --trace: slow ticks, a "
                         "mid-run KV budget cut, a NaN sensor window, one "
                         "worker preemption")
    ap.add_argument("--telemetry-dir", default=None,
                    help="enable telemetry and write trace.json, "
                         "metrics.json, audit.jsonl (controller Decisions) "
                         "and flight.json into this directory")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve on a (data, model) mesh of D*M ranks on "
                         "this host, e.g. 1x2: attention heads and the KV "
                         "cache's heads shard over model, MoE experts too; "
                         "prints rank 0's output")
    args = ap.parse_args()
    if args.replicas > 1 and args.trace is None:
        raise SystemExit("--replicas N needs --trace: the ReplicaRouter "
                         "serves an open-loop arrival stream")
    if args.mesh is None:
        run(args)
        return
    data, model = parse_mesh_spec(args.mesh)
    # by module name: under `python -m` this module is __main__, which a
    # spawned rank cannot import by that name
    rank_fn = importlib.import_module("repro_torch.launch.serve")._mesh_rank
    print(spawn_mesh(data, model, rank_fn, args,
                     device=args.device or "cuda")[0], end="")


def _mesh_rank(args) -> str:
    """One rank of ``--mesh``: the single-process run, its output kept
    and its telemetry written on rank 0 alone.  Every rank keeps a hub
    all the same: telemetry reads the agreed clock, a collective, so a
    rank without one would read it fewer times than the others."""
    rank = world()[1]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run(args, write=rank == 0)
    return out.getvalue() if rank == 0 else ""


def run(args, write: bool = True) -> None:
    """Serve as the parsed ``args`` say, in this process; ``write`` False
    keeps the telemetry files unwritten."""
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    if args.trace is not None:
        run_trace(cfg, args, write)
        return
    tel = Telemetry(enabled=True) if args.telemetry_dir else None
    eng = build_engine(
        cfg, max_batch=args.max_batch, cache_len=args.cache_len,
        budget_headroom_bytes=args.budget_headroom_mb * 1e6,
        latency_goal_s=(None if args.latency_goal_ms is None
                        else args.latency_goal_ms / 1e3),
        device=args.device, seed=args.seed, prefill_mode=args.prefill_mode,
        telemetry=tel, **engine_options(args))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(8, 48)))
               for _ in range(args.requests)]
    stats = serve_requests(eng, prompts, args.max_new_tokens)
    print(summary(eng, args.requests, len(stats)))
    if tel is not None and write:
        print_telemetry(tel.write(args.telemetry_dir))
    eng.close()


if __name__ == "__main__":
    main()
