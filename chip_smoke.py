"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase's exception is
caught:

  1. device   — the card's name, count and power limit (no card: exit 1);
  2. build    — nvcc builds all eight kernel libraries at once; ptxas
                register/smem/spill lines (the flat segment kernel's
                CUDA-core route must not spill at D = 256; every RG-LRU
                scan, RWKV-6 scan and dense decode instance, with their
                registers printed, the tensor-core flash forward and
                backward kernels and the tensor-core flat and paged segment
                kernels, D 256 included, not at all), the build's seconds,
                and the dense decode, RWKV-6 and RG-LRU libraries'
                shared-memory sums held equal to their wrappers';
  3. kernels  — each CUDA kernel against its plain PyTorch version on the
                same CUDA tensors: the paged ones at yi-6b shapes, the flat
                segment one at recurrentgemma's (MQA, D 256, window 2048,
                wrapped and stale rings), plus ragged segments, MQA/GQA/MHA,
                small windows, holes, every head dim, f32 and bf16 (dead
                lanes exact zeros), both segment routes (tensor cores: bf16
                at D 64, 120, 128, 256, paged also T 8-64; CUDA cores: the
                rest, T 12 among them), decode riders of 7 slots beside a
                chunk's start in one q tile, G 12 (60 rows), G 16, G 80 (two
                head chunks), windows cutting a key tile, ragged and
                all-dead q tiles, the libraries' route rules held to the
                wrappers', a stale table entry or segment a device-side
                assert of the tensor-core paged route (child processes),
                the worst error by route; the RG-LRU scan (h and h_out)
                from a nonzero state around its 32-step stage, over 1, 3
                and 8 rows, F 64 and 33, every instance (CTA width, copy
                width, store), inputs only 4-byte aligned, at [8, 4096,
                4096], pad steps that must pass h through bit for bit and
                two launches threading the state that must equal one bit
                for bit; the RWKV-6 scan
                (y and the final state) from a random non-symmetric state
                at odd lengths and its 16-step stage's edges, with strong
                decays and neutral pad steps, over 1, 3 and 512 rows, at
                [512, 4096, 64], on inputs only 8-byte aligned, and
                threaded across a cut of 147 steps;
                the flash attention forward (o and lse) and its dQ and
                dK/dV kernels, causal, windowed (2048, 1024, 32) and
                non-causal, MHA/GQA/MQA, S = 1, 63, 130 and 4096 (at both
                main paths' shapes: yi-6b's training and recurrentgemma's,
                16/1 heads, D 256, window 2048), every head dim
                (120 too), f32 and bf16, the gradients from a random dO,
                both forward and both backward routes (tensor cores: bf16
                at D 64, 120 and 128; CUDA cores: the rest), the CUDA
                libraries' route rules held to the wrappers'; paged decode
                also on rows whose live blocks span several of its key
                splits or sit in one, and a stale table entry in a later
                split (a device-side assert, in a child process); the dense
                decode
                kernel on rings read in place through [B, Kv, S, D] views
                (yi-6b's full and at the slice's prompts, recurrentgemma's
                wrapped and with idle rows), the reference's sweep (ragged
                k_pos with -1 and future entries, windows 0 and 256,
                MHA/GQA/MQA), an all-empty cache (exact zeros), every head
                dim at S below one split, above it and not a multiple of
                it, f32 and bf16; and its edges: S off a 64-key tile at
                every head dim with G 1, 8 and 16, G 3, 20 and 64 (head
                chunks), windows ending inside a tile, rings wrapped many
                times over, rows whose keys all lie ahead (exact zeros);
                then phase 12's shapes: the paged segment kernel on decode
                segments of 2-9 lanes over table rows that share blocks
                and a copied boundary block a prefill starts inside (bf16
                on the tensor cores, f32 on the CUDA cores), the flat one
                at D 256, MQA, over 2056-entry rings (wrapped, a rejected
                draft's stale entries ahead), and both scans at T = 1,
                nine launches threading the state against one of T = 9
                (RG-LRU bit for bit; RWKV-6, whose one launch pairs its
                steps, within the f32 tolerance, its gap printed); and
                both paged kernels at phase 13's head groupings on the
                slice's mixed and decode ticks: deepseek-moe-16b's MHA
                16/16 (G 1) and llama4-maverick-400b-a17b's 40/8 (G 5),
                D 128, T 16; then phase 14's: the flash kernels (both
                routes, f32 and bf16) on keys of another length than the
                queries, without a mask: whisper-tiny's cross-attention
                (B 2, 6/6 heads of 64, Sq 77 and 448 against its 1500
                frames), its encoder (S 1500, non-causal), internvl2-1b's
                self-attention (14/2 heads, G 7, 256 patches + 200 tokens,
                causal) and, at every head dim, Sq/Sk of 65/130, 130/63
                and 1/200; dense decode at whisper's cross decode (8
                rows, every frame and the query at position 0) and
                internvl2-1b's G 7 rings;
  4. timing   — kernel, plain version, one PyTorch library call where one
                exists, and the card's bound, at each main path's shapes
                (the flash rows also at recurrentgemma-9b's training shape:
                bf16 B 2, H 16, Kv 1, D 256, S 4096, window 2048, the
                CUDA-core route, beside SDPA with the window as a mask)
                (the dense decode kernel at yi-6b's legacy decode and at
                recurrentgemma's swa rings, with its split plan; the RWKV-6
                and RG-LRU scans with the profiler's device time and their
                achieved GB/s, the RG-LRU scan also at [1, 4096, 4096]
                (one slot's prompt, in CTAs of 32 channels); the flash
                rows with their route, tiles and TFLOP/s, also at phase
                14's training shapes: whisper-tiny's cross-attention (B 2,
                Sq 128, Sk 1500) and encoder (S 1500), internvl2-1b's
                (14/2, S 512, causal), and dense decode at its two decode
                shapes (whisper's cross decode, internvl2's rings); paged decode
                with its key split and CTAs; each segment row with its
                route, grid, live work items, 64-key stages, the longest
                item's stages and TFLOP/s);
  5. parity   — full-width f32 cuts, TF32 off (seed-0 weights drawn on
                the host by a worker thread during phases 3 and 4, copied
                to the card), the card against the CPU beside
                the noise floor (the card against itself with its weights
                nudged at f32 rounding):
                yi-6b, h2o-danube-3-4b (head dim 120), gemma3-4b (one local
                and the global layer: head dim 256, two rope thetas, 262k
                vocabulary) and starcoder2-15b (G 12, LayerNorm, GELU), 2
                layers each: packed steps on paged KV (prefill chunks +
                decode riders) and a paged decode step, a training loss
                and every gradient leaf (the last two on one row), and for
                yi-6b and h2o a one-shot prefill and two dense decode
                steps; recurrentgemma-9b (5 layers) and rwkv6-7b (2
                layers): packed steps on dense state and a decode step, a
                one-shot prefill (150 tokens; rwkv6 97, a remainder chunk)
                and a training gradient (rglru_block, time_mix_chunked, the
                flash kernels at D 256); deepseek-moe-16b (2 layers: its
                dense first layer and one MoE layer of 64 experts top-6
                and two shared, 1.09 B parameters, capacity 1.25): packed
                steps on paged KV, a paged decode step, a training loss
                with its load-balancing aux and every gradient leaf on one
                row, and the router's top-6 expert set of every live
                token, card against CPU (a flip printed with its margin);
                internvl2-1b (2 layers after 256 random patches) and
                whisper-tiny (2 decoder and 2 encoder layers over 1500
                random frames, a random pos_emb): a one-shot prefill and
                five dense decode steps (logits, rings, enc_out) and a
                training loss with every gradient leaf (internvl2 on one
                row); the gradient norm's limit is ten times the largest
                of five nudged readings, for every arch; each cut's
                seconds on the card and the CPU;
  6. slice    — full yi-6b (32 layers, bf16, seeded random weights) serves
                8 requests through the launcher's functions, with the three
                SmartConf knobs live, every paged segment launch on the
                tensor-core route (asserted); then a KV budget cut must release
                device memory (phases 6-8 and 10 print their in-phase peak
                memory, less what other phases hold, beside the HBM goal);
  7. slice    — full recurrentgemma-9b (38 layers, bf16) serves 8 requests,
                two of them longer than its 2048-token window, through the
                launcher's functions under default options (packed ticks,
                dense rings, RG-LRU state), knobs live, every flat segment
                launch on the tensor-core route (asserted); each drain tick
                launches the dense decode kernel once per swa layer (12);
                then the same weights and requests with
                ``prefill_mode="legacy"``: one-shot prefill per admitted
                request (rglru_block; 12 flash forwards on the CUDA-core
                route, D 256), dense decode ticks, 1 plus the tick's
                admissions dispatches at most, 0 HBM violations, tokens
                shared with the packed run, rglru_block's ms per layer at
                the longest prompt; one prompt layer by layer through the
                one-shot and the packed forms in bf16, each layer's and the
                logits' gap within ten times the gap one more bf16 rounding
                of the input makes; then a 5-layer f32 cut, packed and
                legacy, must give the same tokens;
  8. slice    — full rwkv6-7b (32 layers, bf16) serves 8 requests through
                the launcher's functions under default options (packed
                ticks, per-slot WKV state, no rings), knobs live; then the
                cost of the reference's B x P recurrent rows; then legacy
                mode as phase 7's (time_mix_chunked; no kernel launches;
                the f32 cut has 2 layers);
  9. train    — yi-6b at full width and 4 of its 32 layers (bf16, seeded
                random weights) takes 6 AdamW steps through the Trainer
                (batch 2 x 4096, 2 microbatches, remat, both SmartConf knobs
                live; the last step profiled: device time by kind of
                kernel), a validation loss without gradients, then a
                preemption checkpoint that a fresh Trainer restores bit for
                bit.  Each step launches the flash forward 2 x layers x
                microbatches times (remat runs it again in the backward
                pass) and each backward kernel layers x microbatches times,
                every one of them on the tensor-core route (asserted), and
                the profiled step's flash forward device ms are printed;
                then full-width cuts of recurrentgemma-9b (3 layers: rglru,
                rglru, swa) and rwkv6-7b (2 layers) take 6 steps each the
                same way (no checkpoint), with the reckoned peak memory
                beside max_memory_allocated, every flash launch (D 256) on
                the CUDA-core route (asserted);
 10. split    — full yi-6b again (phase 6's weights kept), the same 8
                requests through the launcher's functions with
                ``prefill_mode="legacy"`` (one-shot prefill per admitted
                request, 32 flash forward launches each, all on the
                tensor-core route, then dense decode ticks, 32 dense decode
                launches each) and ``"bucketed"``
                (padded chunks at batch width on paged KV, then decode
                ticks on the paged decode kernel), knobs live: at most 2
                dispatches a bucketed tick, 1 plus the tick's admissions a
                legacy one; tokens/s, TTFT, tick ms, peak memory, and the
                share of tokens equal to phase 6's and to each other's
                (bf16 near-ties: information), each request's first-token
                top-2 logit margin, no HBM violation in the ledger, one
                prompt layer by layer through the one-shot and packed forms
                as in phase 7; then the same requests on 2 layers in f32,
                where both modes must give the packed engine's tokens;
 11. slo      — ``benchmarks/bench_slo.py``'s lanes on the port, its
                constants copied: the admission lane on full yi-6b (phase
                6's weights; a calm then a storm trace over 6 virtual s,
                max_batch 4, cache_len 64, 3 tiers, TTFT SLO 0.8 s; slow
                ticks, a KV budget cut at tick 30 restored at 60, a NaN
                window at 40, a worker preemption at 20) under the
                adaptive brownout and three static tier gates; the replica
                lane (two replicas at 4 of the 32 layers, replica 1 a
                straggler all storm long, preempted at tick 12, its router
                sensor NaN at 40) under adaptive and three static weight
                splits.  Each lane's adaptive goodput must beat every
                static policy's with no unhandled exception, the NaN
                windows must engage fallbacks in the written audit.jsonl,
                every chaos event must have a Decision within 6 ticks, the
                budget cut must shrink the block store on the card, every
                paged segment launch must take the tensor cores, and the
                adaptive admission run's every tick (its stats but the
                weight-dependent hbm) must equal the same run of the port
                on the CPU at ``reduced()`` size.  Goodput and throughput
                are virtual tok/s, the same on any device; the card's own
                numbers are each run's wall s, ticks, median mixed and
                decode-only tick ms and in-phase peak memory.
 12. prefix   — the prefix cache and self-speculative decode, phase 6's
     & spec     weights: (a) full yi-6b, 8 slots, cache_len 2048, HBM
                goal weights + 2 GB, a 1 s decode-latency goal (three
                knobs and ``sc_cache`` live): two groups of four requests,
                each group one 1000-token preamble and each request its
                own tail, the first of each group run to its first token
                before the others are submitted; cold (cache off), then
                warm: 6000 hit tokens and 6 boundary-block copies, no HBM
                violation, every paged segment launch on the tensor cores,
                at most one dispatch a tick; prefill tokens, the
                borrowers' TTFT, tokens/s, tick ms, the
                ``serve.kv_cache_share`` trajectory, the in-phase peak; the
                same on a 2-layer f32 cut, where warm tokens must equal
                cold ones.  (b) markov weights (a 12-token cycle) on full
                yi-6b, 8 forward-lap prompts, k = 0, static k = 4 and
                adaptive: tokens equal to k = 0's (and to the map), at most
                one dispatch a tick, accept rate above 0.9 at k = 4, decode
                tokens a slot per tick, tick ms, tokens/s and the
                ``serve.spec_depth`` trajectory; then a 2-layer f32 cut on
                random weights with an oracle drafter corrupting every
                third proposal, paged and dense: spec tokens equal k = 0's.
                (c) the same on a 5-layer f32 cut of recurrentgemma-9b
                (rings of 2056, one prompt past them) and a 2-layer one of
                rwkv6-7b, with the scans' launches at T = 1.  (d)
                ``bench_slo``'s speculation lane on full yi-6b with markov
                weights, chaos on: adaptive depth against static depths 0,
                1, 2, 4 and 8, adaptive goodput above every one, the NaN
                window's fallbacks in the written audit.jsonl, every tick
                equal to the same run on the CPU at ``reduced()`` size.
 13. moe      — (a) full deepseek-moe-16b (28 layers: one dense, 27 MoE of
                64 routed experts top-6 and two shared; bf16, 32.75 GB of
                seed-0 weights drawn on the card after phase 12 frees
                yi-6b's) serves phase 6's 8 requests through the
                launcher's functions under phase 6's settings (packed
                ticks, paged KV at T 16, 8 slots, cache_len 2048, the three
                knobs live, capacity factor 1.25), HBM goal weights + 4 GB:
                all finish, at most one dispatch a tick, no ledger
                violation, every paged segment launch on the tensor cores
                (asserted); tokens/s, TTFT, mixed and decode-only tick ms,
                the knobs' trajectories, the in-phase peak beside the goal.
                (b) ``moe_apply`` alone on one of its layers at the decode
                shape [8, 1, 2048] and on a 2048-token stream: ms by CUDA
                events and device time, kernels a call, its bound and the
                share of assignments dropped.  (c) llama4-maverick-400b-
                a17b cut in depth only, to its first 2 of 48 layers (one
                full, one full+moe of all 128 experts of 8192, top-1, one
                shared; d 5120, 40/8 heads: 18.55 B parameters, 37.1 GB),
                deepseek's weights freed first, serves the first 4 of the
                same prompts with (a)'s assertions.
 14. frontends — (a) full internvl2-1b (24 layers, 14/2 heads of 64, 256
                zero patches before each prompt, 0.63 B parameters) and
                (b) full whisper-tiny (4 decoder and 4 encoder layers over
                1500 zero frames, cross-attention after every decoder
                block), bf16, seed-0 weights drawn on the card, each
                serving 8 requests of 32-200 prompt tokens (64 new each,
                8 slots, cache_len 1024) through the launcher's functions
                under default options, so ``auto`` resolves to the
                one-shot legacy prefill on dense KV with the reference's
                RuntimeWarning (asserted), HBM goal weights + 2.2 GB as in
                phases 7 and 8: every request finishes, no ledger
                violation, ``serve.prefill_chunk_tokens`` never moves, the
                flash forward launched once a layer (encoder, decoder,
                cross) a prefill and dense decode once a layer (self,
                cross) a decode step, the cross-attention's launches
                counted apart, every flash launch on the tensor cores;
                tokens/s, TTFT, each one-shot prefill's ms, median
                prefill and decode-only tick ms, the knobs' trajectories,
                the in-phase peak beside the goal; then each arch's f32
                2-layer cut serves 4 of the prompts on the card and on the
                CPU, whose tokens must be equal; (c) 3 ``make_train_step``
                AdamW steps of each at full size on ``zoo.make_batch``
                (batch 2: internvl2 256 patches + 256 tokens, whisper 1500
                frames + 128 tokens) on the serving weights: finite
                losses, ms a step, the flash launches a step (cross apart)
                all on the tensor cores;
 15. mesh     — serving on a (data, model) mesh of processes that share
                the card (gloo groups; NCCL refuses two ranks on one GPU):
                (a) in this process, at yi-6b's serving shapes (bf16,
                32/4 heads, D 128, T 16), the paged and flat segment
                kernels and the paged and dense decode kernels launched on
                head chunk r of 4 (the decode ones with ``split_groups``
                the global B x Kv) must equal the full launch's slice of
                those heads bit for bit, each split printed, and the decode
                kernels again at their default split, the max|diff|
                printed; (b) yi-6b at full width, bf16, paged, default
                options (cache_len 2048 for phase 6's prompts) with
                ``mesh="1x4"`` serves 4 of phase 6's requests on four
                ranks (full depth where four replicas fit), rank 0's
                greedy tokens, and every rank's, equal to one process's at
                the same depth and weights, the per-rank KV bytes x 4
                equal to its store, tick ms by kind for both, the
                all-gathers' ms a tick and each rank's peak; (c)
                deepseek-moe-16b at full width cut to its dense layer and
                one MoE layer, f32, capacity factor 8, dense KV (the flat
                segment and dense decode kernels per shard), ``2x2``: the
                tokens equal one process's, the max logit gap printed, each
                rank's expert slice (E / 2 experts, moe_ff / 2 on decode).
 16. dp       — data-parallel training on a 2 x 1 mesh of processes that
                share the card (``train_step.make_mesh_train_step``, gloo):
                (a) yi-6b at full width cut to 2 layers (phase 9 trains 4:
                gloo's host-staged f32 sum takes ~10 s a step there), bf16,
                batch 2 x 4096, in one process at 2 microbatches, then on
                the two ranks at one each (its row), FSDP off and on (the
                f32 cut below FSDP on only): every rank's
                loss, grad norm and every leaf of its params and moments
                after the first step must equal one process's slices bit
                for bit (64-bit fingerprints of the bits; where a leaf
                moves, its gap against ten times the same step's gap on
                weights nudged at f32 rounding), each rank must launch the
                flash forward with LSE 2 x layers times and dQ and dK/dV
                layers times; the step's ms, its all-reduce and all-gather
                ms, each rank's peak beside a reckoning; the same on the
                cut in f32 at 2 x 1024; (b) on the bf16
                ranks with FSDP off, ``compressed_psum_grads`` of their
                gradients against the exact f32 mean, each leaf's error
                under 0.02 of its largest |mean|, bytes and ms; (c) the
                gathered state of the bf16 FSDP ranks, written by rank 0,
                restored in one process bit for bit; (d) the controller
                twin's ``coordinated_step`` on CUDA tensors against the
                host controllers.

Before the last line it prints a JSON object with every kernel's numbers
(launches summed over the serving and training phases, 13, 14, 15's and
16's ranks included, each of which sets the counts it reads to 0 before
it drives its path; for the flash forwards, dQ, dK/dV and dense decode also
``cross_launches``, those of phase 14's cross-attention), then the
card's name and power limit; the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import gc
import importlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.checkpoint import restore as checkpoint_restore  # noqa: E402
from repro_torch.checkpoint import save as checkpoint_save  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.smartconf import ConfRegistry  # noqa: E402
from repro_torch.core.telemetry import Telemetry  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.kernels import HEAD_DIMS, _build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain, decode_mask)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref, attention_lse_ref, attention_ref, bwd_route,
    flash_attention, flash_attention_dkv, flash_attention_dq,
    flash_attention_fwd_lse, fwd_route, library_bwd_route,
    library_fwd_route)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_ref, paged_gather,
    split_blocks)
from repro_torch.kernels.rglru import (rglru_ref_state,  # noqa: E402
                                       rglru_scan_state)
from repro_torch.kernels.rwkv6 import (rwkv6_ref_state,  # noqa: E402
                                       rwkv6_scan_state)
from repro_torch.kernels.segment_attention import (  # noqa: E402
    library_paged_segment_route, library_segment_route,
    paged_segment_attention, paged_segment_attention_ref, paged_segment_route,
    segment_attention, segment_attention_ref, segment_grid, segment_route,
    tile_items)
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.launch.mesh import (MeshPool, make_host_mesh,  # noqa: E402
                                     spawn_mesh, world)
from repro_torch.launch.serve import (build_engine, serve_requests,  # noqa: E402
                                      summary)
from repro_torch.models import blocks, transformer, zoo  # noqa: E402
from repro_torch.models import moe as moe_model  # noqa: E402
from repro_torch.models import rglru as rglru_model  # noqa: E402
from repro_torch.models import rwkv6 as rwkv6_model  # noqa: E402
from repro_torch.models.layers import apply_norm, project  # noqa: E402
from repro_torch.models.bridge import (keyed_leaves,  # noqa: E402
                                       tree_leaves, tree_map)
from repro_torch.optim import accum, adamw  # noqa: E402
from repro_torch.serve import (ChaosMonkey, ChaosSpec,  # noqa: E402
                               OpenLoopDriver, ReplicaRouter, Request,
                               ServeEngine, ServeOptions, SLOSpec,
                               TickCostModel, TierSpec, TraceConfig,
                               VirtualClock, as_requests, concat_traces,
                               synthesize_trace)
from repro_torch.serve.speculation import markov_params  # noqa: E402
from repro_torch.train import train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

# the wrapper modules (their packages export the functions by these names)
dense_mod = importlib.import_module(
    "repro_torch.kernels.decode_attention.decode_attention")
rwkv6_mod = importlib.import_module("repro_torch.kernels.rwkv6.rwkv6")
rglru_mod = importlib.import_module("repro_torch.kernels.rglru.rglru")
flash_vjp = importlib.import_module("repro_torch.kernels.flash_attention.vjp")

DEVICE = torch.device("cuda")
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12        # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# card vs CPU on the 2-layer model, relative to the largest value: about
# ten times the noise floor phase 5 prints beside each reading
LOGIT_LIMIT, STORE_LIMIT = 7e-4, 2e-4
# yi-6b attention at the main path's settings
H, KV, D, T = 32, 4, 128, 16
SLOTS, CACHE_LEN, WIDTH = 8, 2048, 2048
M = CACHE_LEN // T
# recurrentgemma-9b at its main path's settings: MQA attention over
# 2048-entry rings, a 4096-lane stream (cache_len 4096), recurrent width
RG_H, RG_KV, RG_D, RG_WINDOW = 16, 1, 256, 2048
RG_SLOTS, RG_CACHE_LEN, RG_WIDTH, RG_F = 8, 4096, 4096, 4096
# card vs CPU on the 5-layer model, relative to the largest value: about
# ten times the largest noise floor phase 5 prints beside them
RG_LOGIT_LIMIT, RG_STATE_LIMIT = 1e-3, 1e-3
# SmartConf steers a hard goal to its virtual goal, (1 - 0.05) of it: with
# 20.9 GB of weights a goal of weights + 1 GB puts the virtual goal below
# the weights alone and nothing is admitted; weights + 2.2 GB puts it
# ~1.05 GB above them
RG_HEADROOM = 2.2e9
# rwkv6-7b at its main path's settings: 64 heads of 64, a 4096-lane stream
# over 8 slots (cache_len 4096), so the scan sees 8 x 64 rows of 4096 steps
RWKV_H, RWKV_N, RWKV_SLOTS, RWKV_CACHE_LEN = 64, 64, 8, 4096
RWKV_WIDTH = RWKV_CACHE_LEN
RWKV_BH = RWKV_SLOTS * RWKV_H
# card vs CPU on the 2-layer model, relative to the largest value: about
# ten times the largest noise floor phase 5 prints beside them (3.4e-6
# on the logits, 1.9e-6 on the state leaves)
RWKV_LOGIT_LIMIT, RWKV_STATE_LIMIT = 4e-5, 2e-5
# phase 7's headroom: SmartConf's virtual goal, 0.95 of the hard one, then
# lies ~1.4 GB above rwkv6-7b's 14.0 GB of weights
RWKV_HEADROOM = 2.2e9
# yi-6b training attention at the slice's settings: batch 2 x 4096 tokens
# (timed whole; each microbatch of the slice is batch 1), causal
FA_B, FA_S = 2, 4096
# card vs CPU on the 2-layer model's loss and gradient leaves (each
# relative to its largest value): about ten times the noise floors
# phase 5 prints beside them (3.4e-7, and up to 1.25e-3 on a leaf: this
# random-weight model's attention is nearly one-hot, so its gradients move
# ~1e-3 under an f32-rounding nudge)
TRAIN_LOSS_LIMIT, TRAIN_GRAD_LIMIT = 3e-6, 1e-2
# the gradient norm, one number, moves by a different amount under each
# nudge (gemma3-4b's read 2.0e-4 to 1.2e-3 under five): its limit is this
# many times the largest of its floor readings, the noise floor's nudge
# and GNORM_NUDGES more, for every arch
GNORM_FLOOR_TIMES, GNORM_NUDGES = 10, 4
# phases 7 and 8: the one-shot and packed forms' bf16 hidden states (each
# layer's) and logits may differ by this many times the difference one
# more bf16 rounding of the input makes
GAP_FLOOR_TIMES = 10
# the training slice: yi-6b at full width, 4 of its 32 layers
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 2, 4096, 2, 6
TRAIN_MIN_FREE_DISK = 30e9     # two 12.2 GB checkpoints on disk while writing
# phase 9's cuts of the recurrent archs at full width: recurrentgemma-9b's
# first (rglru, rglru, swa) group, so the swa layer's flash kernels train
# at D 256; rwkv6-7b's first two layers (at full depth neither fits:
# 10.4 and 7.0 B parameters need 167 and 112 GB of bf16 weights and grads,
# f32 moments and accumulator, 16 bytes a parameter)
TRAIN_CUTS = (("recurrentgemma-9b", 3), ("rwkv6-7b", 2))
ROOT = Path(__file__).resolve().parent
FLASH_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_BWD_SRC = ("src/repro_torch/kernels/flash_attention/csrc/"
                 "flash_attention_bwd.cu")
SEG_SRC = "src/repro_torch/kernels/segment_attention/csrc/paged_segment_attention.cu"
DEC_SRC = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
FLAT_SRC = "src/repro_torch/kernels/segment_attention/csrc/segment_attention.cu"
RGLRU_SRC = "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu"
RWKV6_SRC = "src/repro_torch/kernels/rwkv6/csrc/rwkv6_scan.cu"
DENSE_SRC = ("src/repro_torch/kernels/decode_attention/csrc/"
             "decode_attention.cu")
# phase 10: the split serve modes, in the order it runs them
SPLIT_MODES = ("legacy", "bucketed")
# phase 11: benchmarks/bench_slo.py's admission and replica lanes, its
# constants copied (that module imports JAX): a calm poisson half, then a
# bursty storm half; 3 tiers; the virtual-time tick cost model; the smoke
# horizon
SLO_CALM_RPS, SLO_STORM_RPS, SLO_STORM_FACTOR, SLO_STORM_DUTY = \
    15.0, 60.0, 4.0, 0.5
SLO_TTFT_S, SLO_WINDOW, SLO_HORIZON_S = 0.8, 24, 6.0
SLO_MAX_BATCH, SLO_CACHE_LEN = 4, 64
SLO_SHARES, SLO_DEADLINES = (0.25, 0.35, 0.40), (6.0, 10.0, 14.0)
SLO_COST = dict(base_s=0.02, prefill_token_s=1e-3, decode_token_s=8e-3)
SLO_STATIC = {"static_open": 2, "static_mid": 1, "static_tight": 0}
# a chaos fault at tick T must have a controller Decision by T + 6
SLO_REACTION_TICKS = 6
ROUTER_CALM_RPS, ROUTER_STORM_RPS, ROUTER_STALL_PERIOD = 36.0, 50.0, 4
ROUTER_SPLITS = {"equal": (1.0, 1.0), "favor0": (3.0, 1.0),
                 "favor1": (1.0, 3.0)}
# the replica lane at full width on 4 of yi-6b's 32 layers (the admission
# lane keeps all 32)
ROUTER_LAYERS = 4
# phase 12a: two groups of four requests, each group one 1000-token
# preamble (no multiple of the 16-token block: every borrower copies its
# boundary block), each request its own tail of 32-512 tokens, 32 new
PREFIX_GROUPS, PREFIX_PER_GROUP, PREFIX_LEN = 2, 4, 1000
PREFIX_TAIL, PREFIX_NEW = (32, 512), 32
# phase 12a's decode-latency goal, which makes serve.prefill_chunk_tokens
# live.  The sensor is a p99 over few samples, so one slow mixed tick
# (a 2048-token prefill beside the first requests' decodes) pins it: a
# goal below that tick cuts the borrowers' prefill to 16-token chunks for
# the rest of the run (at 0.25 s more than 2000 ticks on the card)
PREFIX_LATENCY_GOAL_S = 1.0
# phase 12a's HBM goal above the weights.  Phase 6's weights + 1 GB puts
# SmartConf's virtual goal (0.95 of the hard one) ~0.35 GB over yi-6b's
# 12.1 GB of weights; the cold run's ~10.3k tokens need ~0.66 GB of KV
# (64 KB a token), so the KV budget controller cuts the budget below a
# borrower's footprint once the first requests' store is resident and
# refuses the borrowers (KV_FOOTPRINT, the reference's policy)
PREFIX_HEADROOM = 2e9
# phase 12b: markov weights whose greedy decode is a 12-token cycle
# (bench_slo.SPEC_CYCLE; token 0 left out), 8 forward-lap prompts
SPEC_CYCLE, SPEC_PROMPTS, SPEC_NEW, SPEC_K = 12, 8, 64, 4
# the f32 cuts of phases 12a-c: full width, this many layers
SPEC_CUT_LAYERS = 2
# phase 12d: bench_slo's speculation lane, its constants copied
SPEC_RATE_RPS, SPEC_LANE_S = 28.0, 8e-3
SPEC_STATIC_DEPTHS = (0, 1, 2, 4, 8)
# phase 13: the MoE archs.  deepseek-moe-16b at full size serves phase 6's
# requests under an HBM goal of its weights + 4 GB: SmartConf's virtual
# goal (0.95 of the hard one) then lies ~2.2 GB above its 32.75 GB of
# weights, ~9.4k tokens of KV at 229 KB a token (+ 2 GB would leave under
# 0.5 GB, phase 7's RG_HEADROOM reasoning)
MOE_ARCH, MAVERICK = "deepseek-moe-16b", "llama4-maverick-400b-a17b"
MOE_HEADROOM = 4e9
# 13b: moe_apply alone at the decode shape [SLOTS, 1, d] and on a packed
# stream of this many tokens
MOE_STREAM = 2048
# 13c: llama4-maverick-400b-a17b at every width and all 128 experts, cut
# to its first 2 of 48 layers (one full, one full+moe: 18.55 B
# parameters, 37.1 GB in bf16), serving the first 4 of phase 6's prompts
MAVERICK_LAYERS, MAVERICK_PROMPTS = 2, 4
# phase 14: the modality frontends.  whisper-tiny: 6 heads of 64 (MHA),
# cross-attention over its 1500 encoder frames; internvl2-1b: 14 query
# heads of 64 on 2 KV heads (G 7), 256 patch positions before each prompt
WH_H, WH_D, WH_ENC = 6, 64, 1500
IV_H, IV_KV, IV_D, IV_PATCHES = 14, 2, 64, 256
FRONT_ARCHS = ("internvl2-1b", "whisper-tiny")
# 14a/b: 8 requests of 32-200 prompt tokens, 64 new each, in 8 slots of a
# 1024-entry ring (internvl2: 256 patches + 200 + 64 = 520 positions at
# most), default options (legacy one-shot prefill, dense KV), the hard HBM
# goal weights + RG_HEADROOM, as phases 7 and 8 set theirs
FRONT_SLOTS, FRONT_CACHE_LEN, FRONT_NEW = 8, 1024, 64
FRONT_HEADROOM = RG_HEADROOM
# the f32 cuts' engines (phase 5's 2-layer weights), card against CPU: 4 of
# the prompts, 16 new tokens each
FRONT_CUT_PROMPTS, FRONT_CUT_NEW = 4, 16
# 14c: make_train_step at full size, batch 2: internvl2 256 patches + 256
# tokens, whisper 1500 frames + 128 tokens
FRONT_TRAIN_SEQ = {"internvl2-1b": IV_PATCHES + 256, "whisper-tiny": 128}
FRONT_TRAIN_BATCH, FRONT_TRAIN_STEPS = 2, 3
# phase 5's frontend cuts: a reading's limit is its fixed one or this many
# times its own noise floor, the larger (the gradient norm's rule)
FRONT_FLOOR_TIMES = 10
# phase 15: yi-6b's 4 KV heads over 4 ranks (15a, 15b); 15b serves the
# first MESH_PROMPTS of phase 6's prompts, MESH_NEW new tokens each, in
# the default 4 slots; full depth needs this much free device memory for
# each rank (12.1 GB of weights, its 0.5 GB slice of the store, a CUDA
# context and a tick's transients), else MESH_CUT_LAYERS of the 32
MESH_TP, MESH_PROMPTS, MESH_NEW = 4, 4, 16
MESH_RANK_BYTES, MESH_CUT_LAYERS = 16e9, 8
# 15c: deepseek-moe-16b's dense layer and one MoE layer, f32, at the
# reference mesh suite's capacity 8 and at 16, where no assignment drops
# on either path (the EP bodies cap over a rank's whole stream, 4 decode
# rows included, moe_apply per group: at 8 the EP decode can drop when
# all 4 rows pick one expert).  Where nothing drops the ranks' logits
# must be within MESH_MOE_GAP of one process's (the EP sum's order)
MESH_MOE_LAYERS, MESH_MOE_CAPACITY, MESH_MOE_NO_DROP = 2, 8.0, 16.0
MESH_MOE_GAP = 1e-4
MESH_KERNELS = (paged_segment_attention, paged_decode_attention,
                segment_attention, decode_attention)
# phase 16: data-parallel training on DP_DATA ranks sharing the card:
# yi-6b at full width cut to DP_LAYERS layers (phase 9 trains 4: gloo
# stages the f32 gradient sum through the host at ~0.5 GB/s, 10.6 s a
# step at 4 layers, so phase 16 cuts the depth, never the width), bf16,
# batch TRAIN_BATCH x TRAIN_SEQ, one process at TRAIN_BATCH microbatches
# against each rank at one (its row), FSDP off and on; then the same cut
# in f32 at DP_F32_SEQ tokens a row, FSDP on.  One step each, held to one
# process's bit for bit and timed
DP_DATA, DP_LAYERS, DP_F32_SEQ = 2, 2, 1024
# where a bit moves, the leaf's gap may be this many times the gap the
# same step shows with the weights nudged at f32 rounding (phase 5's rule)
DP_FLOOR_TIMES = 10
# 16b: the compressed mean's max error over the largest |exact mean|, a
# leaf (the reference's bound, tests/test_multidevice.py)
DP_COMPRESSED_LIMIT = 0.02
DP_KERNELS = (flash_attention_fwd_lse, flash_attention_dq,
              flash_attention_dkv)


def say(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    say(f"FAILED: {msg}")
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ inputs
def prompt_lens() -> np.ndarray:
    """The slice's prompt lengths, 64 to 1024 tokens (phases 3 and 4 build
    their main-path shapes from the same ones)."""
    return np.random.default_rng(0).integers(64, 1025, SLOTS)


def rg_prompt_lens() -> np.ndarray:
    """recurrentgemma's slice: 64 to 3000 tokens, the first two longer
    than its 2048-token window (their rings wrap)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 3001, RG_SLOTS)
    lens[:2] = rng.integers(RG_WINDOW + 1, 3001, 2)
    return lens


def front_prompt_lens() -> np.ndarray:
    """Phase 14's prompt lengths: FRONT_SLOTS draws in [32, 200]."""
    return np.random.default_rng(14).integers(32, 201, FRONT_SLOTS)


def make_tables(gen, b, m, n_blocks, holes: int) -> torch.Tensor:
    """Out-of-order physical ids, with ``holes`` interior -1 entries."""
    perm = torch.randperm(n_blocks, generator=gen)[:b * m].reshape(b, m)
    if holes:
        rows = torch.randint(0, b, (holes,), generator=gen)
        cols = torch.randint(1, max(2, m - 1), (holes,), generator=gen)
        perm[rows, cols] = -1
    return perm.to(torch.int32)


def segment_case(gen, *, segs, p, h, kv, d, t, b, m, holes=0):
    """A packed stream: ``segs`` = [(slot, start, length)], then dead
    lanes up to ``p``."""
    n_blocks = b * m + 8
    q_pos = torch.zeros(p, dtype=torch.int32)
    q_seg = torch.full((p,), -1, dtype=torch.int32)
    c = 0
    for slot, start, n in segs:
        q_pos[c:c + n] = torch.arange(start, start + n, dtype=torch.int32)
        q_seg[c:c + n] = slot
        c += n
    assert c <= p
    return dict(q=torch.randn(p, h, d, generator=gen),
                k_store=torch.randn(n_blocks, kv, t, d, generator=gen),
                v_store=torch.randn(n_blocks, kv, t, d, generator=gen),
                block_tables=make_tables(gen, b, m, n_blocks, holes),
                q_pos=q_pos, q_seg=q_seg)


def decode_case(gen, *, q_pos, h, kv, d, t, m, holes=0, idle=0):
    """One query token per row; each row's own block stays allocated, so
    it admits at least its own key (holes elsewhere).  Then ``idle`` rows
    as the engine passes its idle slots (position 0, table row all -1),
    which admit no key and must give exact zeros."""
    b = len(q_pos) + idle
    n_blocks = b * m + 8
    tables = make_tables(gen, b, m, n_blocks, holes)
    own = torch.randperm(n_blocks, generator=gen)[:b].to(torch.int32)
    qp = torch.tensor(list(q_pos) + [0] * idle, dtype=torch.int32)
    tables[torch.arange(b), (qp // t).long()] = own
    tables[len(q_pos):] = -1
    return dict(q=torch.randn(b, h, d, generator=gen),
                k_store=torch.randn(n_blocks, kv, t, d, generator=gen),
                v_store=torch.randn(n_blocks, kv, t, d, generator=gen),
                block_tables=tables, q_pos=qp)


# phase 11's mixed tick: slots 0 and 1 decode (one on a block's last key),
# slots 2 and 3 prefill chunks, dead lanes after
SLO_SEGS = [(0, 37, 1), (1, 63, 1), (2, 0, 30), (3, 16, 20)]


# decode riders of slots 0-6 (on a block's first key, its last, between)
# beside slot 7's chunk from its start: phase 3's tile of many work items
RIDERS7 = [(0, 83, 1), (1, 143, 1), (2, 300, 1), (3, 64, 1), (4, 77, 1),
           (5, 131, 1), (6, 2, 1), (7, 0, 45)]


def main_segment_segs():
    """A mixed tick at the slice's shapes: slots 0-3 ride as decode
    segments a few tokens past their prompts, slots 4-7 prefill chunks of
    their prompts packed up to the stream width, dead lanes after."""
    lens = prompt_lens()
    segs = [(s, int(lens[s]) + 5, 1) for s in range(4)]
    room = WIDTH - 4 - 37                    # leave a dead tail
    for s in range(4, SLOTS):
        n = min(int(lens[s]), room)
        if n <= 0:
            break
        segs.append((s, 0, n))
        room -= n
    return segs


def flat_case(gen, *, segs, p, h, kv, d, b, ring, prev=(), ahead=()):
    """The dense packed path's keys, tagged as the model tags them: every
    slot's ring flattened to one axis, then the stream's own keys.
    ``segs`` = [(slot, start, length)]; a slot's ring holds its own last
    ``ring`` positions before its start (wrapped), a slot in ``prev``
    holds an earlier occupant's positions instead, which are at or after
    its start and so stale (masked); a slot in ``ahead`` also holds the
    8 positions after its start, a rejected draft's entries of an earlier
    tick (stale, masked)."""
    ring_pos = torch.full((b, ring), -1, dtype=torch.int32)
    start = torch.zeros(b, dtype=torch.int32)
    q_pos = torch.zeros(p, dtype=torch.int32)
    q_seg = torch.full((p,), -1, dtype=torch.int32)
    c = 0
    for slot, st, n in segs:
        start[slot] = st
        hist = torch.arange(max(0, st - ring), st, dtype=torch.int32)
        ring_pos[slot, hist.long() % ring] = hist
        q_pos[c:c + n] = torch.arange(st, st + n, dtype=torch.int32)
        q_seg[c:c + n] = slot
        c += n
    assert c <= p
    for slot in prev:
        occ = torch.arange(ring + 37, dtype=torch.int32)[-ring:]
        ring_pos[slot, occ.long() % ring] = occ
    for slot in ahead:
        junk = start[slot] + torch.arange(8, dtype=torch.int32)
        ring_pos[slot, junk.long() % ring] = junk
    kpos = torch.where(ring_pos < start[:, None], ring_pos, -1)
    k_pos = torch.cat([kpos.reshape(-1), torch.where(q_seg >= 0, q_pos, -1)])
    k_seg = torch.cat([torch.arange(b, dtype=torch.int32)
                       .repeat_interleave(ring), q_seg])
    n = len(k_pos)
    return dict(q=torch.randn(p, h, d, generator=gen),
                k=torch.randn(n, kv, d, generator=gen),
                v=torch.randn(n, kv, d, generator=gen),
                q_pos=q_pos, k_pos=k_pos, q_seg=q_seg, k_seg=k_seg)


def main_flat_segs():
    """A mixed tick at recurrentgemma's shapes: slots 0-3 ride as decode
    segments a few tokens past their prompts (0 and 1 past the window),
    slots 4-7 prefill chunks — fresh over an earlier occupant's ring (4),
    mid-prompt (5, 7; 7's ring wrapped) and fresh (6) — filling the
    stream up to a dead tail."""
    lens = rg_prompt_lens()
    segs = [(s, int(lens[s]) + 5, 1) for s in range(4)]
    n = (RG_WIDTH - 4 - 37) // 4
    segs += [(4, 0, n), (5, 1500, n), (6, 0, n), (7, 2500, n)]
    return segs


def rglru_case(gen, b, s, f):
    """log_a < 0 as the model makes it, inputs, and a nonzero h0."""
    return dict(log_a=-torch.rand(b, s, f, generator=gen) * 0.5,
                b=torch.randn(b, s, f, generator=gen),
                h0=torch.randn(b, f, generator=gen))


def offset_view(x, offset):
    """A copy of ``x`` ``offset`` floats into a buffer of its own (an
    operand only 4-byte aligned when ``offset`` is odd)."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    return buf[offset:offset + x.numel()].view_as(x).copy_(x)


def rwkv6_prompt_lens() -> np.ndarray:
    """rwkv6-7b's slice: 64 to 3000 tokens."""
    return np.random.default_rng(0).integers(64, 3001, RWKV_SLOTS)


def rwkv6_case(gen, bh, s, decay="model"):
    """RWKV-6 scan inputs on ``gen``'s device: r, k, v at 0.5 N(0, 1),
    logw = -exp(N(0, 1) - 1) as the reference's kernel tests draw it
    (``strong``: down to -e^2; ``pads``: a third of the steps neutral,
    logw = r = k = 0, as ``time_mix_chunk`` makes pad lanes), u at
    0.3 N(0, 1) and a random non-symmetric s0."""
    dev, n = gen.device, RWKV_N
    r, k, v = (torch.randn(bh, s, n, generator=gen, device=dev) * 0.5
               for _ in range(3))
    z = torch.randn(bh, s, n, generator=gen, device=dev)
    if decay == "strong":
        z = (z + 2.0).clamp(max=3.0)
    logw = -torch.exp(z - 1.0)
    if decay == "pads":
        pad = torch.rand(bh, s, 1, generator=gen, device=dev) < 1 / 3
        logw, r, k = (torch.where(pad, 0.0, a) for a in (logw, r, k))
    return dict(r=r, k=k, v=v, logw=logw,
                u=torch.randn(bh, n, generator=gen, device=dev) * 0.3,
                s0=torch.randn(bh, n, n, generator=gen, device=dev))


def dense_case(gen, *, q_pos, h, kv, d, s, idle=0, ahead=0):
    """One query token per row against a dense ring ``[B, S, Kv, D]`` as
    the model keeps it: each row holds its last ``min(q_pos + 1, s)``
    positions, its own included, at ring slot ``p % s`` (wrapped once
    q_pos >= s), the rest unwritten; then ``idle`` rows as the engine
    passes its idle slots (position 0, nothing written), and ``ahead``
    rows at position 5 whose every slot holds a later position."""
    b = len(q_pos) + idle + ahead
    k_pos = torch.full((b, s), -1, dtype=torch.int32)
    for r, qp in enumerate(q_pos):
        p = torch.arange(max(0, qp - s + 1), qp + 1)
        k_pos[r, p % s] = p.to(torch.int32)
    k_pos[b - ahead:] = torch.arange(6, 6 + s, dtype=torch.int32)
    return dict(q=torch.randn(b, h, d, generator=gen),
                k_ring=torch.randn(b, s, kv, d, generator=gen),
                v_ring=torch.randn(b, s, kv, d, generator=gen),
                k_pos=k_pos,
                q_pos=torch.tensor(list(q_pos) + [0] * idle + [5] * ahead,
                                   dtype=torch.int32))


def cross_dense_case(gen, *, b, h, kv, d, s):
    """One decode token per row against all of an encoder's ``s`` frames
    as ``layers.cross_decode_attention`` passes them: K/V ``[B, S, Kv, D]``
    projected from ``enc_out``, every frame and the query at position 0."""
    return dict(q=torch.randn(b, h, d, generator=gen),
                k_ring=torch.randn(b, s, kv, d, generator=gen),
                v_ring=torch.randn(b, s, kv, d, generator=gen),
                k_pos=torch.zeros((b, s), dtype=torch.int32),
                q_pos=torch.zeros(b, dtype=torch.int32))


def sweep_dense_case(gen, *, b, h, kv, s, d):
    """The reference's kernel sweep: contiguous [B, Kv, S, D] K and V,
    k_pos uniform in [-1, 600) (unwritten and future entries), every row
    at position 599."""
    return dict(q=torch.randn(b, h, d, generator=gen),
                k=torch.randn(b, kv, s, d, generator=gen),
                v=torch.randn(b, kv, s, d, generator=gen),
                k_pos=torch.randint(-1, 600, (b, s), generator=gen,
                                    dtype=torch.int32),
                q_pos=torch.full((b,), 599, dtype=torch.int32))


def dense_args(x):
    """A dense case's kernel arguments; a ring goes in as its [B, Kv, S, D]
    view, read in place, as ``layers.decode_attention`` passes it."""
    if "k_ring" not in x:
        return x
    return dict(q=x["q"], k=x["k_ring"].transpose(1, 2),
                v=x["v_ring"].transpose(1, 2), k_pos=x["k_pos"],
                q_pos=x["q_pos"])


def on(dev, case, dtype):
    return {k: (v.to(dev, dtype) if v.is_floating_point() else v.to(dev))
            for k, v in case.items()}


# ------------------------------------------------------------------ phases
def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a GPU")
    dev = torch.device("cuda", 0)
    say(f"[device] {torch.cuda.get_device_name(0)}; count "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {card_line()}")
    return dev


def phase_build():
    t0 = time.perf_counter()
    _build.build_all()
    say(f"[build] nvcc, {len(_build.SOURCES)} libraries in parallel: "
        f"{time.perf_counter() - t0:.1f} s")
    spills_256 = []
    for name in _build.SOURCES:
        entry = ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry" in line:
                entry = line
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                say(f"[build] {name}: {line.strip()}")
            # ptxas names the flat CUDA-core kernel's D = 256 instances
            # segment_kernel<T, 256> (the tensor-core ones are below)
            if (name == "segment_attention" and "segment_kernelI" in entry
                    and "Li256E" in entry and "spill" in line):
                spills_256.append(line.strip())
    if not spills_256 or any("0 bytes spill stores, 0 bytes spill loads"
                             not in line for line in spills_256):
        fail(f"the flat segment kernel spills at D = 256: {spills_256}")
    say(f"[build] segment_attention at D = 256: {spills_256}")
    # every RG-LRU scan, RWKV-6 scan and dense decode instance: registers,
    # and no spill at all
    for lib, kern in (("rglru_scan", "rglru_scan_kernel"),
                      ("rwkv6_scan", "rwkv6_scan_kernel"),
                      ("decode_attention", "decode_split_kernel")):
        inst, name = {}, ""
        for line in _build.build_log(lib).splitlines():
            m = re.search(kern + r"I(\w+?)EE", line)
            if "Compiling entry" in line:
                name = m.group(1) if m else ""
            elif name and ("spill" in line or "registers" in line):
                inst.setdefault(name, []).append(
                    line.strip().replace("ptxas info    : ", ""))
        regs = {n: re.search(r"Used (\d+) registers", " ".join(v))
                for n, v in inst.items()}
        say(f"[build] {lib}: {len(inst)} instances, registers "
            + ", ".join(f"{n} {r.group(1) if r else '?'}"
                        for n, r in regs.items()))
        spilled = {n: v for n, v in inst.items() if not any(
            "0 bytes spill stores, 0 bytes spill loads" in x for x in v)}
        if not inst or spilled:
            fail(f"{lib} spills or is missing: {spilled or inst}")
    smem_parity()
    # the tensor-core kernels: registers, shared memory and spills by
    # instance (the flash forward and backward at three head dims each, the
    # flat and paged segment kernels at four)
    tc = {}
    for lib in ("flash_attention", "flash_attention_bwd", "segment_attention",
                "paged_segment_attention"):
        name = ""
        for line in _build.build_log(lib).splitlines():
            m = re.search(r"(flash_\w+_kernel_wgmma|segment_kernel_wgmma)"
                          r"ILi(\d+)E(?:Lb([01])E)?", line)
            if "Compiling entry" in line or "Function properties" in line:
                name = (f"{m.group(1)}<{m.group(2)}"
                        + {None: "", "0": ", flat", "1": ", paged"}[m.group(3)]
                        + ">") if m else ""
            elif name and ("spill" in line or "registers" in line):
                tc.setdefault(name, []).append(line.strip())
            elif "C7520" in line or "C7510" in line:
                say(f"[build] {lib}: {line.strip()}")
    for name, lines in tc.items():
        say(f"[build] tensor-core {name}: {'; '.join(lines)}")
    segs = [n for n in tc if n.startswith("segment")]
    if len(tc) != 17 or len(segs) != 8 or any(
            "0 bytes spill stores, 0 bytes spill loads" not in " ".join(v)
            for v in tc.values()):
        fail(f"the tensor-core kernels spill or are missing: {tc}")


def smem_parity() -> None:
    """The libraries' shared-memory sums against the wrappers' (each
    wrapper sizes or checks its launch with its own): dense decode over
    every dtype, head dim, group, tile and split length the planner can
    give, the RWKV-6 scan's one size and the RG-LRU scan's two."""
    f = _build.library("decode_attention").decode_attention_smem_bytes
    f.restype = ctypes.c_longlong
    bad = [(e, d, g, t, n) for e in (2, 4) for d in HEAD_DIMS
           for g in (1, 2, 3, 4, 5, 8, 9, 16, 17, 64)
           for t in dense_mod.KEY_TILES for n in (16, 64, 128, 256, 512)
           if f(e, d, g, t, n) != dense_mod.smem_bytes(e, d, g, t, n)]
    r = _build.library("rwkv6_scan").rwkv6_scan_smem_bytes
    r.restype = ctypes.c_int
    g = _build.library("rglru_scan").rglru_scan_smem_bytes
    g.restype = ctypes.c_int
    rg = {w: (g(w), rglru_mod.smem_bytes(w)) for w in rglru_mod.CHANNELS}
    say(f"[build] shared memory, library against wrapper: dense decode "
        f"{'equal' if not bad else bad[:4]}; rwkv6_scan {r()} against "
        f"{rwkv6_mod.smem_bytes()}; rglru_scan (channels): "
        + ", ".join(f"{k} {a} against {b}" for k, (a, b) in rg.items()))
    if (bad or r() != rwkv6_mod.smem_bytes()
            or any(a != b for a, b in rg.values())):
        fail("a library's shared memory differs from its wrapper's")


def compare(name, got, want, dtype, dead=None) -> float:
    """Kernel output vs the plain version computed in f32 from the same
    inputs (rounded to the kernel's dtype); dead lanes exactly zero."""
    tol = TOL[dtype]
    g, w = got.float(), want.to(dtype).float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    top = float(want.abs().max()) if want.numel() else 0.0
    ok = bool(torch.allclose(g, w, atol=tol, rtol=tol))
    zero = True
    if dead is not None and bool(dead.any()):
        zero = bool((got[dead] == 0).all())
    say(f"[kernels] {name} {str(dtype)[6:]}: max|err| {err:.3e} "
        f"({err / top if top else 0.0:.2e} of max|ref| {top:.3g}; "
        f"atol=rtol={tol:g}) {'ok' if ok else 'MISMATCH'}"
        + ("" if dead is None else f"; dead lanes zero: {zero}"))
    if not (ok and zero):
        fail(f"{name} {dtype} disagrees with its plain version")
    return err


def phase_kernels(dev) -> dict:
    gen = torch.Generator().manual_seed(0)
    lens = prompt_lens()
    seg_cases = {
        "main": dict(segs=main_segment_segs(), p=WIDTH, h=H, kv=KV, d=D,
                     t=T, b=SLOTS, m=M, holes=6),
        "mqa": dict(segs=[(0, 3, 40), (2, 70, 1), (1, 0, 9)], p=64, h=8,
                    kv=1, d=128, t=16, b=3, m=8, holes=2),
        "window": dict(segs=[(1, 100, 60), (0, 50, 1), (2, 20, 30)], p=96,
                       h=8, kv=2, d=128, t=16, b=3, m=12, holes=3,
                       window=40),
        "d16": dict(segs=[(0, 0, 20), (1, 33, 1)], p=24, h=4, kv=2, d=16,
                    t=8, b=2, m=8, holes=1),
        "d64": dict(segs=[(0, 5, 30), (1, 40, 1)], p=40, h=8, kv=4, d=64,
                    t=16, b=2, m=6),
        "d120": dict(segs=[(1, 3, 50), (0, 77, 1)], p=56, h=32, kv=8,
                     d=120, t=16, b=2, m=6, holes=1),
        "d256": dict(segs=[(1, 7, 25), (0, 60, 1)], p=32, h=8, kv=4, d=256,
                     t=16, b=2, m=6, holes=1),
        # decode riders of 7 slots beside a chunk's start share the first
        # q tiles (a work item each); 149 lanes leave a ragged last tile
        # and tiles of dead lanes; G 8, 12 (60 rows), 16 (MQA) and 1 (MHA)
        "riders7": dict(segs=RIDERS7, p=149, h=32, kv=4, d=128, t=16, b=8,
                        m=22, holes=6),
        "riders7-g12": dict(segs=RIDERS7, p=149, h=48, kv=4, d=128, t=16,
                            b=8, m=22, holes=6, window=37),
        "riders7-mqa": dict(segs=RIDERS7, p=149, h=16, kv=1, d=256, t=16,
                            b=8, m=22, holes=6),
        "riders7-mha": dict(segs=RIDERS7, p=149, h=4, kv=4, d=64, t=16, b=8,
                            m=22, holes=6, window=100),
        # block tokens: 32 and 8 on the tensor cores, 12 on the CUDA cores
        "t32": dict(segs=RIDERS7, p=149, h=32, kv=4, d=120, t=32, b=8, m=11,
                    holes=4, window=37),
        "t8": dict(segs=[(1, 200, 130), (0, 0, 70), (2, 400, 1)], p=256,
                   h=8, kv=4, d=256, t=8, b=3, m=75, holes=3, window=100),
        "t12": dict(segs=RIDERS7, p=149, h=32, kv=4, d=128, t=12, b=8, m=29,
                    holes=4),
        # phase 11's mixed tick: 4 slots of 4 blocks (cache_len 64), two
        # decode riders beside two chunks in a 64-lane stream
        "slo": dict(segs=SLO_SEGS, p=64, h=H, kv=KV, d=D, t=T,
                    b=SLO_MAX_BATCH, m=SLO_CACHE_LEN // T, holes=1),
        # phase 13's MoE archs on the slice's mixed tick: deepseek-moe-16b
        # (MHA 16/16, G 1) and llama4-maverick-400b-a17b (40/8, G 5)
        "deepseek": dict(segs=main_segment_segs(), p=WIDTH, h=16, kv=16,
                         d=D, t=T, b=SLOTS, m=M, holes=6),
        "maverick": dict(segs=main_segment_segs(), p=WIDTH, h=40, kv=8,
                         d=D, t=T, b=SLOTS, m=M, holes=6),
    }
    dec_cases = {
        "main": dict(q_pos=[int(n) + 16 for n in lens], h=H, kv=KV, d=D,
                     t=T, m=M, holes=6),
        "mqa": dict(q_pos=[5, 100, 37], h=8, kv=1, d=128, t=16, m=8,
                    holes=2, idle=1),
        "window": dict(q_pos=[150, 20, 90], h=8, kv=2, d=128, t=16, m=12,
                       holes=2, window=40, idle=2),
        "d16": dict(q_pos=[3, 40], h=4, kv=2, d=16, t=8, m=8),
        "d64": dict(q_pos=[30, 70], h=8, kv=4, d=64, t=16, m=6),
        "d120": dict(q_pos=[45, 90], h=32, kv=8, d=120, t=16, m=6,
                     holes=1),
        "d256": dict(q_pos=[11, 80], h=8, kv=4, d=256, t=16, m=6, holes=1),
        # live blocks across many key splits, across a split edge, in one
        "splits": dict(q_pos=[1000, 100, 130, 520, 20, 127], h=H, kv=KV,
                       d=D, t=T, m=64, holes=6, idle=2),
        "splits-window": dict(q_pos=[1000, 100, 130, 520, 20, 127], h=H,
                              kv=KV, d=D, t=T, m=64, holes=6, idle=2,
                              window=300),
        "splits-mqa": dict(q_pos=[2000, 700, 33], h=8, kv=1, d=128, t=16,
                           m=128, holes=4, idle=1, window=600),
        # phase 11's decode-only tick: 3 of its 4 slots running
        "slo": dict(q_pos=[40, 63, 17], h=H, kv=KV, d=D, t=T,
                    m=SLO_CACHE_LEN // T, holes=1, idle=1),
        # phase 13's decode ticks: G 1 (deepseek) and G 5 (maverick)
        "deepseek": dict(q_pos=[int(n) + 16 for n in lens], h=16, kv=16,
                         d=D, t=T, m=M, holes=6),
        "maverick": dict(q_pos=[int(n) + 16 for n in lens], h=40, kv=8,
                         d=D, t=T, m=M, holes=6),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = {"paged_segment_attention": 0.0, "paged_decode_attention": 0.0}
    segment_routes_agree()
    worst = {}
    for name, spec in seg_cases.items():
        spec = dict(spec)
        window = spec.pop("window", 0)
        case = segment_case(gen, **spec)
        for dtype in (torch.float32, torch.bfloat16):
            x = on(dev, case, dtype)
            route = paged_segment_route(dtype, spec["d"], spec["t"])
            got = paged_segment_attention(**x, window=window)
            torch.cuda.synchronize()
            want = paged_segment_attention_ref(
                **on(dev, on(dev, case, dtype), torch.float32),
                window=window)
            err = compare(f"paged_segment_attention/{name} [{route}]", got,
                          want, dtype, dead=x["q_seg"] < 0)
            rel = err / max(float(want.abs().max()), 1e-30)
            if rel >= worst.get(route, ("", 0.0))[1]:
                worst[route] = (f"{name} {str(dtype)[6:]}", rel)
            if name == "main" and dtype == torch.bfloat16:
                errs["paged_segment_attention"] = err
    say(f"[kernels] paged_segment_attention worst error by route, relative "
        f"to the largest reference value: {worst}")
    for name, spec in dec_cases.items():
        spec = dict(spec)
        window = spec.pop("window", 0)
        case = decode_case(gen, **spec)
        b, m = case["block_tables"].shape
        per, n_split = split_blocks(m, b * spec["kv"], sms)
        for dtype in (torch.float32, torch.bfloat16):
            x = on(dev, case, dtype)
            got = paged_decode_attention(**x, window=window)
            torch.cuda.synchronize()
            want = paged_decode_attention_ref(
                **on(dev, on(dev, case, dtype), torch.float32),
                window=window)
            err = compare(f"paged_decode_attention/{name} ({n_split} splits "
                          f"of {per} entries)", got, want, dtype,
                          dead=(x["block_tables"] < 0).all(dim=1))
            if name == "main" and dtype == torch.bfloat16:
                errs["paged_decode_attention"] = err
    paged_stale_entry_asserts()
    segment_stale_entry_asserts()
    errs["segment_attention"] = phase_kernels_flat(dev, gen)
    errs["decode_attention"] = phase_kernels_dense(dev, gen)
    errs["rglru_scan_state"] = phase_kernels_rglru(dev, gen)
    errs["rwkv6_scan_state"] = phase_kernels_rwkv6(dev)
    phase_kernels_spec(dev, gen)
    errs.update(phase_kernels_flash(dev))
    return errs


# phase 12's paged stream: decode segments of 2-9 lanes (slot 1's ends on
# a block's last key), slot 2's prefix-hit prefill starting mid-block in
# its copied boundary block, and slot 0's chunk; slots 0-2 share their
# first physical blocks (see spec_paged_case)
SPEC_PAGED_SEGS = [(3, 100, 9), (1, 44, 4), (4, 31, 2), (5, 200, 7),
                   (2, 40, 50), (6, 15, 3), (7, 70, 6), (0, 60, 5)]
# phase 12's flat stream at recurrentgemma's shapes: spec segments over
# rings widened by spec_depth_max (2056), three of them wrapped, one on
# the ring's edge, beside a prefill chunk over an earlier occupant's ring
SPEC_RING = RG_WINDOW + 8
SPEC_FLAT_SEGS = [(0, 3000, 9), (1, 2100, 5), (2, SPEC_RING, 4),
                  (3, 500, 1), (4, 0, 100), (5, 4000, 6)]


def spec_paged_case(gen, *, d, t):
    """:func:`segment_case` at yi-6b's heads with the tables a prefix
    cache makes: slots 0 and 1 share their first three physical blocks
    (an adopted prefix), slot 2 shares their first two and holds a copy
    of the third (the copy-on-write of a match that ends mid-block: slot
    2's segment starts at 40, inside it)."""
    case = segment_case(gen, segs=SPEC_PAGED_SEGS, p=128, h=H, kv=KV, d=d,
                        t=t, b=SLOTS, m=-(-240 // t))
    tab = case["block_tables"]
    tab[1, :3] = tab[0, :3]
    tab[2, :2] = tab[0, :2]
    for a in (case["k_store"], case["v_store"]):
        a[tab[2, 2]] = a[tab[0, 2]]
    return case


def phase_kernels_spec(dev, gen) -> None:
    """Phase 12's shapes (the prefix cache and speculation): the paged
    segment kernel on decode segments of 2-9 lanes, shared table rows and
    a copied boundary block, on both routes (bf16 at D 128 and T 16 on the
    tensor cores, f32 on the CUDA cores); the flat segment kernel at D
    256, MQA, over 2056-entry rings, wrapped, with a rejected draft's
    stale entries ahead of a segment; both scans at T = 1, their state
    threaded through nine launches against one launch of T = 9."""
    case = spec_paged_case(gen, d=D, t=T)
    for dtype in (torch.float32, torch.bfloat16):
        x = on(dev, case, dtype)
        route = paged_segment_route(dtype, D, T)
        before = paged_segment_attention.route_launches[route]
        got = paged_segment_attention(**x)
        torch.cuda.synchronize()
        if paged_segment_attention.route_launches[route] != before + 1:
            fail(f"the spec paged case did not take the {route} route")
        want = paged_segment_attention_ref(
            **on(dev, on(dev, case, dtype), torch.float32))
        compare(f"paged_segment_attention/spec segments, shared tables, a "
                f"copied block [{route}]", got, want, dtype,
                dead=x["q_seg"] < 0)
    case = flat_case(gen, segs=SPEC_FLAT_SEGS, p=160, h=RG_H, kv=RG_KV,
                     d=RG_D, b=6, ring=SPEC_RING, prev=(4,), ahead=(0, 5))
    for dtype in (torch.float32, torch.bfloat16):
        x = on(dev, case, dtype)
        got = segment_attention(**x, window=RG_WINDOW)
        torch.cuda.synchronize()
        want = segment_attention_ref(
            **on(dev, on(dev, case, dtype), torch.float32),
            window=RG_WINDOW)
        compare(f"segment_attention/spec segments over {SPEC_RING}-entry "
                f"rings [{segment_route(dtype, RG_D)}]", got, want, dtype,
                dead=x["q_seg"] < 0)
    # the scans at T = 1, as a spec row's column calls run them
    steps = 9
    x = on(dev, rglru_case(gen, RG_SLOTS, steps, RG_F), torch.float32)
    h, h_out = rglru_scan_state(**x)
    hs, st = [], x["h0"]
    for j in range(steps):
        hj, st = rglru_scan_state(x["log_a"][:, j:j + 1].contiguous(),
                                  x["b"][:, j:j + 1].contiguous(), st)
        hs.append(hj)
    torch.cuda.synchronize()
    same = torch.equal(torch.cat(hs, 1), h) and torch.equal(st, h_out)
    say(f"[kernels] rglru_scan_state/T = 1 x {steps} [{RG_SLOTS}, 1, "
        f"{RG_F}]: equal to one launch of T = {steps} bit for bit: {same}")
    if not same:
        fail("RG-LRU at T = 1 threaded through nine launches differs from "
             "one launch")
    compare("rglru_scan_state/T = 1 h_out", st, rglru_ref_state(**x)[1],
            torch.float32)
    x = rwkv6_case(torch.Generator(device=dev).manual_seed(12), RWKV_BH,
                   steps)
    y, s_out = rwkv6_scan_state(**x)
    ys, st = [], x["s0"]
    for j in range(steps):
        one = {n: (a[:, j:j + 1].contiguous()
                   if a.dim() == 3 and n != "s0" else a)
               for n, a in x.items()}
        yj, st = rwkv6_scan_state(**dict(one, s0=st))
        ys.append(yj)
    torch.cuda.synchronize()
    y1 = torch.cat(ys, 1)
    gap = max(float((y1 - y).abs().max()), float((st - s_out).abs().max()))
    say(f"[kernels] rwkv6_scan_state/T = 1 x {steps} [{RWKV_BH}, 1, "
        f"{RWKV_N}]: bit for bit with one launch of T = {steps}: "
        f"{torch.equal(y1, y) and torch.equal(st, s_out)}; max gap "
        f"{gap:.3e} (one launch runs steps in pairs, within a few ulps of "
        f"the step order)")
    compare("rwkv6_scan_state/T = 1 x 9 y against T = 9", y1, y,
            torch.float32)
    compare("rwkv6_scan_state/T = 1 x 9 s_out against T = 9", st, s_out,
            torch.float32)
    want_y, want_s = rwkv6_ref_state(**x)
    compare("rwkv6_scan_state/T = 1 x 9 y", y1, want_y, torch.float32)
    compare("rwkv6_scan_state/T = 1 x 9 s_out", st, want_s, torch.float32)
    torch.cuda.empty_cache()


STALE_PAGED = """
import sys, torch
sys.path.insert(0, "src")
from repro_torch.kernels.paged_attention import paged_decode_attention
dev, bf = torch.device("cuda", 0), torch.bfloat16
n, b, m = 600, 8, 64
tables = torch.arange(b * m, dtype=torch.int32).reshape(b, m)
tables[0, 1000 // 16] = n
paged_decode_attention(
    torch.randn(b, 32, 128).to(dev, bf), torch.randn(n, 4, 16, 128).to(dev, bf),
    torch.randn(n, 4, 16, 128).to(dev, bf), tables.to(dev),
    torch.tensor([1000] + [100] * (b - 1), dtype=torch.int32).to(dev))
torch.cuda.synchronize()
"""


STALE_SEGMENT = """
import sys, torch
sys.path.insert(0, "src")
from repro_torch.kernels.segment_attention import paged_segment_attention
dev, bf = torch.device("cuda", 0), torch.bfloat16
n, b, m = 200, 8, 22
tables = torch.arange(b * m, dtype=torch.int32).reshape(b, m)
q_seg = torch.full((64,), -1, dtype=torch.int32)
q_seg[:8] = torch.arange(8)
{edit}
paged_segment_attention(
    torch.randn(64, 32, 128).to(dev, bf), torch.randn(n, 4, 16, 128).to(dev, bf),
    torch.randn(n, 4, 16, 128).to(dev, bf), tables.to(dev),
    torch.full((64,), 300, dtype=torch.int32).to(dev), q_seg.to(dev))
torch.cuda.synchronize()
"""


def asserts_in_child(src: str, what: str) -> None:
    """Run ``src`` in a child process, since a device-side assert ends its
    CUDA context, and fail unless it stopped on one."""
    run = subprocess.run([sys.executable, "-c", src], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    out = run.stdout + run.stderr
    ok = run.returncode != 0 and "device-side assert" in out
    say(f"[kernels] {what}: child exit {run.returncode}, device-side assert "
        f"{'seen' if ok else 'NOT seen'}")
    if not ok:
        fail(f"{what}: no device-side assert: {out[-2000:]}")


def segment_stale_entry_asserts() -> None:
    """A table entry past the store in the walk of one of a tile's decode
    riders, and a segment past the tables, stop the tensor-core paged
    segment kernel (bf16, D 128, T 16) on a device-side assert, where the
    plain version raises IndexError."""
    for what, edit in (("stale entry", "tables[5, 300 // 16] = n"),
                       ("segment past the tables", "q_seg[3] = b")):
        asserts_in_child(STALE_SEGMENT.format(edit=edit),
                         f"paged_segment_attention [tensor_core]/{what}")


def segment_routes_agree() -> None:
    """Each segment library's own route rule, held to the wrapper's."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in HEAD_DIMS:
            if library_segment_route(dtype, d) != segment_route(dtype, d):
                fail(f"flat segment routes disagree at {dtype} D {d}")
            for t in (1, 4, 8, 12, 16, 32, 64):
                if (library_paged_segment_route(dtype, d, t)
                        != paged_segment_route(dtype, d, t)):
                    fail(f"paged segment routes disagree at {dtype} D {d} "
                         f"T {t}")
    say("[kernels] segment route rules: each library's agrees with its "
        "wrapper's (tensor cores: bf16 at D 64, 120, 128, 256; paged also "
        "T 8, 16, 32, 64)")


def paged_stale_entry_asserts() -> None:
    """A table entry past the store in the last live block of a long row
    (read by a later key split's CTA) stops the paged decode kernel on a
    device-side assert, where the plain version raises IndexError."""
    asserts_in_child(STALE_PAGED,
                     "paged_decode_attention/stale entry in a later split")


def phase_kernels_flat(dev, gen) -> float:
    """Flat segment attention: recurrentgemma's main shapes, a small
    window, and every head dim with MHA, GQA and MQA; ragged segments,
    wrapped and stale rings, dead lanes."""
    small = dict(segs=[(0, 10, 17), (1, 40, 1), (2, 0, 6)], p=32, b=3,
                 ring=24, prev=(2,))
    cases = {"main": dict(segs=main_flat_segs(), p=RG_WIDTH, h=RG_H,
                          kv=RG_KV, d=RG_D, b=RG_SLOTS, ring=RG_WINDOW,
                          prev=(4,), window=RG_WINDOW),
             "window9": dict(segs=[(0, 30, 20), (1, 50, 1), (2, 0, 9)],
                             p=40, h=8, kv=2, d=128, b=3, ring=16, prev=(2,),
                             window=9)}
    for d in HEAD_DIMS:
        for h, kv, what in ((4, 4, "mha"), (8, 2, "gqa"), (8, 1, "mqa")):
            cases[f"d{d}-{what}"] = dict(small, h=h, kv=kv, d=d,
                                         window=9 if what == "gqa" else 0)
    # decode riders of 7 slots (0 and 1 wrapped) beside a chunk over a
    # stale ring and a mid-prompt chunk; 96-entry rings, so 64-key tiles
    # straddle two slots; G 16 (MQA), 12 (60 rows) and 80 (two head chunks)
    riders = dict(segs=[(0, 150, 1), (1, 201, 1), (2, 40, 1), (3, 95, 1),
                        (4, 7, 1), (5, 60, 1), (6, 1, 1), (7, 0, 50),
                        (5, 61, 30)], p=149, b=8, ring=96, prev=(7,))
    cases["riders7-mqa"] = dict(riders, h=16, kv=1, d=256, window=37)
    cases["riders7-g12"] = dict(riders, h=48, kv=4, d=120, window=0)
    cases["riders7-g80"] = dict(riders, h=80, kv=1, d=64, window=96)
    main_err = 0.0
    worst = {}
    for name, spec in cases.items():
        spec = dict(spec)
        window = spec.pop("window")
        case = flat_case(gen, **spec)
        for dtype in (torch.float32, torch.bfloat16):
            x = on(dev, case, dtype)
            route = segment_route(dtype, spec["d"])
            got = segment_attention(**x, window=window)
            torch.cuda.synchronize()
            want = segment_attention_ref(
                **on(dev, on(dev, case, dtype), torch.float32),
                window=window)
            err = compare(f"segment_attention/{name} [{route}]", got, want,
                          dtype, dead=x["q_seg"] < 0)
            rel = err / max(float(want.abs().max()), 1e-30)
            if rel >= worst.get(route, ("", 0.0))[1]:
                worst[route] = (f"{name} {str(dtype)[6:]}", rel)
            if name == "main" and dtype == torch.bfloat16:
                main_err = err
            del got, want
        torch.cuda.empty_cache()
    say(f"[kernels] segment_attention worst error by route, relative to the "
        f"largest reference value: {worst}")
    return main_err


def dense_cases() -> dict:
    """name -> (case builder, kwargs, window): yi-6b's legacy decode rings
    full and at the slice's prompts, recurrentgemma's swa rings wrapped
    and with idle rows, the reference's sweep (windows 0 and 256, GQA,
    MQA, MHA), an all-empty cache, every head dim with MHA, GQA and MQA
    at S below one split, above it and not a multiple of it, and the
    edges of the kernel's tiles, key parts and head chunks."""
    lens, rg = prompt_lens(), rg_prompt_lens()
    cases = {
        "main": (dense_case, dict(q_pos=[CACHE_LEN - 1] * SLOTS, h=H, kv=KV,
                                  d=D, s=CACHE_LEN), 0),
        "yi-prompts": (dense_case, dict(q_pos=[int(n) + 16 for n in lens],
                                        h=H, kv=KV, d=D, s=CACHE_LEN), 0),
        "rg-wrapped": (dense_case, dict(
            q_pos=[RG_WINDOW - 1 + int(n) for n in rg], h=RG_H, kv=RG_KV,
            d=RG_D, s=RG_WINDOW), RG_WINDOW),
        "rg-idle": (dense_case, dict(q_pos=[int(n) + 5 for n in rg[:6]],
                                     h=RG_H, kv=RG_KV, d=RG_D, s=RG_WINDOW,
                                     idle=2), RG_WINDOW),
        "empty": (dense_case, dict(q_pos=[], h=4, kv=2, d=64, s=128,
                                   idle=2), 0),
    }
    for b, h, kv, s, d, w in ((2, 8, 2, 512, 64, 0), (1, 4, 1, 1024, 128, 256),
                              (2, 4, 4, 384, 64, 0)):
        cases[f"sweep-{b}x{h}/{kv}-S{s}-D{d}-w{w}"] = (
            sweep_dense_case, dict(b=b, h=h, kv=kv, s=s, d=d), w)
    for i, d in enumerate(HEAD_DIMS):
        for j, (h, kv, what) in enumerate(((4, 4, "mha"), (8, 2, "gqa"),
                                           (16, 1, "mqa"))):
            s = (31, 300, 2049)[(i + j) % 3]
            cases[f"d{d}-{what}-S{s}"] = (dense_case, dict(
                q_pos=[5, s + 40, s // 2], h=h, kv=kv, d=d, s=s, idle=1),
                9 if what == "gqa" else 0)
    # the kernel's edges: S off a 64-key tile at every
    # head dim with G 1, 8 and 16, G 3 (idle warps), G 20 (a second head
    # chunk of 4), G 64 (four head chunks), windows that end inside a tile,
    # rings wrapped many times over, and rows whose keys all lie ahead
    for i, d in enumerate(HEAD_DIMS):
        for j, (h, kv) in enumerate(((4, 4), (16, 2), (16, 1))):
            s = (97, 2047, 2049)[(i + j) % 3]
            cases[f"edge-d{d}-G{h // kv}-S{s}"] = (dense_case, dict(
                q_pos=[s + 300, s // 2, 3 * s - 1], h=h, kv=kv, d=d, s=s,
                idle=1), 0)
    for h, kv, d, s in ((6, 2, 64, 2047), (40, 2, 128, 2049),
                        (64, 1, 128, 2049), (64, 1, 256, 97)):
        cases[f"heads-G{h // kv}-d{d}-S{s}"] = (dense_case, dict(
            q_pos=[s - 1, s + 40, 5], h=h, kv=kv, d=d, s=s, idle=1), 0)
    for w in (100, 1000):
        cases[f"window-{w}-S2047"] = (dense_case, dict(
            q_pos=[2046, 5000, 70, 2047], h=H, kv=KV, d=D, s=2047, idle=1), w)
    cases["wrapped-many"] = (dense_case, dict(
        q_pos=[RG_WINDOW - 1 + 911 * r for r in range(RG_SLOTS)], h=RG_H,
        kv=RG_KV, d=RG_D, s=RG_WINDOW), RG_WINDOW)
    cases["keys-ahead"] = (dense_case, dict(q_pos=[300, 40], h=8, kv=2, d=64,
                                            s=130, ahead=2), 0)
    # phase 14's decode shapes: whisper-tiny's cross-attention over its
    # 1500 frames, internvl2-1b's G 7 rings at the end of its requests
    cases["whisper-cross"] = (cross_dense_case, dict(
        b=FRONT_SLOTS, h=WH_H, kv=WH_H, d=WH_D, s=WH_ENC), 0)
    cases["internvl2-self"] = (dense_case, dict(
        q_pos=[IV_PATCHES + int(n) + FRONT_NEW - 1
               for n in front_prompt_lens()], h=IV_H, kv=IV_KV, d=IV_D,
        s=FRONT_CACHE_LEN), 0)
    return cases


# dense_cases() entries at the shapes the main paths give the kernel
MAIN_DENSE = ("main", "whisper-cross", "internvl2-self")


def phase_kernels_dense(dev, gen) -> float:
    """Dense decode attention against its plain version computed in f32
    from the same inputs; rows no key admits exactly zero.  Returns the
    largest bf16 error over the main paths' shapes (:data:`MAIN_DENSE`)."""
    main_err = 0.0
    for name, (make, spec, window) in dense_cases().items():
        case = make(gen, **spec)
        for dtype in (torch.float32, torch.bfloat16):
            x = dense_args(on(dev, case, dtype))
            got = decode_attention(**x, window=window)
            torch.cuda.synchronize()
            want = decode_attention_plain(
                **dense_args(on(dev, on(dev, case, dtype), torch.float32)),
                window=window)
            live = decode_mask(x["k_pos"], x["q_pos"], window).any(dim=1)
            err = compare(f"decode_attention/{name}", got, want, dtype,
                          dead=~live)
            if name in MAIN_DENSE and dtype == torch.bfloat16:
                main_err = max(main_err, err)
            del x, got, want
        torch.cuda.empty_cache()
    return main_err


def phase_kernels_rglru(dev, gen) -> float:
    """The RG-LRU scan from a nonzero state against its plain version, h
    and h_out: S around its 32-step stage and up to the main [8, 4096,
    4096], 1, 3 and 8 rows (both CTA widths), F 64 and 33 (off the CTA
    width, and rows that lose 16-byte alignment), then every instance (CTA
    width, copy width) with a full and a part-filled last CTA, reached
    through B, F and inputs 1 float into their buffers (only 4-byte
    aligned), each checked to take the instance it is meant to; then pad
    steps (log_a = b = 0) that must pass h through bit for bit in every
    instance, and two launches split at step 45 (off a stage edge),
    threading h_out, that must give one launch's outputs bit for bit."""
    main_err = 0.0
    edge = rglru_mod.STEPS
    cases = [(f"S{s}", RG_SLOTS, s, RG_F, 0, None)
             for s in (1, 7, edge - 1, edge, edge + 1, 129)]
    cases += [("B1", 1, RG_WIDTH, RG_F, 0, None),
              ("B3", 3, 300, RG_F, 0, None),
              ("F64", 3, 129, 64, 0, None), ("F33", 3, 129, 33, 0, None)]
    # (channels, copy bytes) on 132 SMs: 64 from 264 CTAs of 64 on
    cases += [("instance", b, 77, f, off, want) for b, f, off, want in (
        (RG_SLOTS, RG_F, 0, (64, 16)), (5, 4100, 0, (64, 16)),
        (RG_SLOTS, RG_F, 1, (64, 4)), (5, 4098, 0, (64, 4)),
        (2, RG_F, 0, (32, 16)), (3, 100, 0, (32, 16)),
        (3, RG_F, 1, (32, 4)), (3, 33, 0, (32, 4)))]
    cases += [("main", RG_SLOTS, RG_WIDTH, RG_F, 0, None)]
    ran = set()
    for name, b, s, f, off, want in cases:
        x = on(dev, rglru_case(gen, b, s, f), torch.float32)
        if off:
            x["log_a"], x["b"] = (offset_view(x[n], off)
                                  for n in ("log_a", "b"))
        used = rglru_mod.launch_plan(x["log_a"], x["b"])
        if want and used != want:
            fail(f"RG-LRU [{b}, {s}, {f}] at offset {off} takes {used}, not "
                 f"{want}")
        ran.add(used)
        h, h_out = rglru_scan_state(**x)
        torch.cuda.synchronize()
        want_h, want_out = rglru_ref_state(**x)
        tag = (f"rglru_scan_state/{name} [{b}, {s}, {f}]"
               + (f" {off} float in" if off else "")
               + f" ({used[0]} channels, {used[1]}-byte copies)")
        err = max(compare(f"{tag} h", h, want_h, torch.float32),
                  compare(f"{tag} h_out", h_out, want_out, torch.float32))
        if name == "main":
            main_err = err
        del x, h, h_out, want_h, want_out
    if len(ran) != 4:
        fail(f"the RG-LRU cases ran {sorted(ran)}, not all four instances")
    # pad steps from the start and across a stage edge, each instance
    for b, f in ((RG_SLOTS, RG_F), (5, 4098), (3, 300), (3, 33)):
        x = on(dev, rglru_case(gen, b, 300, f), torch.float32)
        for lo, hi in ((0, 10), (20, 70)):
            x["log_a"][:, lo:hi] = 0
            x["b"][:, lo:hi] = 0
        used = rglru_mod.launch_plan(x["log_a"], x["b"])
        h, h_out = rglru_scan_state(**x)
        torch.cuda.synchronize()
        same = (torch.equal(h[:, :10], x["h0"][:, None].expand(-1, 10, -1))
                and torch.equal(h[:, 20:70],
                                h[:, 19:20].expand(-1, 50, -1)))
        say(f"[kernels] rglru_scan_state/pad steps [{b}, 300, {f}] {used}: "
            f"h passed through bit for bit: {same}")
        if not same:
            fail("RG-LRU pad steps do not pass h through bit for bit")
        want_h, want_out = rglru_ref_state(**x)
        compare("rglru_scan_state/pad steps h", h, want_h, torch.float32)
    # two launches threading the state against one
    x = on(dev, rglru_case(gen, RG_SLOTS, 300, RG_F), torch.float32)
    cut = 45
    h, h_out = rglru_scan_state(**x)
    h1, s1 = rglru_scan_state(x["log_a"][:, :cut].contiguous(),
                              x["b"][:, :cut].contiguous(), x["h0"])
    h2, s2 = rglru_scan_state(x["log_a"][:, cut:].contiguous(),
                              x["b"][:, cut:].contiguous(), s1)
    torch.cuda.synchronize()
    same = torch.equal(torch.cat([h1, h2], 1), h) and torch.equal(s2, h_out)
    say(f"[kernels] rglru_scan_state/split at {cut}: equal to one launch "
        f"bit for bit: {same}")
    if not same:
        fail("RG-LRU state threaded across two launches differs from one")
    torch.cuda.empty_cache()
    return main_err


def phase_kernels_rwkv6(dev) -> float:
    """The RWKV-6 scan against its plain version, y and s_out, from a
    random non-symmetric s0 with a random u: odd lengths and the 16-step
    stage's edges (15, 16, 17, 33), strong decays, neutral pad steps, one
    and three rows, the main [512, 4096, 64], inputs only 8-byte aligned
    (the kernel's 8-byte copies); then two launches split at step 147 (off
    a stage edge), threading s_out, against one."""
    gen = torch.Generator(device=dev).manual_seed(3)
    main_err = 0.0
    for name, bh, s, decay in (
            ("S1", RWKV_BH, 1, "model"), ("S7", RWKV_BH, 7, "model"),
            ("S15", RWKV_BH, 15, "model"), ("S16", RWKV_BH, 16, "model"),
            ("S17", RWKV_BH, 17, "strong"), ("S33", RWKV_BH, 33, "pads"),
            ("S129", RWKV_BH, 129, "model"),
            ("strong", RWKV_BH, 129, "strong"),
            ("pads", RWKV_BH, 129, "pads"), ("BH1", 1, 300, "model"),
            ("BH3", 3, RWKV_WIDTH, "strong"),
            ("main", RWKV_BH, RWKV_WIDTH, "model")):
        x = rwkv6_case(gen, bh, s, decay)
        y, s_out = rwkv6_scan_state(**x)
        torch.cuda.synchronize()
        want_y, want_s = rwkv6_ref_state(**x)
        err = max(compare(f"rwkv6_scan_state/{name} [{bh}, {s}, "
                          f"{RWKV_N}] y", y, want_y, torch.float32),
                  compare(f"rwkv6_scan_state/{name} s_out", s_out, want_s,
                          torch.float32))
        if name == "main":
            main_err = err
        del x, y, s_out, want_y, want_s
    # streams 8 but not 16 bytes aligned: views 2 floats into a buffer
    x = rwkv6_case(gen, 3, 300, "pads")
    for n in ("r", "k", "v", "logw"):
        buf = torch.empty(x[n].numel() + 2, device=dev)
        x[n] = buf[2:].view_as(x[n]).copy_(x[n])
    if rwkv6_mod.copy_bytes(x["r"], x["k"], x["v"], x["logw"]) != 8:
        fail("the unaligned RWKV-6 case does not take 8-byte copies")
    y, s_out = rwkv6_scan_state(**x)
    torch.cuda.synchronize()
    want_y, want_s = rwkv6_ref_state(**x)
    compare("rwkv6_scan_state/8-byte copies y", y, want_y, torch.float32)
    compare("rwkv6_scan_state/8-byte copies s_out", s_out, want_s,
            torch.float32)
    x = rwkv6_case(gen, RWKV_BH, 300)
    cut = 147
    y, s_out = rwkv6_scan_state(**x)
    head = {n: (a[:, :cut].contiguous() if a.dim() == 3 and n != "s0"
                else a) for n, a in x.items()}
    tail = {n: (a[:, cut:].contiguous() if a.dim() == 3 and n != "s0"
                else a) for n, a in x.items()}
    y1, s1 = rwkv6_scan_state(**head)
    y2, s2 = rwkv6_scan_state(**dict(tail, s0=s1))
    torch.cuda.synchronize()
    compare(f"rwkv6_scan_state/split at {cut} y", torch.cat([y1, y2], 1), y,
            torch.float32)
    compare(f"rwkv6_scan_state/split at {cut} s_out", s2, s_out,
            torch.float32)
    want_y, want_s = rwkv6_ref_state(**x)
    name = f"rwkv6_scan_state/[{RWKV_BH}, 300, {RWKV_N}]"
    compare(f"{name} y", y, want_y, torch.float32)
    compare(f"{name} s_out", s_out, want_s, torch.float32)
    torch.cuda.empty_cache()
    return main_err


def flash_case(gen, b, h, kv, s, d, sk=None):
    """q [B,H,S,D], k, v [B,Kv,Sk,D] (Sk = S unless given) and a random dO,
    N(0, 1), on ``gen``'s device."""
    dev = gen.device
    sk = s if sk is None else sk
    return dict(q=torch.randn(b, h, s, d, generator=gen, device=dev),
                k=torch.randn(b, kv, sk, d, generator=gen, device=dev),
                v=torch.randn(b, kv, sk, d, generator=gen, device=dev),
                do=torch.randn(b, h, s, d, generator=gen, device=dev))


# flash_cases() entries at the shapes the main paths give the kernels
MAIN_FLASH = ("main", "rg", "whisper-cross-77", "whisper-cross-448",
              "whisper-encoder", "internvl2-self")


def flash_cases() -> dict:
    """name -> (B, H, Kv, Sq, Sk, D, causal, window): the main paths'
    shapes (yi-6b's training; recurrentgemma-9b's training and legacy
    prefill: 16 query heads on one KV head, D 256, window 2048; phase
    14's frontends: whisper-tiny's cross-attention, 6 heads of 64 over
    its 1500 frames from 77 and 448 queries, its encoder's non-causal
    1500 frames, internvl2-1b's 14/2 heads over 256 patches and 200
    tokens, causal), gemma3's local layers (window 1024) and, at every
    head dim, MHA, GQA (32/4) and MQA at S = 1, 63, 130 under causal,
    windowed (32) and non-causal masks (with and without a window)."""
    cases = {"main": (FA_B, H, KV, FA_S, FA_S, D, True, 0),
             "rg": (FA_B, RG_H, RG_KV, FA_S, FA_S, RG_D, True, RG_WINDOW),
             "gemma3-local": (1, 8, 4, FA_S, FA_S, 256, True, 1024)}
    for sq in (77, 448):
        cases[f"whisper-cross-{sq}"] = (2, WH_H, WH_H, sq, WH_ENC, WH_D,
                                        False, 0)
    cases["whisper-encoder"] = (2, WH_H, WH_H, WH_ENC, WH_ENC, WH_D, False,
                                0)
    cases["internvl2-self"] = (2, IV_H, IV_KV, IV_PATCHES + 200,
                               IV_PATCHES + 200, IV_D, True, 0)
    masks = [(True, 0), (True, 32), (False, 0), (False, 32)]
    for i, d in enumerate(HEAD_DIMS):
        for j, (h, kv, what) in enumerate(((4, 4, "mha"), (32, 4, "gqa"),
                                           (8, 1, "mqa"))):
            s = (1, 63, 130)[(i + j) % 3]
            causal, window = masks[(i + 2 * j) % 4]
            cases[f"d{d}-{what}-S{s}-{'c' if causal else 'nc'}-w{window}"] = \
                (2, h, kv, s, s, d, causal, window)
    # keys of another length than the queries at every head dim, both
    # routes: q tiles and key tiles ragged on either side
    for i, d in enumerate(HEAD_DIMS):
        sq, sk = ((65, 130), (130, 63), (1, 200))[i % 3]
        cases[f"d{d}-cross-Sq{sq}-Sk{sk}"] = (2, 8, 2, sq, sk, d, False, 0)
    return cases


def phase_kernels_flash(dev) -> dict:
    """The flash forward (o without and with lse) and the dQ and dK/dV
    kernels against the plain versions computed in f32 from the same
    inputs; the backward kernels take the forward kernel's o and lse and a
    random dO, as the plain backward does.  Returns each kernel's largest
    bf16 error over the main paths' shapes (:data:`MAIN_FLASH`)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    for what, rule, library in (("forward", fwd_route, library_fwd_route),
                                ("backward", bwd_route, library_bwd_route)):
        rules = {(str(dt)[6:], d): (rule(dt, d), library(dt, d))
                 for dt in (torch.float32, torch.bfloat16)
                 for d in HEAD_DIMS}
        say(f"[kernels] {what} route by (dtype, D), wrapper and library: "
            f"{rules}")
        if any(a != b for a, b in rules.values()):
            fail(f"the CUDA library's {what} route differs from "
                 f"{rule.__name__}")
    errs = {}
    for name, (b, h, kv, s, sk, d, causal, window) in flash_cases().items():
        case = flash_case(gen, b, h, kv, s, d, sk)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (case[n].to(dtype) for n in ("q", "k", "v", "do"))
            mask = dict(causal=causal, window=window)
            o_only = flash_attention(q, k, v, **mask)
            o, lse = flash_attention_fwd_lse(q, k, v, **mask)
            dsum = (do.float() * o.float()).sum(-1)
            dq = flash_attention_dq(q, k, v, do, lse, dsum, **mask)
            dk, dv = flash_attention_dkv(q, k, v, do, lse, dsum, **mask)
            torch.cuda.synchronize()
            f32 = [t.float() for t in (q, k, v, o, do)]
            want_o, want_lse = attention_lse_ref(*f32[:3], **mask)
            tag = (f"flash/{name} [{b}, {h}/{kv}, "
                   f"{s if sk == s else f'{s} x {sk}'}, {d}]")
            fwd = f"{tag} {fwd_route(dtype, d)}"
            e = {"flash_attention": compare(f"{fwd} o", o_only, want_o,
                                            dtype),
                 "flash_attention_fwd_lse": max(
                     compare(f"{fwd} o (with lse)", o, want_o, dtype),
                     compare(f"{fwd} lse", lse, want_lse, torch.float32))}
            del want_o, want_lse
            want = attention_bwd_ref(*f32[:4], lse, f32[4], **mask)
            tag = f"{tag} {bwd_route(dtype, d)}"
            e["flash_attention_dq"] = compare(f"{tag} dq", dq, want[0], dtype)
            e["flash_attention_dkv"] = max(
                compare(f"{tag} dk", dk, want[1], dtype),
                compare(f"{tag} dv", dv, want[2], dtype))
            if name in MAIN_FLASH and dtype == torch.bfloat16:
                errs = {k: max(errs.get(k, 0.0), x) for k, x in e.items()}
            del want, f32, o_only, o, lse, dq, dk, dv
            torch.cuda.empty_cache()
    return errs


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, bound_ms: float, iters: int = 20) -> dict:
    """Device time per call by kernel, from torch.profiler over ``iters``
    calls after one warm-up: what a kernel takes on the card, apart from
    the host's enqueue cost, which CUDA events over back-to-back calls of
    a short kernel also see.  A profile that caught no device event, or
    less time than the call's bound ``bound_ms`` (it happens now and then
    when profiles follow each other closely), is taken again, up to three
    times; empty (not measured) if none caught the whole call."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        out: dict[str, float] = {}
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                m = re.search(r"(\w+_kernel)", e.name)
                name = m.group(1) if m else e.name
                out[name] = (out.get(name, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / iters)
        if out and sum(out.values()) >= bound_ms:
            return out
        say(f"[timing] a profile caught {sum(out.values()):.4f} ms a call "
            f"against a {bound_ms:.4f} ms bound: taken again")
    return {}


def _live_blocks(tables, slot, hi_pos, lo_pos, window):
    j_lo = max(0, lo_pos - window + 1) // T if window else 0
    j_hi = min(hi_pos // T, tables.shape[1] - 1)
    row = tables[slot, j_lo:j_hi + 1]
    return int((row >= 0).sum())


def segment_bound(x, window=0):
    """Least time for this call's work: bytes (q, out, the live K/V blocks
    of every slot in the stream up to its horizon, tables, tags) against
    flops (4*D per admitted (query head, key) pair), bf16 peaks.  Only the
    q of lanes that admit a key counts: a dead lane, or a lane no key
    admits, gives zeros whatever its q holds."""
    tabs = x["block_tables"].cpu()
    qp, qs = x["q_pos"].cpu(), x["q_seg"].cpu()
    p, h, d = x["q"].shape
    kv, t = x["k_store"].shape[1], x["k_store"].shape[2]
    esz = x["q"].element_size()
    nbytes = p * h * d * esz + tabs.numel() * 4 + 2 * p * 4
    flops = 0
    for s in torch.unique(qs[qs >= 0]).tolist():
        pos = qp[qs == s]
        nb = _live_blocks(tabs, s, int(pos.max()), int(pos.min()), window)
        nbytes += nb * 2 * kv * t * d * esz
        ok = (tabs[s] >= 0).repeat_interleave(t)          # [M*T]
        kpos = torch.arange(ok.numel())
        adm = ok[None, :] & (kpos[None, :] <= pos[:, None])
        if window:
            adm &= (pos[:, None] - kpos[None, :]) < window
        flops += int(adm.sum()) * h * 4 * d
        nbytes += int(adm.any(dim=1).sum()) * h * d * esz
    peak = PEAK_BF16_FLOPS if x["q"].dtype == torch.bfloat16 \
        else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops)


def segment_work(x, b, walk) -> dict:
    """A tensor-core segment kernel's work at this call, from the same
    inputs: the work items the shapes allow (tiles x KV heads x items per
    tile), the live ones (a q tile's live segments, per KV head and head
    chunk), the 64-key stages they walk (``walk(seg, lo, hi)`` for an item
    whose queries sit at positions lo..hi), the longest item's stages, and
    the tensor-core flops those stages issue."""
    p, h, d = x["q"].shape
    kv = x["k_store" if b else "k"].shape[1]
    qp, qs = x["q_pos"].cpu().tolist(), x["q_seg"].cpu().tolist()
    bq, n_tiles, chunks, s_max = segment_grid(p, h, kv, b)
    stages = []
    for tile in range(n_tiles):
        tok = qs[tile * bq:(tile + 1) * bq]
        for seg in tile_items(tok)[0]:
            pos = [qp[tile * bq + i] for i, sg in enumerate(tok) if sg == seg]
            stages.append(walk(seg, min(pos), max(pos)))
    per = kv * chunks
    return dict(bound=(n_tiles, per, s_max), items=len(stages) * per, d=d,
                stages=sum(stages) * per, longest=max(stages, default=0),
                issued=sum(stages) * per * 64 * 64 * 4 * d)


def paged_work(x, window=0) -> dict:
    """segment_work for the paged kernel: an item walks the live blocks of
    its table row from its earliest query's window start to its latest
    query, 64 / T blocks a stage."""
    tabs = x["block_tables"].cpu()
    t = x["k_store"].shape[2]

    def walk(seg, lo, hi):
        j_lo = max(0, lo - window + 1) // t if window > 0 else 0
        live = int((tabs[seg, j_lo:min(hi // t, tabs.shape[1] - 1) + 1]
                    >= 0).sum())
        return -(-live // (64 // t))
    return segment_work(x, tabs.shape[0], walk)


def flat_work(x, window=0) -> dict:
    """segment_work for the flat kernel: an item walks the 64-key tiles
    that hold a written key of its segment inside [its earliest query's
    window start, its latest query], as its producer decides."""
    n = x["k"].shape[0]
    n_kt = -(-n // 64)
    pad = torch.full((n_kt * 64 - n,), -1, dtype=torch.int32)
    kp = torch.cat([x["k_pos"].cpu(), pad])
    ks = torch.cat([x["k_seg"].cpu(), pad])

    def walk(seg, lo, hi):
        near = (ks == seg) & (kp >= 0) & (kp <= hi)
        if window > 0:
            near &= (lo - kp) < window
        return int(near.reshape(n_kt, 64).any(dim=1).sum())
    return segment_work(x, None, walk)


def work_line(name, route, work, flops, ms, sms) -> str:
    """One segment row's work, for phase 4's output: the persistent grid
    is as many CTAs as the card holds at once (two a SM at D <= 128, one
    at D 256), at most one per possible item."""
    bound = math.prod(work["bound"])
    ctas = min(bound, sms * (2 if work["d"] <= 128 else 1))
    return (f"[timing] {name}: route {route}; {bound} possible work items "
            f"(tiles x KV heads x items a tile: {work['bound']}), "
            f"{work['items']} live, taken by a persistent grid of {ctas} "
            f"CTAs; {work['stages']} 64-key stages, the longest item "
            f"{work['longest']}; admitted {flops / 1e9:.2f} GFLOP = "
            f"{flops / ms / 1e9:.1f} TFLOP/s, tensor-core products issued "
            f"{work['issued'] / 1e9:.2f} GFLOP = "
            f"{work['issued'] / ms / 1e9:.1f} TFLOP/s")


def decode_bound(x, window=0):
    """As segment_bound, one query token per row; only the q of rows that
    admit a key counts."""
    tabs, qp = x["block_tables"].cpu(), x["q_pos"].cpu()
    b, h, d = x["q"].shape
    kv, t = x["k_store"].shape[1], x["k_store"].shape[2]
    esz = x["q"].element_size()
    nbytes = b * h * d * esz + tabs.numel() * 4 + b * 4
    flops = 0
    for r in range(b):
        q = int(qp[r])
        nb = _live_blocks(tabs, r, q, q, window)
        nbytes += nb * 2 * kv * t * d * esz
        ok = (tabs[r] >= 0).repeat_interleave(t)
        kpos = torch.arange(ok.numel())
        adm = ok & (kpos <= q)
        if window:
            adm &= (q - kpos) < window
        flops += int(adm.sum()) * h * 4 * d
        nbytes += h * d * esz if bool(adm.any()) else 0
    peak = PEAK_BF16_FLOPS if x["q"].dtype == torch.bfloat16 \
        else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_timing(dev, card) -> dict:
    """Kernel vs plain version vs one library call, same bf16 inputs."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(1)
    out = {}
    x = on(dev, segment_case(gen, segs=main_segment_segs(), p=WIDTH, h=H,
                             kv=KV, d=D, t=T, b=SLOTS, m=M),
           torch.bfloat16)
    k, v, k_pos = paged_gather(x["k_store"], x["v_store"],   # [B,Kv,MT,D]
                                x["block_tables"])
    b, kvh, mt, d = k.shape
    g = H // kvh
    # the library call gets every query head's K/V view laid out for it
    kf = k.permute(1, 0, 2, 3).reshape(1, kvh, b * mt, d) \
        .repeat_interleave(g, dim=1)
    vf = v.permute(1, 0, 2, 3).reshape(1, kvh, b * mt, d) \
        .repeat_interleave(g, dim=1)
    kseg = torch.arange(b, device=dev).repeat_interleave(mt)
    kp = k_pos.reshape(-1)
    qp, qs = x["q_pos"], x["q_seg"]
    mask = ((kseg[None, :] == qs[:, None]) & (qs[:, None] >= 0)
            & (kp[None, :] >= 0) & (kp[None, :] <= qp[:, None]))
    qt = x["q"].transpose(0, 1)[None]                 # [1, H, P, D]
    bound, by, flops = segment_bound(x)
    shapes = "bf16 at yi-6b main-path shapes"
    r = out["paged_segment_attention"] = dict(
        ms=time_ms(lambda: paged_segment_attention(**x)),
        plain_ms=time_ms(lambda: paged_segment_attention_ref(**x), iters=3,
                         warmup=1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kf, vf, attn_mask=mask[None, None])),
        library_note="sdpa, boolean mask", bound_ms=bound, bound_by=by,
        shapes=shapes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    say(work_line("paged segment at yi-6b's mixed tick",
                  paged_segment_route(torch.bfloat16, D, T), paged_work(x),
                  flops, r["ms"], sms))
    x = on(dev, decode_case(gen, q_pos=[int(n) + 16 for n in prompt_lens()],
                            h=H, kv=KV, d=D, t=T, m=M), torch.bfloat16)
    k, v, k_pos = paged_gather(x["k_store"], x["v_store"],   # [B,Kv,MT,D]
                                x["block_tables"])
    k = k.repeat_interleave(H // k.shape[1], dim=1)
    v = v.repeat_interleave(H // v.shape[1], dim=1)
    mask = (k_pos >= 0) & (k_pos <= x["q_pos"][:, None])
    qd = x["q"][:, :, None, :]                       # [B, H, 1, D]
    bound, by = decode_bound(x)
    rows = x["q"].shape[0]
    per, n_split = split_blocks(M, rows * KV, sms)
    say(f"[timing] paged decode at bf16 D {D}, {rows} rows x {KV} KV heads, "
        f"a {M}-entry table: {n_split} key splits of {per} entries, "
        f"{n_split * KV * rows} split CTAs for {sms} SMs "
        f"({n_split * KV * rows / sms:.2f} per SM), then a combine kernel of "
        f"{H * rows} CTAs")
    out["paged_decode_attention"] = dict(
        ms=time_ms(lambda: paged_decode_attention(**x)),
        device_ms=device_ms(lambda: paged_decode_attention(**x), bound),
        plain_ms=time_ms(lambda: paged_decode_attention_ref(**x)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qd, k, v, attn_mask=mask[:, None, None, :])),
        library_note="sdpa, boolean mask", bound_ms=bound, bound_by=by,
        shapes=shapes)
    del k, v, kf, vf, mask, x
    out["segment_attention"] = timing_flat(dev, gen)
    out["decode_attention"], out["decode_attention (rg swa)"] = \
        timing_dense(dev, gen)
    out["rglru_scan_state"] = timing_rglru(dev, gen, card)
    out["rwkv6_scan_state"] = timing_rwkv6(dev)
    torch.cuda.empty_cache()
    out.update(timing_flash(dev))
    torch.cuda.empty_cache()
    # recurrentgemma-9b's swa layers in training: D 256 takes the
    # CUDA-core kernels
    out.update(timing_flash(dev, (FA_B, RG_H, RG_KV, FA_S, RG_D, RG_WINDOW),
                            "recurrentgemma-9b training"))
    torch.cuda.empty_cache()
    # phase 14's frontends at their training shapes (batch 2): whisper-
    # tiny's cross-attention (128 decoder tokens against 1500 frames) and
    # encoder (1500 frames, no mask), internvl2-1b's 256 patches + 256
    # tokens (causal, G 7); then their decode shapes
    wh_seq = FRONT_TRAIN_SEQ["whisper-tiny"]
    out.update(timing_flash(
        dev, (FRONT_TRAIN_BATCH, WH_H, WH_H, wh_seq, WH_D, 0),
        "whisper-tiny cross", sk=WH_ENC, causal=False))
    out.update(timing_flash(
        dev, (FRONT_TRAIN_BATCH, WH_H, WH_H, WH_ENC, WH_D, 0),
        "whisper-tiny encoder", causal=False))
    out.update(timing_flash(
        dev, (FRONT_TRAIN_BATCH, IV_H, IV_KV, FRONT_TRAIN_SEQ["internvl2-1b"],
              IV_D, 0), "internvl2-1b training"))
    out["decode_attention (whisper cross)"], \
        out["decode_attention (internvl2-1b)"] = timing_dense(dev, gen, True)
    torch.cuda.empty_cache()
    for name, r in out.items():
        lib = ("null (" + r["library_note"] + ")" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms ({r['library_note']})")
        say(f"[timing] {name} {r['shapes']} on {card}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        if "device_ms" in r and not r["device_ms"]:
            say(f"[timing] {name}: device time not measured (no profile "
                f"caught the whole call)")
        elif "device_ms" in r:
            say(f"[timing] {name}: device ms per call by kernel (profiler) "
                + ", ".join(f"{k} {v:.4f}" for k, v in r["device_ms"].items())
                + f"; together {sum(r['device_ms'].values()):.4f} against "
                f"{r['ms']:.4f} ms by events over back-to-back calls")
    return out


def flat_bound(x, window=0):
    """Least time for this call's work: bytes (the q of lanes that admit a
    key, the whole output, each admitted key's K and V once, the tags)
    against flops (4*D per admitted (query head, key) pair), at the bf16
    peak for bf16 inputs."""
    qp, qs, kp, ks = x["q_pos"], x["q_seg"], x["k_pos"], x["k_seg"]
    p, h, d = x["q"].shape
    n, kv, _ = x["k"].shape
    esz = x["q"].element_size()
    adm = ((ks[None, :] == qs[:, None]) & (qs[:, None] >= 0)
           & (kp[None, :] >= 0) & (kp[None, :] <= qp[:, None]))
    if window:
        adm &= (qp[:, None] - kp[None, :]) < window
    nbytes = (int(adm.any(dim=1).sum()) * h * d * esz + p * h * d * esz
              + int(adm.any(dim=0).sum()) * 2 * kv * d * esz
              + (2 * p + 2 * n) * 4)
    flops = int(adm.sum()) * h * 4 * d
    del adm
    peak = PEAK_BF16_FLOPS if x["q"].dtype == torch.bfloat16 \
        else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops)


def timing_flat(dev, gen) -> dict:
    """Flat segment attention at recurrentgemma's mixed-tick shapes, bf16:
    8 slots x 2048-entry rings plus a 4096-lane stream."""
    import torch.nn.functional as F
    x = on(dev, flat_case(gen, segs=main_flat_segs(), p=RG_WIDTH, h=RG_H,
                          kv=RG_KV, d=RG_D, b=RG_SLOTS, ring=RG_WINDOW,
                          prev=(4,)), torch.bfloat16)
    w = RG_WINDOW
    qp, qs, kp, ks = x["q_pos"], x["q_seg"], x["k_pos"], x["k_seg"]
    mask = ((ks[None, :] == qs[:, None]) & (qs[:, None] >= 0)
            & (kp[None, :] >= 0) & (kp[None, :] <= qp[:, None])
            & ((qp[:, None] - kp[None, :]) < w))
    # the library call gets every query head's K/V laid out for it
    kf = x["k"].transpose(0, 1)[None].repeat_interleave(RG_H // RG_KV, dim=1)
    vf = x["v"].transpose(0, 1)[None].repeat_interleave(RG_H // RG_KV, dim=1)
    qt = x["q"].transpose(0, 1)[None]                 # [1, H, P, D]
    bound, by, flops = flat_bound(x, w)
    r = dict(ms=time_ms(lambda: segment_attention(**x, window=w)),
             plain_ms=time_ms(lambda: segment_attention_ref(**x, window=w),
                              iters=2, warmup=1),
             library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                 qt, kf, vf, attn_mask=mask[None, None]), iters=5, warmup=1),
             library_note="sdpa, boolean mask", bound_ms=bound, bound_by=by,
             shapes=f"bf16 H{RG_H}/Kv{RG_KV}/D{RG_D}, {RG_SLOTS} x "
                    f"{RG_WINDOW} ring keys + {RG_WIDTH} lanes")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    say(work_line("flat segment at recurrentgemma-9b's mixed tick",
                  segment_route(torch.bfloat16, RG_D), flat_work(x, w),
                  flops, r["ms"], sms))
    return r


def dense_bound(x, window=0):
    """Least time for this call's work: bytes (the q of rows that admit a
    key, the whole output, each admitted key's K and V rows once, k_pos,
    q_pos) against flops (4*D per admitted (query head, key) pair), at the
    peak for the input dtype."""
    adm = decode_mask(x["k_pos"], x["q_pos"], window)          # [B, S]
    b, h, d = x["q"].shape
    kv = x["k"].shape[1]
    esz = x["q"].element_size()
    n_adm = int(adm.sum())
    nbytes = (int(adm.any(dim=1).sum()) * h * d * esz + b * h * d * esz
              + n_adm * 2 * kv * d * esz + adm.numel() * 4 + b * 4)
    flops = n_adm * h * 4 * d
    peak = PEAK_BF16_FLOPS if x["q"].dtype == torch.bfloat16 \
        else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def timing_dense(dev, gen, frontends: bool = False) -> list[dict]:
    """Dense decode attention, bf16, on full rings read in place: yi-6b's
    legacy decode (B 8, H 32, Kv 4, D 128, S 2048, no window) and
    recurrentgemma's swa rings (B 8, H 16, Kv 1, D 256, 2048 entries,
    wrapped, window 2048); with ``frontends`` phase 14's shapes instead:
    whisper-tiny's cross-attention decode (B 8, H = Kv 6, D 64, its 1500
    frames, all at position 0) and internvl2-1b's rings (B 8, H 14, Kv 2,
    D 64, 1024 entries, each row at the end of its request).  The library
    call is SDPA on [B, H, 1, S] with the boolean mask and
    ``enable_gqa``, on contiguous copies of the rings."""
    import torch.nn.functional as F
    shapes = {
        "yi": (dense_case, dict(q_pos=[CACHE_LEN - 1] * SLOTS, h=H, kv=KV,
                                d=D, s=CACHE_LEN), 0,
               f"bf16 B{SLOTS} H{H}/Kv{KV} D{D} S{CACHE_LEN} (yi-6b legacy "
               "decode, full rings)"),
        "rg": (dense_case, dict(
            q_pos=[RG_WINDOW - 1 + int(n) for n in rg_prompt_lens()],
            h=RG_H, kv=RG_KV, d=RG_D, s=RG_WINDOW), RG_WINDOW,
               f"bf16 B{RG_SLOTS} H{RG_H}/Kv{RG_KV} D{RG_D} ring {RG_WINDOW} "
               f"window {RG_WINDOW} (recurrentgemma swa, wrapped)")}
    if frontends:
        cases = dense_cases()
        shapes = {
            "whisper": (*cases["whisper-cross"],
                        f"bf16 B{FRONT_SLOTS} H{WH_H}/Kv{WH_H} D{WH_D} "
                        f"S{WH_ENC} (whisper-tiny cross decode, every frame)"),
            "internvl2": (*cases["internvl2-self"],
                          f"bf16 B{FRONT_SLOTS} H{IV_H}/Kv{IV_KV} D{IV_D} "
                          f"S{FRONT_CACHE_LEN} (internvl2-1b decode, rows at "
                          "their requests' ends)")}
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for make, spec, window, note in shapes.values():
        x = dense_args(on(dev, make(gen, **spec), torch.bfloat16))
        b, h, d = x["q"].shape
        plan = dense_mod.launch_plan(b, h, x["k"].shape[1], x["k"].shape[2],
                                     d, 2, sms)
        say(f"[timing] dense decode at {note}: {plan['n_split']} key splits "
            f"of {plan['split']} slots, {plan['ctas']} split CTAs of "
            f"{dense_mod.WARPS} warps for {sms} SMs ({plan['per_sm']} a SM "
            f"by shared memory, {plan['smem']} bytes), a {plan['stages']}-"
            f"stage ring of {plan['tile']}-key tiles, {plan['head_chunks']} "
            f"head chunk(s); then a combine of {h * b} CTAs")
        mask = decode_mask(x["k_pos"], x["q_pos"], window)[:, None, None, :]
        k, v = x["k"].contiguous(), x["v"].contiguous()
        qd = x["q"][:, :, None, :]                        # [B, H, 1, D]
        bound, by = dense_bound(x, window)
        rows.append(dict(
            ms=time_ms(lambda: decode_attention(**x, window=window)),
            device_ms=device_ms(lambda: decode_attention(**x,
                                                         window=window),
                                bound),
            plain_ms=time_ms(lambda: decode_attention_plain(
                **x, window=window)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qd, k, v, attn_mask=mask, enable_gqa=True)),
            library_note="sdpa, boolean mask, enable_gqa", bound_ms=bound,
            bound_by=by, shapes=note))
        del x, k, v, mask
    return rows


def rglru_timed(x, fn, label, card) -> dict:
    """One RG-LRU scan call's time by events and by the profiler, its
    bound, achieved GB/s and share of the bound, printed."""
    b, s, f = x["b"].shape
    nbytes = (3 * b * s * f + 2 * b * f) * 4     # log_a, b in; h out; h0, h_out
    ops = 3 * b * s * f                          # exp, multiply, add
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS
    bound = max(t_bytes, t_ops) * 1e3
    r = dict(ms=time_ms(lambda: fn(**x)),
             device_ms=device_ms(lambda: fn(**x), bound, iters=5),
             bound_ms=bound,
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             shapes=f"f32 [{b}, {s}, {f}]")
    dev_ms = sum(r["device_ms"].values())
    by_dev = (f"{dev_ms:.4f} ms device", f"{nbytes / dev_ms / 1e6:.1f} GB/s",
              f"{100 * r['bound_ms'] / dev_ms:.1f}%") if dev_ms else (
        "device time not measured (no profile caught the whole call)", "-",
        "-")
    say(f"[timing] rglru_scan_state {label} {r['shapes']} on {card}: "
        f"{r['ms']:.4f} ms by events, {by_dev[0]}; "
        f"{nbytes / 1e9:.4f} GB at {nbytes / r['ms'] / 1e6:.1f} GB/s by "
        f"events, {by_dev[1]} by device time; "
        f"{100 * r['bound_ms'] / r['ms']:.1f}% of the {r['bound_ms']:.4f} ms "
        f"{r['bound_by']} bound by events, {by_dev[2]} by device time")
    return r


def timing_rglru(dev, gen, card) -> dict:
    """The RG-LRU scan at [8, 4096, 4096] f32 (a full-width mixed tick's
    recurrent rows), then at [1, 4096, 4096] (one slot's whole prompt),
    each with the (channels, copy bytes) the wrapper plans.  No PyTorch
    call computes this recurrence, so there is no library time."""
    x = on(dev, rglru_case(gen, RG_SLOTS, RG_WIDTH, RG_F), torch.float32)
    plan = rglru_mod.launch_plan(x["log_a"], x["b"])
    r = rglru_timed(x, rglru_scan_state, f"main, planned {plan}", card)
    r.update(plain_ms=time_ms(lambda: rglru_ref_state(**x), iters=1,
                              warmup=1),
             library_ms=None,
             library_note="no PyTorch call computes the recurrence")
    del x
    x = on(dev, rglru_case(gen, 1, RG_WIDTH, RG_F), torch.float32)
    plan = rglru_mod.launch_plan(x["log_a"], x["b"])
    rglru_timed(x, rglru_scan_state, f"one slot's prompt, planned {plan}",
                card)
    return r


def timing_rwkv6(dev) -> dict:
    """The RWKV-6 scan at [512, 4096, 64] f32 (a full-width mixed tick's
    rows: 8 slots x 64 heads, 4096 steps).  No PyTorch call computes this
    recurrence, so there is no library time."""
    x = rwkv6_case(torch.Generator(device=dev).manual_seed(4), RWKV_BH,
                   RWKV_WIDTH)
    bh, s, n = x["r"].shape
    # r, k, v, logw in and y out; u; s0 in and s_out out
    nbytes = (5 * bh * s * n + bh * n + 2 * bh * n * n) * 4
    # per (row, step): 2 N^2 for r . S, 3 N^2 for S <- w S + k v^T, 3 N for
    # sum r u k, 2 N to add it times v to y, N exps
    ops = bh * s * (5 * n * n + 6 * n)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS
    bound = max(t_bytes, t_ops) * 1e3
    r = dict(ms=time_ms(lambda: rwkv6_scan_state(**x)),
             device_ms=device_ms(lambda: rwkv6_scan_state(**x), bound,
                                 iters=5),
             plain_ms=time_ms(lambda: rwkv6_ref_state(**x), iters=2,
                              warmup=1),
             library_ms=None,
             library_note="no PyTorch call computes the recurrence",
             bound_ms=bound,
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             shapes=f"f32 [{bh}, {s}, {n}] ({nbytes / 1e9:.3f} GB, "
                    f"{ops / 1e9:.1f} GFLOP)")
    dev_ms = sum(r["device_ms"].values())
    say(f"[timing] rwkv6_scan_state: {bh} rows of {rwkv6_mod.THREADS} "
        f"threads, {rwkv6_mod.STAGES} stages of {rwkv6_mod.CHUNK} steps "
        f"({rwkv6_mod.smem_bytes()} bytes a CTA); {nbytes / 1e9:.3f} GB in "
        f"{r['ms']:.4f} ms = {nbytes / r['ms'] / 1e6:.1f} GB/s by events, "
        + (f"{nbytes / dev_ms / 1e6:.1f} GB/s" if dev_ms else "not measured")
        + f" by device time ({100 * r['bound_ms'] / r['ms']:.1f}% of the "
        "byte bound)")
    del x
    return r


def flash_pairs(s: int, causal: bool, window: int, sk=None) -> int:
    """Admitted (query, key) pairs of one head: what the kernels' work and
    so their bound depends on.  Keys of another length ``sk`` come
    without a mask: every pair."""
    if sk is not None and sk != s:
        return s * sk
    q = np.arange(s)
    hi = q if causal else np.full(s, s - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(s, int)
    return int((hi - lo + 1).sum())


# matrix products per admitted pair and head dim, in units of 2 D flops:
# the forward QK^T and PV; dQ recomputes QK^T and dO V^T, then dS K; dK/dV
# recomputes both, then P^T dO and dS^T Q
FLASH_PRODUCTS = {"flash_attention": 2, "flash_attention_fwd_lse": 2,
                  "flash_attention_dq": 3, "flash_attention_dkv": 4}


def flash_bound(kernel, b, h, kv, s, d, causal, window, dtype, sk=None):
    """Least time for one kernel's call: its bytes (each input read once,
    each output written once) at 3.35 TB/s against its matrix products
    over the admitted pairs at the peak for the input dtype; ``sk`` keys
    (``s`` unless given) a head."""
    esz = torch.tensor([], dtype=dtype).element_size()
    sk = s if sk is None else sk
    q_b, kv_b, row_b = b * h * s * d * esz, b * kv * sk * d * esz, b * h * s * 4
    nbytes = {"flash_attention": 2 * q_b + 2 * kv_b,
              "flash_attention_fwd_lse": 2 * q_b + 2 * kv_b + row_b,
              "flash_attention_dq": 3 * q_b + 2 * kv_b + 2 * row_b,
              "flash_attention_dkv": 2 * q_b + 4 * kv_b + 2 * row_b}[kernel]
    ops = FLASH_PRODUCTS[kernel] * 2 * d * b * h * flash_pairs(s, causal,
                                                                window, sk)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", ops)


def timing_flash(dev, shape=None, what="yi-6b training", sk=None,
                 causal=True) -> dict:
    """The three flash kernels at a training shape (bf16): yi-6b's (B, H,
    Kv, S, D, window) by default, causal, beside the plain versions (the
    plain backward computes dq, dk and dv together, so both backward rows
    carry its time) and SDPA: its forward for the two forward rows, its
    autograd backward (dQ, dK and dV together) for the two backward rows;
    with a window SDPA takes the causal window as a boolean mask.  With
    ``sk`` the keys have that length (cross-attention, no mask); with
    ``causal`` False there is no mask.  The rows are keyed by kernel name,
    with `` (what)`` after it when a shape is given."""
    import torch.nn.functional as F
    b, h, kv, s, d, window = shape or (FA_B, H, KV, FA_S, D, 0)
    sk = s if sk is None else sk
    x = {n: t.to(torch.bfloat16) for n, t in flash_case(
        torch.Generator(device=dev).manual_seed(6), b, h, kv, s,
        d, sk).items()}
    q, k, v, do = x["q"], x["k"], x["v"], x["do"]
    mask = dict(causal=causal, window=window)
    o, lse = flash_attention_fwd_lse(q, k, v, **mask)
    dsum = (do.float() * o.float()).sum(-1)
    if not causal:
        sdpa_mask = {}
        fwd_note = "sdpa(no mask, enable_gqa=True)"
    elif window:
        t = torch.arange(s, device=dev)
        sdpa_mask = dict(attn_mask=(t[None, :] <= t[:, None])
                         & (t[:, None] - t[None, :] < window))
        fwd_note = f"sdpa(causal window {window} as a boolean mask, " \
                   "enable_gqa=True)"
    else:
        sdpa_mask = dict(is_causal=True)
        fwd_note = "sdpa(is_causal=True, enable_gqa=True)"
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_o = F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True,
                                           **sdpa_mask)
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **sdpa_mask))
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        lib_o, (qg, kg, vg), do, retain_graph=True))
    plain_bwd = time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do,
                                                  **mask),
                        iters=2, warmup=1)
    shapes = (f"bf16 B{b} H{h}/Kv{kv} "
              f"{f'Sq{s} Sk{sk}' if sk != s else f'S{s}'} D{d} "
              f"{'causal' if causal else 'non-causal'}"
              f"{f' window {window}' if window else ''} ({what})")
    bwd_note = "sdpa's autograd backward: dQ, dK and dV together"
    runs = {
        "flash_attention": (lambda: flash_attention(q, k, v, **mask),
                            lambda: attention_ref(q, k, v, **mask),
                            sdpa_fwd, fwd_note),
        "flash_attention_fwd_lse": (
            lambda: flash_attention_fwd_lse(q, k, v, **mask),
            lambda: attention_lse_ref(q, k, v, **mask), sdpa_fwd, fwd_note),
        "flash_attention_dq": (
            lambda: flash_attention_dq(q, k, v, do, lse, dsum, **mask), None,
            sdpa_bwd, bwd_note),
        "flash_attention_dkv": (
            lambda: flash_attention_dkv(q, k, v, do, lse, dsum, **mask),
            None, sdpa_bwd, bwd_note)}
    route = bwd_route(torch.bfloat16, d)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_kt, n_qt = -(-sk // 64), -(-s // 64)
    if route == "tensor_core":
        say(f"[timing] flash forward at bf16 D {d}: route "
            f"{fwd_route(torch.bfloat16, d)}; one CTA (a consumer warpgroup "
            f"and a producer warp) per 64 q rows x query head x batch, the "
            f"longest first: {n_qt * h * b} CTAs for {sms} SMs, two per SM; "
            "64-key tiles in a two-stage TMA ring, P in registers")
        say(f"[timing] flash backward at bf16 D {d}: route {route}; dK/dV "
            f"one CTA (a consumer warpgroup and a producer warp) per 64 keys "
            f"x KV head x batch, key tile 0 first: "
            f"{n_kt * kv * b} CTAs here, {n_kt * kv} at a training "
            f"microbatch (batch 1), for {sms} SMs, one CTA per SM; dQ one "
            f"CTA per 64 q rows x query head x batch, the longest first: "
            f"{n_qt * h * b} CTAs, two per SM; 64-key (dQ) and 64-row "
            "(dK/dV) steps in a two-stage TMA ring")
    else:
        say(f"[timing] flash at bf16 D {d} ({what}): forward route "
            f"{fwd_route(torch.bfloat16, d)}, backward route {route}")
    out = {}
    suffix = f" ({what})" if shape else ""
    for name, (kern, plain, lib_ms, note) in runs.items():
        bound, by, ops = flash_bound(name, b, h, kv, s, d, causal, window,
                                     torch.bfloat16, sk)
        ms = time_ms(kern, iters=10, warmup=2)
        via = (f", route "
               f"{route if plain is None else fwd_route(torch.bfloat16, d)}")
        out[name + suffix] = dict(
            ms=ms, bound_ms=bound, bound_by=by, library_ms=lib_ms,
            library_note=note,
            plain_ms=(plain_bwd if plain is None
                      else time_ms(plain, iters=2, warmup=1)),
            shapes=f"{shapes}{via}, {ops / 1e9:.1f} GFLOP = "
                   f"{ops / ms / 1e9:.1f} TFLOP/s")
    fwd_ops = flash_bound("flash_attention", b, h, kv, s, d, causal, window,
                          torch.bfloat16, sk)[2]
    dq, dkv = (out[n + suffix] for n in ("flash_attention_dq",
                                         "flash_attention_dkv"))
    say(f"[timing] flash backward ({route}, {what}): dQ + dK/dV kernels "
        f"{dq['ms'] + dkv['ms']:.4f} ms against sdpa's backward "
        f"{sdpa_bwd:.4f} ms; bound of the two kernels' products (3.5x the "
        f"forward's) {dq['bound_ms'] + dkv['bound_ms']:.4f} ms, FA2 joint "
        f"minimum (2.5x) {2.5 * fwd_ops / PEAK_BF16_FLOPS * 1e3:.4f} ms")
    del qg, kg, vg, lib_o
    return out


def phase_parity(dev, card, cfg, host, dense: bool = True,
                 grad_rows: int = 2, routes: dict | None = None):
    """Full-width ``cfg`` (a 2-layer f32 cut), TF32 off, card vs CPU,
    beside the card against itself with every weight multiplied in f32 by
    1 + 1e-7 N(0, 1), a perturbation at the level of f32 rounding (the
    noise floor of this random-weight model): the packed path on paged KV
    (two ticks, then a paged decode step: logits and block stores); with
    ``dense``, the split path's one-shot ``prefill`` and two dense
    ``decode_step`` calls (the flash forward and the dense decode kernels
    on the card: logits and rings); then one ``loss_fn`` with gradients
    at batch ``grad_rows`` x 130 (the flash forward and backward
    kernels).  ``host``: ``cfg``'s weights on the host
    (:func:`host_weights`).  With ``routes`` (a dict), every ``moe_apply``
    call of the card, noise-floor and CPU runs is recorded there
    (:func:`recording`): ``routes["serve"]`` and ``routes["train"]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = f"{cfg.name} {cfg.num_layers} layers f32"
    params = tree_map(lambda t: t.to(dev), host)
    b, t, cache = 4, 16, 256
    m = cache // t
    tables = np.random.default_rng(0).permutation(b * m).astype(
        np.int32).reshape(b, m)
    # tick 1: prefill chunks of all four slots; tick 2: slots 1 and 3
    # decode, slots 0 and 2 prefill further
    ticks = [[(0, 0, 40), (1, 0, 17), (2, 0, 64), (3, 0, 3)],
             [(0, 40, 24), (1, 17, 1), (2, 64, 30), (3, 3, 1)]]

    def run(p, d):
        caches = zoo.init_paged_cache(cfg, b * m, t, d)
        bt = torch.from_numpy(tables).to(d)
        rng = np.random.default_rng(1)
        logits = [zoo.step_packed(cfg, p, caches, *(
            torch.from_numpy(a).to(d) for a in packed_arrays(
                rng, cfg.vocab_size, segs, 128, b)), bt) for segs in ticks]
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, b)
                               .astype(np.int32)).to(d)
        dpos = torch.tensor([64, 18, 94, 4], dtype=torch.int32, device=d)
        logits.append(zoo.decode_step(cfg, p, caches, tok, dpos, bt))
        return ([lg.cpu() for lg in logits],
                [caches["groups"][0][k].cpu() for k in ("k", "v")])

    def run_dense(p, d):
        rng = np.random.default_rng(4)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 70))
                                  .astype(np.int32)).to(d)
        logits, caches = zoo.prefill(cfg, p, {"tokens": tokens},
                                     cache_len=cache)
        out = [logits]
        # the second step leaves row 1 out
        for step, act in ((0, None), (1, [True, False, True])):
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, 3)
                                   .astype(np.int32)).to(d)
            pos = torch.full((3,), 70 + step, dtype=torch.int32, device=d)
            act = None if act is None else torch.tensor(act, device=d)
            lg = zoo.decode_step(cfg, p, caches, tok, pos, active=act)
            out.append(lg if act is None else lg[act])
        return ([lg.cpu() for lg in out],
                [caches["groups"][0][k].cpu() for k in ("k", "v")])

    grad = grad_run(cfg, train_batch(cfg.vocab_size, 130, rows=grad_rows))
    runs = (run, *([run_dense] if dense else []), grad)
    if routes is not None:
        runs = (recording(run, routes.setdefault("serve", [])),
                *runs[1:-1], recording(grad, routes.setdefault("train", [])))
    (got, cpu, floor), *dense, train = card_cpu_floor(
        dev, params, host, name, *runs)
    train += (card_gnorm_floors(dev, params, grad),)
    del params, host
    worst = 0.0
    for i, (lc, lg, ln) in enumerate(zip(cpu[0], got[0], floor[0])):
        err = rel(lc, lg)
        worst = max(worst, err)
        say(f"[parity] {name}, step {i + 1} "
            f"({'step_packed' if i < 2 else 'decode_step'}): max|dlogit| / "
            f"max|logit| = {err:.3e} (limit {LOGIT_LIMIT:g}; noise floor "
            f"{rel(lg, ln):.3e}) on {card}")
    # relative, as for the logits: the stores of this random-weight model
    # reach |K| ~ 1e2, where f32 rounding alone is ~1e-5 of that
    kerr = max(rel(a, b) for a, b in zip(cpu[1], got[1]))
    kfloor = max(rel(a, b) for a, b in zip(got[1], floor[1]))
    say(f"[parity] {name}, block stores after the three steps: max|err| / "
        f"max|x| = {kerr:.3e} (limit {STORE_LIMIT:g}; noise floor "
        f"{kfloor:.3e}); max|K| {float(cpu[1][0].abs().max()):.1f}")
    for got, cpu, floor in dense:
        steps = ("prefill", "decode_step", "decode_step, one row left out")
        for step, lc, lg, ln in zip(steps, cpu[0], got[0], floor[0]):
            err = rel(lc, lg)
            worst = max(worst, err)
            say(f"[parity] {name}, dense {step}: max|dlogit| / max|logit| = "
                f"{err:.3e} (limit {LOGIT_LIMIT:g}; noise floor "
                f"{rel(lg, ln):.3e}) on {card}")
        derr = max(rel(a, b) for a, b in zip(cpu[1], got[1]))
        kerr = max(kerr, derr)
        say(f"[parity] {name}, dense rings after prefill and two steps: "
            f"max|err| / max|x| = {derr:.3e} (limit {STORE_LIMIT:g}; "
            f"noise floor "
            f"{max(rel(a, b) for a, b in zip(got[1], floor[1])):.3e})")
    if not worst <= LOGIT_LIMIT or not kerr <= STORE_LIMIT:
        fail(f"card and CPU disagree on {cfg.name} logits or KV caches")
    if not train_parity_ok(card, cfg, *train):
        fail(f"card and CPU disagree on {cfg.name}'s training loss or "
             "gradients")


def phase_parity_moe(dev, card, drawn):
    """Phase 5's MoE cut: deepseek-moe-16b at full width, 2 layers (its
    dense first layer, d_ff 10944, and one MoE layer: 64 routed experts
    of 1408, top-6, two shared), 1.09 B parameters, f32, through
    :func:`phase_parity` (packed steps on paged KV and a paged decode
    step; the training loss with its load-balancing aux and every gradient
    leaf, on one row), at the configured capacity 1.25 (drops happen);
    then the router's choices card against CPU (:func:`routes_agree`).  A
    flip is printed with its margin, not failed: the logits and gradients
    that follow from it are held to their limits."""
    cfg, host = drawn.result()
    n_par = sum(t.numel() for t in tree_leaves(host))
    say(f"[parity] {cfg.name}: {cfg.num_layers} layers "
        f"{cfg.first_k_dense} dense + {cfg.block_pattern}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads, {cfg.num_experts} experts top-"
        f"{cfg.top_k}, {cfg.num_shared_experts} shared, capacity factor "
        f"{cfg.capacity_factor}; {n_par / 1e9:.3f} B parameters")
    routes: dict = {}
    phase_parity(dev, card, cfg, host, False, 1, routes=routes)
    del host
    routes_agree(card, cfg, routes)


def front_batch(cfg, tokens: int, rows: int, kind: str, seed: int,
                device) -> dict:
    """``zoo.make_batch`` for ``rows`` x ``tokens`` prompt tokens (after
    internvl2-1b's patch positions), from numpy seed ``seed``."""
    npatch = cfg.num_patches if cfg.frontend == "vision" else 0
    return zoo.make_batch(cfg, ShapeConfig("front", npatch + tokens, rows,
                                           kind),
                          np.random.default_rng(seed), device)


def phase_parity_frontends(dev, card, drawn: dict):
    """Phase 5's frontend cuts, full width in f32, card against CPU beside
    the noise floor: internvl2-1b (2 layers; 14/2 heads, G 7, its 256
    random patches through the connector) and whisper-tiny (2 decoder and
    2 encoder layers, random ``pos_emb``, cross-attention over 1500 random
    frames): a one-shot prefill of 3 prompts of 70 tokens and five dense
    decode steps (the last with row 1 left out), logits and rings (and
    ``enc_out``); then a training loss with every gradient leaf (the
    connector's and the cross-attention's among them), internvl2-1b on
    one row of 130 tokens (its 151655-token vocabulary sets the CPU's
    time), whisper-tiny on two.  Each reading's limit is phase 5's fixed
    one or FRONT_FLOOR_TIMES its own noise floor, the larger: whisper's
    random weights (wq's fan-in is its 6 heads, so its scores spread
    wide and its attention is nearly one-hot) move its logits by up to
    2e-3 and its gradient leaves by up to 2.3e-2 under an f32-rounding
    nudge, above the fixed limits set from the text archs' floors."""
    for arch in FRONT_ARCHS:
        cfg, host = drawn.pop(arch).result()
        name = f"{cfg.name} {cfg.num_layers} layers f32"
        n_par = sum(t.numel() for t in tree_leaves(host))
        say(f"[parity] {cfg.name}: {cfg.num_layers} layers"
            + (f" + {cfg.enc_layers} encoder layers over {cfg.enc_seq} "
               "frames" if cfg.encoder_decoder else
               f" after {cfg.num_patches} patches of {cfg.frontend_dim}")
            + f", {cfg.num_heads}/{cfg.num_kv_heads} heads of "
            f"{cfg.resolved_head_dim}, norm {cfg.norm}, mlp {cfg.mlp}, vocab "
            f"{cfg.vocab_size}; {n_par / 1e9:.3f} B parameters")
        params = tree_map(lambda t: t.to(dev), host)
        p0 = (cfg.num_patches if cfg.frontend == "vision" else 0) + 70

        def run(p, d):
            batch = front_batch(cfg, 70, 3, "prefill", 4, d)
            logits, caches = zoo.prefill(cfg, p, batch, cache_len=512)
            out = [logits]
            rng = np.random.default_rng(5)
            for step in range(5):
                tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, 3)
                                       .astype(np.int32)).to(d)
                pos = torch.full((3,), p0 + step, dtype=torch.int32,
                                 device=d)
                act = (None if step < 4 else
                       torch.tensor([True, False, True], device=d))
                lg = zoo.decode_step(cfg, p, caches, tok, pos, active=act)
                out.append(lg if act is None else lg[act])
            kept = [caches["groups"][0][k] for k in ("k", "v")]
            if "enc_out" in caches:
                kept.append(caches["enc_out"])
            return [lg.cpu() for lg in out], [t.cpu() for t in kept]

        grad = grad_run(cfg, {k: v.numpy() for k, v in front_batch(
            cfg, 130, 1 if cfg.frontend == "vision" else 2, "train", 3,
            "cpu").items()})
        (got, cpu, floor), train = card_cpu_floor(dev, params, host, name,
                                                  run, grad)
        train += (card_gnorm_floors(dev, params, grad),)
        del params, host
        steps = ["prefill"] + [f"decode_step {i + 1}" for i in range(4)] \
            + ["decode_step 5, one row left out"]
        ok = True
        for step, lc, lg, ln in zip(steps, cpu[0], got[0], floor[0]):
            err, fl = rel(lc, lg), rel(lg, ln)
            limit = max(LOGIT_LIMIT, FRONT_FLOOR_TIMES * fl)
            ok &= err <= limit
            say(f"[parity] {name}, {step}: max|dlogit| / max|logit| = "
                f"{err:.3e} (limit {limit:.3g}; noise floor {fl:.3e}) on "
                f"{card}")
        kerr = max(rel(a, b) for a, b in zip(cpu[1], got[1]))
        kfloor = max(rel(a, b) for a, b in zip(got[1], floor[1]))
        limit = max(STORE_LIMIT, FRONT_FLOOR_TIMES * kfloor)
        ok &= kerr <= limit
        say(f"[parity] {name}, dense rings"
            + (" and enc_out" if cfg.encoder_decoder else "")
            + f" after prefill and five steps: max|err| / max|x| = "
            f"{kerr:.3e} (limit {limit:.3g}; noise floor {kfloor:.3e})")
        if not ok:
            fail(f"card and CPU disagree on {cfg.name} logits or caches")
        if not train_parity_ok(card, cfg, *train, FRONT_FLOOR_TIMES):
            fail(f"card and CPU disagree on {cfg.name}'s training loss or "
                 "gradients")
        torch.cuda.empty_cache()


def phase_parity_attention(dev, card, drawn: dict):
    """Phase 5's attention archs, each a full-width 2-layer f32 cut
    through :func:`phase_parity`: yi-6b; h2o-danube-3-4b (head dim 120,
    window 4096); gemma3-4b (head dim 256, a 262k vocabulary; the cut
    takes one local and the global layer, so both rope thetas run);
    starcoder2-15b (48 heads on 4 KV heads, LayerNorm and GELU).  The
    last two take their gradient on one row and no dense steps: yi-6b
    and h2o-danube-3-4b run the dense path's code, recurrentgemma-9b's
    cut its D 256 instances, and the CPU's f32 passes set the phase's
    time.  ``drawn``: :func:`parity_cuts`' host weights by name, each
    taken out as it is used."""
    cuts = {"yi-6b": (True, 2), "h2o-danube-3-4b": (True, 2),
            "gemma3-4b": (False, 1), "starcoder2-15b": (False, 1)}
    for arch, (dense, grad_rows) in cuts.items():
        cfg, host = drawn.pop(arch).result()
        if arch == "h2o-danube-3-4b" and cfg.resolved_head_dim != 120:
            fail(f"{cfg.name} has head dim {cfg.resolved_head_dim}, not 120")
        say(f"[parity] {cfg.name}: {cfg.num_layers} layers "
            f"{cfg.block_pattern}, head dim {cfg.resolved_head_dim}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads, norm {cfg.norm}, "
            f"mlp {cfg.mlp}, vocab {cfg.vocab_size}")
        phase_parity(dev, card, cfg, host, dense, grad_rows)
        del host


def parity_cuts() -> dict:
    """Phase 5's full-width f32 cuts by name: 2 layers of yi-6b,
    h2o-danube-3-4b, gemma3-4b (one local and the global layer),
    starcoder2-15b, rwkv6-7b, deepseek-moe-16b (its dense first layer
    and one MoE layer), internvl2-1b and whisper-tiny (2 decoder and 2
    encoder layers); 5 of recurrentgemma-9b."""
    extra = {"gemma3-4b": {"block_pattern": ("local", "global")},
             "recurrentgemma-9b": {"num_layers": 5},
             "whisper-tiny": {"enc_layers": 2}}
    return {arch: dataclasses.replace(
        get_config(arch), **{"num_layers": 2, "dtype": "float32",
                             **extra.get(arch, {})})
        for arch in ("yi-6b", "h2o-danube-3-4b", "gemma3-4b",
                     "starcoder2-15b", "recurrentgemma-9b", "rwkv6-7b",
                     MOE_ARCH, *FRONT_ARCHS)}


def recording(run, sink: list):
    """``run`` with every ``moe_apply`` call inside it recorded: each call
    appends ``[(router, x, valid)]`` (detached) for that call to
    ``sink``."""
    def rec_run(*a, **kw):
        calls, orig = [], moe_model.moe_apply

        def rec(params, x, cfg, **opts):
            calls.append((params["router"].detach(), x.detach(),
                          opts.get("valid")))
            return orig(params, x, cfg, **opts)
        moe_model.moe_apply = rec
        try:
            out = run(*a, **kw)
        finally:
            moe_model.moe_apply = orig
        sink.append(calls)
        return out
    return rec_run


def router_choices(router, x, valid, k: int):
    """The top-k expert set (sorted ids) of every live token of one
    ``moe_apply`` call, with each token's margin (its k-th probability less
    the next one), on the CPU: ``(sets [N, k], margins [N])``."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    live = (torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
            if valid is None else valid.to(x.device))
    sets = top_i[..., :k].sort(dim=-1).values[live].cpu()
    nxt = (top_p[..., k] if k < top_p.shape[-1]
           else torch.zeros_like(top_p[..., 0]))
    return sets, (top_p[..., k - 1] - nxt)[live].cpu()


def routes_agree(card, cfg, routes: dict) -> int:
    """Phase 5's router check: the card's and the CPU's top-k expert sets
    for every live token of every recorded ``moe_apply`` call; prints the
    tokens compared, the smallest margin on the CPU and each flip's
    margin.  Returns the number of flipped tokens."""
    total = 0
    for what, (card_calls, _, cpu_calls) in routes.items():
        n, least, flips = 0, math.inf, 0
        for i, (a, b) in enumerate(zip(card_calls, cpu_calls)):
            sa, _ = router_choices(*a, cfg.top_k)
            sb, mb = router_choices(*b, cfg.top_k)
            bad = (sa != sb).any(dim=-1)
            n += len(sb)
            least = min(least, float(mb.min()))
            for t in torch.nonzero(bad).flatten().tolist():
                flips += 1
                say(f"[parity] {cfg.name} router FLIP ({what}, call {i}, "
                    f"token {t}): card {sa[t].tolist()}, CPU "
                    f"{sb[t].tolist()}, CPU top-{cfg.top_k} margin "
                    f"{float(mb[t]):.3e} (numerical: ROADMAP Queue 3)")
        say(f"[parity] {cfg.name} router choices, {what} runs on {card}: "
            f"{len(cpu_calls)} moe_apply calls, {n} live tokens' top-"
            f"{cfg.top_k} sets card against CPU, smallest CPU margin "
            f"{least:.3e}; flips {flips}")
        total += flips
    return total


def host_weights(cfg):
    """``(cfg, its weights)`` drawn on the host by ``zoo.init`` from seed
    0, the weights phase 5 has held to the card since it began; rwkv6-7b's
    bonus u and decay base w0 are then drawn at random from the same
    generator in place of their constant initial values (0 and -6, a
    decay of ~0.9975), so the bonus and a spread of decays are exercised,
    and so is whisper-tiny's ``pos_emb`` (N(0, 0.3) in place of zeros).
    The host's generator is sequential (~1e8 values a second), so
    :func:`main` draws them on a worker thread while phases 3 and 4 run
    on the card."""
    gen = torch.Generator().manual_seed(0)
    params = zoo.init(cfg, gen, "cpu")
    if cfg.encoder_decoder:
        # init leaves the learned positions at zeros: drawn, so the card
        # adds them and indexes them as the CPU does
        params["pos_emb"].normal_(0.0, 0.3, generator=gen)
    if "rwkv6" in cfg.block_pattern:
        tm = params["groups"][0]["tm_cm"]
        tm["u"].normal_(0.0, 0.5, generator=gen)
        tm["w0"].uniform_(-3.0, 1.0, generator=gen)
    return cfg, params


def nudged(dev, params, seed: int) -> dict:
    """``params`` (on the card) with every weight multiplied in f32 by 1 +
    1e-7 N(0, 1), drawn on the card from ``seed``: a perturbation at the
    level of f32 rounding."""
    noise = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
            t.shape, generator=noise, device=dev)), params)


def card_cpu_floor(dev, params, host, name: str, *runs) -> list:
    """Each ``run(p, d)`` on the card with ``params`` (the f32 weights on
    the card), on the card again with them nudged (the noise floor, read
    against the card's run: :func:`nudged`, seed 2; how far f32 rounding
    alone moves this model, which the device does not change), then on
    the CPU with ``host``, the same weights on the host: ``[(card, CPU,
    floor)]`` per run.  Neither is changed.  Prints the seconds of each
    part."""
    t0 = time.perf_counter()
    got = [run(params, dev) for run in runs]
    floor = [run(nudged(dev, params, 2), dev) for run in runs]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu = [run(host, torch.device("cpu")) for run in runs]
    say(f"[times] {name}: card runs and noise-floor runs {t1 - t0:.1f} s, "
        f"CPU runs {time.perf_counter() - t1:.1f} s")
    return list(zip(got, cpu, floor))


def card_gnorm_floors(dev, params, run) -> list:
    """The gradient norm of the grad ``run`` on the card under GNORM_NUDGES
    more nudges of ``params`` (seeds 3, 4, ...): further readings of how
    far the norm moves under f32 rounding alone."""
    out = []
    for seed in range(3, 3 + GNORM_NUDGES):
        out.append(run(nudged(dev, params, seed), dev, leaves=False)[1])
        torch.cuda.empty_cache()
    return out


def rel(a, b) -> float:
    """max |a - b| over max |a|; on the card where one of them lies there
    (the host takes seconds over a gradient of 1e9 entries)."""
    if a.device != b.device:
        a, b = a.to(DEVICE), b.to(DEVICE)
    return float((a - b).abs().max() / a.abs().max())


def train_batch(vocab: int, s: int, rows: int = 2) -> dict:
    """Phase 5's training batch: ``rows`` x ``s`` tokens and labels."""
    rng = np.random.default_rng(3)
    return {n: rng.integers(0, vocab, (rows, s)).astype(np.int32)
            for n in ("tokens", "labels")}


def grad_run(cfg, batch):
    """``run(p, d, leaves=True)``: one ``loss_fn`` with gradients (remat
    on) -> (loss, global gradient norm, {leaf: gradient, on ``d``}, the
    dict empty without ``leaves``, the load-balancing aux)."""
    def run(p, d, leaves=True):
        loss, parts, grads = accum.value_and_grad(
            lambda p, b: zoo.loss_fn(cfg, p, b), p,
            {n: torch.from_numpy(a).to(d) for n, a in batch.items()})
        for t in tree_leaves(p):      # marked in place: later runs take none
            t.requires_grad_(False)
        return (float(loss), float(adamw.global_norm(grads)),
                dict(keyed_leaves(grads)) if leaves else {},
                float(parts["aux"]))
    return run


def train_parity_ok(card, cfg, got, cpu, floor, card_gnorms,
                    floor_times: float | None = None) -> bool:
    """Print the card against the CPU on the loss, the gradient norm and
    every gradient leaf (each relative to its largest value) beside the
    noise floor (the norm's also beside ``card_gnorms``, its readings
    under more nudges); True when all are inside their limits.  With
    ``floor_times`` the loss's and each leaf's limit is the larger of the
    fixed one and that many times its own noise floor (the rule the
    gradient norm's limit follows)."""
    loss_err = abs(got[0] - cpu[0]) / abs(cpu[0])
    loss_floor = abs(floor[0] - got[0]) / abs(got[0])
    loss_limit = (TRAIN_LOSS_LIMIT if floor_times is None
                  else max(TRAIN_LOSS_LIMIT, floor_times * loss_floor))
    gnorm_err = abs(got[1] - cpu[1]) / cpu[1]
    floors = [abs(g - got[1]) / got[1] for g in (floor[1], *card_gnorms)]
    gnorm_limit = GNORM_FLOOR_TIMES * max(floors)
    say(f"[parity] {cfg.name} {cfg.num_layers} layers f32 training on "
        f"{card}: loss {cpu[0]:.6f}, card - CPU {loss_err:.3e} relative "
        f"(limit {loss_limit:.3g}; noise floor "
        f"{loss_floor:.3e}); grad norm {cpu[1]:.6f},"
        f" {gnorm_err:.3e} (limit {gnorm_limit:.3e}, {GNORM_FLOOR_TIMES}x the "
        f"largest floor; floors " + ", ".join(f"{f:.3e}" for f in floors)
        + ")")
    if cfg.moe:
        say(f"[parity] {cfg.name} load-balancing aux (0.01 of it in the "
            f"loss): CPU {cpu[3]:.6f}, card - CPU "
            f"{abs(got[3] - cpu[3]) / abs(cpu[3]):.3e} relative (noise floor "
            f"{abs(floor[3] - got[3]) / abs(got[3]):.3e})")
    leaves_ok = True
    for key, g in cpu[2].items():
        err = rel(g, got[2][key])
        leaf_floor = rel(got[2][key], floor[2][key])
        limit = (TRAIN_GRAD_LIMIT if floor_times is None
                 else max(TRAIN_GRAD_LIMIT, floor_times * leaf_floor))
        leaves_ok &= err <= limit
        say(f"[parity] grad {key}: max|err| / max|g| = {err:.3e} (limit "
            f"{limit:.3g}; noise floor {leaf_floor:.3e})")
    return loss_err <= loss_limit and gnorm_err <= gnorm_limit and leaves_ok


def packed_arrays(rng, vocab, segs, width, b):
    """One packed stream's host arrays: [(slot, start, length)] segments
    back to back, dead lanes after."""
    tokens = np.zeros((1, width), np.int32)
    slot = np.full(width, -1, np.int32)
    pos = np.zeros(width, np.int32)
    start = np.zeros(b, np.int32)
    seg_len = np.zeros(b, np.int32)
    c = 0
    for s, st, n in segs:
        tokens[0, c:c + n] = rng.integers(0, vocab, n)
        slot[c:c + n] = s
        pos[c:c + n] = np.arange(st, st + n)
        start[s], seg_len[s] = st, n
        c += n
    return tokens, slot, pos, start, seg_len


def oneshot_run(cfg, length: int, cache: int):
    """``run(p, d)``: a one-shot ``prefill`` of one seeded prompt of
    ``length`` tokens into fresh dense caches of ``cache`` -> (logits,
    {leaf: tensor on the CPU} of every cache leaf)."""
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                               (1, length)).astype(np.int32)

    def run(p, d):
        logits, caches = zoo.prefill(cfg, p, {"tokens": torch.from_numpy(
            tokens).to(d)}, cache_len=cache)
        return logits.cpu(), {k: t.cpu() for k, t in keyed_leaves(caches)}
    return run


def oneshot_ok(card, name: str, got, cpu, floor, logit_limit,
               state_limit) -> bool:
    """Print the one-shot prefill's logits and every cache leaf, card
    against CPU beside the noise floor; True when inside the
    limits."""
    err = rel(cpu[0], got[0])
    say(f"[parity] {name}, one-shot prefill of one prompt: "
        f"max|dlogit| / max|logit| = {err:.3e} (limit {logit_limit:g}; "
        f"noise floor {rel(got[0], floor[0]):.3e}) on {card}")
    serr = 0.0
    for key, a in cpu[1].items():
        if not a.is_floating_point() or not a.abs().max():
            continue          # positions, and leaves the prompt leaves zero
        serr = max(serr, rel(a, got[1][key]))
        say(f"[parity] {name}, one-shot cache {key}: max|err| / max|x| = "
            f"{rel(a, got[1][key]):.3e} (limit {state_limit:g}; noise "
            f"floor {rel(got[1][key], floor[1][key]):.3e})")
    ints = [k for k, a in cpu[1].items() if not a.is_floating_point()]
    same = all(torch.equal(cpu[1][k], got[1][k]) for k in ints)
    return err <= logit_limit and serr <= state_limit and same


def phase_parity_rg(dev, card, drawn):
    """Full-width recurrentgemma-9b, 5 layers (one rglru, rglru, swa group
    and the 2-layer rglru remainder), f32, TF32 off, dense rings: two
    packed steps (prefill chunks, then chunks beside decode riders) and a
    decode step with one idle row; a one-shot ``prefill`` of a 150-token
    prompt (``rglru_block``, the flash forward at D 256); one ``loss_fn``
    with gradients at batch 1 x 130 (the flash forward and backward at D
    256; one row: the CPU's f32 passes over a 256k vocabulary set this
    phase's time): card against CPU, beside the card against itself with
    every weight multiplied by 1 + 1e-7 N(0, 1) (:func:`card_cpu_floor`).
    ``drawn``: the future of :func:`host_weights`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, host = drawn.result()
    params = tree_map(lambda t: t.to(dev), host)
    b, cache = 4, 256
    ticks = [[(0, 0, 24), (1, 0, 9), (2, 0, 28), (3, 0, 3)],
             [(0, 24, 20), (1, 9, 1), (2, 28, 30), (3, 3, 1)]]

    def run(p, d):
        caches = zoo.init_cache(cfg, b, cache, d)
        rng = np.random.default_rng(1)
        logits = []
        for segs in ticks:
            arrays = packed_arrays(rng, cfg.vocab_size, segs, 64, b)
            logits.append(zoo.step_packed(
                cfg, p, caches, *(torch.from_numpy(a).to(d) for a in arrays)))
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, b)
                               .astype(np.int32)).to(d)
        dpos = torch.tensor([44, 10, 58, 4], dtype=torch.int32, device=d)
        active = torch.tensor([True, True, False, True], device=d)
        logits.append(zoo.decode_step(cfg, p, caches, tok, dpos,
                                      active=active)[active])
        g = caches["groups"]
        return ([lg.cpu() for lg in logits],
                {"ring k": g[2]["k"].cpu(), "ring v": g[2]["v"].cpu(),
                 "rglru h": g[0]["h"].cpu(), "conv": g[1]["conv"].cpu(),
                 "rem h": caches["rem"][1]["h"].cpu()})

    name = "recurrentgemma-9b 5 layers f32"
    grad = grad_run(cfg, train_batch(cfg.vocab_size, 130, rows=1))
    (got, cpu, floor), oneshot, train = card_cpu_floor(
        dev, params, host, name, run, oneshot_run(cfg, 150, cache), grad)
    train += (card_gnorm_floors(dev, params, grad),)
    del params, host
    worst = 0.0
    for i, (lc, lg, ln) in enumerate(zip(cpu[0], got[0], floor[0])):
        err = rel(lc, lg)
        worst = max(worst, err)
        say(f"[parity] {name}, step {i + 1} "
            f"({'step_packed' if i < 2 else 'decode_step'}): max|dlogit| / "
            f"max|logit| = {err:.3e} (limit {RG_LOGIT_LIMIT:g}; noise "
            f"floor {rel(lg, ln):.3e}) on {card}")
    serr = 0.0
    for leaf in cpu[1]:
        a, g, f = cpu[1][leaf], got[1][leaf], floor[1][leaf]
        serr = max(serr, rel(a, g))
        say(f"[parity] {leaf} after the three steps: max|err| / max|x| = "
            f"{rel(a, g):.3e} (limit {RG_STATE_LIMIT:g}; noise floor "
            f"{rel(g, f):.3e}); max|x| {float(a.abs().max()):.1f}")
    if not worst <= RG_LOGIT_LIMIT or not serr <= RG_STATE_LIMIT:
        fail("card and CPU disagree on recurrentgemma logits or caches")
    if not oneshot_ok(card, name, *oneshot, RG_LOGIT_LIMIT, RG_STATE_LIMIT):
        fail("card and CPU disagree on recurrentgemma's one-shot prefill")
    if not train_parity_ok(card, cfg, *train):
        fail("card and CPU disagree on recurrentgemma's training loss or "
             "gradients")


def phase_parity_rwkv6(dev, card, drawn):
    """Full-width rwkv6-7b, 2 layers, f32, TF32 off: two packed steps
    (prefill chunks, then chunks beside decode riders) and a decode step
    with one idle row; a one-shot ``prefill`` of a 97-token prompt
    (``time_mix_chunked``'s remainder chunk: 32, 32, 32, 1); one
    ``loss_fn`` with gradients at batch 2 x 97: card against CPU, on
    logits, every state leaf and every gradient leaf, beside the card
    against itself with every weight multiplied by 1 + 1e-7 N(0, 1) (the
    bonus u and the decay base w0 drawn at random: :func:`host_weights`).
    ``drawn``: the future of :func:`host_weights`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, host = drawn.result()
    params = tree_map(lambda t: t.to(dev), host)
    b, cache = 4, 256
    ticks = [[(0, 0, 24), (1, 0, 9), (2, 0, 28), (3, 0, 3)],
             [(0, 24, 20), (1, 9, 1), (2, 28, 30), (3, 3, 1)]]

    def run(p, d):
        caches = zoo.init_cache(cfg, b, cache, d)
        rng = np.random.default_rng(1)
        logits = []
        for segs in ticks:
            arrays = packed_arrays(rng, cfg.vocab_size, segs, 64, b)
            logits.append(zoo.step_packed(
                cfg, p, caches, *(torch.from_numpy(a).to(d) for a in arrays)))
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, b)
                               .astype(np.int32)).to(d)
        dpos = torch.tensor([44, 10, 58, 4], dtype=torch.int32, device=d)
        active = torch.tensor([True, True, False, True], device=d)
        logits.append(zoo.decode_step(cfg, p, caches, tok, dpos,
                                      active=active)[active])
        return ([lg.cpu() for lg in logits],
                {n: a.cpu() for n, a in caches["groups"][0].items()})

    name = "rwkv6-7b 2 layers f32"
    grad = grad_run(cfg, train_batch(cfg.vocab_size, 97))
    (got, cpu, floor), oneshot, train = card_cpu_floor(
        dev, params, host, name, run, oneshot_run(cfg, 97, cache), grad)
    train += (card_gnorm_floors(dev, params, grad),)
    del params, host
    worst = 0.0
    for i, (lc, lg, ln) in enumerate(zip(cpu[0], got[0], floor[0])):
        err = rel(lc, lg)
        worst = max(worst, err)
        say(f"[parity] {name}, step {i + 1} "
            f"({'step_packed' if i < 2 else 'decode_step'}): max|dlogit| / "
            f"max|logit| = {err:.3e} (limit {RWKV_LOGIT_LIMIT:g}; noise "
            f"floor {rel(lg, ln):.3e}) on {card}")
    serr = 0.0
    for leaf in cpu[1]:
        a, g, f = cpu[1][leaf], got[1][leaf], floor[1][leaf]
        serr = max(serr, rel(a, g))
        say(f"[parity] rwkv6 {leaf} (both layers) after the three steps: "
            f"max|err| / max|x| = {rel(a, g):.3e} (limit "
            f"{RWKV_STATE_LIMIT:g}; noise floor {rel(g, f):.3e}); "
            f"max|x| {float(a.abs().max()):.1f}")
    if not worst <= RWKV_LOGIT_LIMIT or not serr <= RWKV_STATE_LIMIT:
        fail("card and CPU disagree on rwkv6-7b logits or state")
    if not oneshot_ok(card, name, *oneshot, RWKV_LOGIT_LIMIT,
                      RWKV_STATE_LIMIT):
        fail("card and CPU disagree on rwkv6-7b's one-shot prefill")
    if not train_parity_ok(card, cfg, *train):
        fail("card and CPU disagree on rwkv6-7b's training loss or "
             "gradients")


def phase_slice(dev, card) -> tuple[dict, dict, dict]:
    """Full yi-6b bf16 through the launcher's own functions.  Returns the
    launches, the weights (phase 10 serves them again) and the greedy
    tokens by request."""
    cfg = get_config("yi-6b")
    lens = prompt_lens()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]
    new_tokens = 32
    held = torch.cuda.memory_allocated(dev)
    eng = build_engine(cfg, max_batch=SLOTS, cache_len=CACHE_LEN,
                       budget_headroom_bytes=1e9, latency_goal_s=0.02,
                       device=dev, seed=0)
    say(f"[slice] {cfg.name} bf16, {cfg.num_layers} layers, weights "
        f"{eng.accountant.breakdown()['weights'] / 1e9:.3f} GB, HBM goal "
        f"{eng.accountant.budget_bytes / 1e9:.3f} GB; prompts "
        f"{lens.tolist()}, {new_tokens} new tokens each")
    # each knob's value before the first tick, then after every tick
    knobs = {"serve.max_queue_tokens": [eng.max_queue_tokens],
             "serve.kv_block_budget": [eng.pool.max_blocks],
             "serve.prefill_chunk_tokens": [eng.prefill_chunk]}

    # each tick's device-complete wall time, by kind (the synchronise here
    # only ends ticks the engine did not wait on itself)
    tick_s = {"mixed": [], "decode-only": []}
    last = [0.0]

    def on_tick(e, st):
        knobs["serve.max_queue_tokens"].append(e.max_queue_tokens)
        knobs["serve.kv_block_budget"].append(e.pool.max_blocks)
        knobs["serve.prefill_chunk_tokens"].append(e.prefill_chunk)
        torch.cuda.synchronize()
        now = time.perf_counter()
        kind = "mixed" if st["prefill_issued_tokens"] else "decode-only"
        tick_s[kind].append(now - last[0])
        last[0] = now

    torch.cuda.reset_peak_memory_stats(dev)
    paged_segment_attention.launches = 0
    paged_segment_attention.route_launches = dict.fromkeys(
        paged_segment_attention.route_launches, 0)
    paged_decode_attention.launches = 0
    t0 = last[0] = time.perf_counter()
    stats = serve_requests(eng, prompts, new_tokens, on_tick=on_tick)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_segment_attention": paged_segment_attention.launches,
                "paged_decode_attention": paged_decode_attention.launches}
    say("[slice] " + summary(eng, len(prompts), len(stats)))
    n_done = len(eng.finished)
    max_disp = max(st["dispatches"] for st in stats)
    gen_tokens = sum(len(r.generated) for r in eng.finished)
    say(f"[slice] finished {n_done}/{len(prompts)} in {len(stats)} ticks; "
        f"max dispatches/tick {max_disp}; kernel launches {launches}; "
        f"preemptions {eng.preemptions}")
    for k, vals in knobs.items():
        say(f"[slice] knob {k}: first {vals[0]}, last {vals[-1]}, "
            f"distinct values {len(set(vals))}")
    say(f"[slice] device memory: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; accountant "
        f"peak {eng.accountant.peak_bytes / 1e9:.3f} GB")
    in_phase_peak("[slice]", dev, eng, held)
    say(f"[slice] on {card}: {gen_tokens} tokens in {wall:.3f} s = "
        f"{gen_tokens / wall:.2f} tokens/s (first launches included); "
        f"TTFT mean {eng.ttft.mean() * 1e3:.1f} ms, p99 "
        f"{eng.ttft.p99() * 1e3:.1f} ms")
    for kind, ts in tick_s.items():
        if ts:
            say(f"[slice] {kind} ticks on {card}: {len(ts)}, mean "
                f"{np.mean(ts) * 1e3:.1f} ms, first {ts[0] * 1e3:.1f} ms, "
                f"max {max(ts) * 1e3:.1f} ms")
    if n_done != len(prompts):
        fail("not every request finished")
    for r in eng.finished:
        g = np.asarray(r.generated)
        if len(g) != new_tokens or g.min() < 0 or g.max() >= cfg.vocab_size:
            fail(f"request {r.req_id} generated {g!r}")
    if max_disp > 1:
        fail("more than one model dispatch in a tick")
    if not all(launches.values()):
        fail(f"a kernel of the path never launched: {launches}")
    routes = paged_segment_attention.route_launches
    say(f"[slice] paged segment launches by route: {routes}")
    if routes["tensor_core"] != launches["paged_segment_attention"]:
        fail(f"a paged segment launch left the tensor cores: {routes}")
    if not all(len(set(v)) > 1 for v in knobs.values()):
        fail("a SmartConf knob never moved")
    cap = eng.pool.capacity
    before = torch.cuda.memory_allocated(dev)
    eng.set_kv_budget(eng.blocks_per_seq)
    after = torch.cuda.memory_allocated(dev)
    say(f"[slice] KV budget cut {cap} -> {eng.pool.capacity} blocks: "
        f"memory_allocated {before / 1e9:.3f} -> {after / 1e9:.3f} GB")
    if not after < before:
        fail("the KV budget cut released no device memory")
    eng.close()
    tokens = {r.req_id: list(r.generated) for r in eng.finished}
    return launches, eng.params, tokens


def phase_rg_slice(dev, card) -> dict:
    """Full recurrentgemma-9b bf16 through the launcher's own functions,
    default options (packed ticks, dense rings, RG-LRU state); then the
    cost of the B x P recurrent rows on a full-width tick."""
    cfg = get_config("recurrentgemma-9b")
    lens = rg_prompt_lens()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]
    new_tokens = 32
    held = torch.cuda.memory_allocated(dev)
    eng = build_engine(cfg, max_batch=RG_SLOTS, cache_len=RG_CACHE_LEN,
                       budget_headroom_bytes=RG_HEADROOM, latency_goal_s=0.02,
                       device=dev, seed=0)
    kv = "paged" if eng.paged else "dense"
    say(f"[rg-slice] {cfg.name} bf16, {cfg.num_layers} layers, weights "
        f"{eng.accountant.breakdown()['weights'] / 1e9:.3f} GB, HBM goal "
        f"{eng.accountant.budget_bytes / 1e9:.3f} GB; kv[{kv}], prefill "
        f"[{eng.prefill_impl}]; prompts {lens.tolist()}, {new_tokens} new "
        "tokens each")
    if eng.paged or eng.prefill_impl != "packed":
        fail("default options did not resolve to packed ticks on dense KV")
    knobs = {"serve.max_queue_tokens": [eng.max_queue_tokens],
             "serve.kv_block_budget": [eng.pool.max_blocks],
             "serve.prefill_chunk_tokens": [eng.prefill_chunk]}
    tick_s = {"mixed": [], "decode-only": []}
    last = [0.0]

    def on_tick(e, st):
        knobs["serve.max_queue_tokens"].append(e.max_queue_tokens)
        knobs["serve.kv_block_budget"].append(e.pool.max_blocks)
        knobs["serve.prefill_chunk_tokens"].append(e.prefill_chunk)
        torch.cuda.synchronize()
        now = time.perf_counter()
        kind = "mixed" if st["prefill_issued_tokens"] else "decode-only"
        tick_s[kind].append(now - last[0])
        last[0] = now

    torch.cuda.reset_peak_memory_stats(dev)
    segment_attention.launches = 0
    segment_attention.route_launches = dict.fromkeys(
        segment_attention.route_launches, 0)
    rglru_scan_state.launches = 0
    decode_attention.launches = 0
    t0 = last[0] = time.perf_counter()
    stats = serve_requests(eng, prompts, new_tokens, on_tick=on_tick)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"segment_attention": segment_attention.launches,
                "rglru_scan_state": rglru_scan_state.launches,
                "decode_attention": decode_attention.launches}
    # drain ticks: a decode step, no prefill (each of its 12 swa layers
    # launches the dense decode kernel)
    n_drain = sum(1 for st in stats
                  if st["dispatches"] and not st["prefill_issued_tokens"])
    swa = sum(blocks.split_kind(k)[0] == "swa" for k in
              (cfg.block_pattern * cfg.num_layers)[:cfg.num_layers])
    say("[rg-slice] " + summary(eng, len(prompts), len(stats)))
    n_done = len(eng.finished)
    max_disp = max(st["dispatches"] for st in stats)
    gen_tokens = sum(len(r.generated) for r in eng.finished)
    n_mixed = len(tick_s["mixed"])
    say(f"[rg-slice] finished {n_done}/{len(prompts)} in {len(stats)} ticks "
        f"({n_mixed} mixed); max dispatches/tick {max_disp}; HBM "
        f"violations {eng.accountant.violations}; preemptions "
        f"{eng.preemptions}; kernel launches {launches} = "
        f"{launches['segment_attention'] / max(1, n_mixed):g} flat segment "
        f"and {launches['rglru_scan_state'] / max(1, n_mixed):g} RG-LRU per "
        f"mixed tick, {launches['decode_attention'] / max(1, n_drain):g} "
        f"dense decode per drain tick ({n_drain} drain ticks)")
    for k, vals in knobs.items():
        say(f"[rg-slice] knob {k}: {vals[0]} -> {vals[-1]}, distinct values "
            f"{len(set(vals))}, trajectory {runs(vals)}")
    say(f"[rg-slice] device memory: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; accountant "
        f"peak {eng.accountant.peak_bytes / 1e9:.3f} GB")
    in_phase_peak("[rg-slice]", dev, eng, held)
    say(f"[rg-slice] on {card}: {gen_tokens} tokens in {wall:.3f} s = "
        f"{gen_tokens / wall:.2f} tokens/s (first launches included); "
        f"TTFT mean {eng.ttft.mean() * 1e3:.1f} ms, p99 "
        f"{eng.ttft.p99() * 1e3:.1f} ms")
    for kind, ts in tick_s.items():
        if ts:
            say(f"[rg-slice] {kind} ticks on {card}: {len(ts)}, mean "
                f"{np.mean(ts) * 1e3:.1f} ms, first {ts[0] * 1e3:.1f} ms, "
                f"max {max(ts) * 1e3:.1f} ms")
    if n_done != len(prompts):
        fail("not every request finished")
    for r in eng.finished:
        g = np.asarray(r.generated)
        if len(g) != new_tokens or g.min() < 0 or g.max() >= cfg.vocab_size:
            fail(f"request {r.req_id} generated {g!r}")
    if max_disp > 1:
        fail("more than one model dispatch in a tick")
    if eng.accountant.violations:
        fail("the HBM goal was violated")
    if not all(launches.values()):
        fail(f"a kernel of the path never launched: {launches}")
    routes = segment_attention.route_launches
    say(f"[rg-slice] flat segment launches by route: {routes}")
    if routes["tensor_core"] != launches["segment_attention"]:
        fail(f"a flat segment launch left the tensor cores: {routes}")
    if launches["decode_attention"] != swa * n_drain:
        fail(f"expected {swa} dense decode launches per drain tick, got "
             f"{launches['decode_attention']} in {n_drain} drain ticks")
    if not all(len(set(v)) > 1 for v in knobs.values()):
        fail("a SmartConf knob never moved")
    rows_cost(eng, card, "rglru", "rg-slice")
    eng.close()
    params = eng.params
    tokens = {r.req_id: list(r.generated) for r in eng.finished}
    del eng
    torch.cuda.empty_cache()

    def expect(e, n_decode):
        # the one-shot prefill runs the flash forward once per swa layer,
        # each decode step the dense decode kernel once per swa layer
        return {"flash_attention": swa * e.prefill_calls,
                "decode_attention": swa * n_decode}

    got = legacy_slice(dev, card, cfg, params, prompts, new_tokens, tokens,
                       dict(max_batch=RG_SLOTS, cache_len=RG_CACHE_LEN,
                            budget_headroom_bytes=RG_HEADROOM),
                       "rg-legacy", (flash_attention, decode_attention,
                                     segment_attention, rglru_scan_state),
                       expect)
    f32_modes_agree(dev, card, cfg, 5, prompts, new_tokens,
                    dict(max_batch=RG_SLOTS, cache_len=RG_CACHE_LEN,
                         budget_headroom_bytes=RG_HEADROOM), "rg-legacy")
    return {k: launches.get(k, 0) + got.get(k, 0)
            for k in set(launches) | set(got)}


def phase_rwkv6_slice(dev, card) -> dict:
    """Full rwkv6-7b bf16 through the launcher's own functions, default
    options (packed ticks, per-slot WKV state, no rings); then the cost of
    the B x P recurrent rows on a full-width tick."""
    cfg = get_config("rwkv6-7b")
    lens = rwkv6_prompt_lens()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]
    new_tokens = 32
    held = torch.cuda.memory_allocated(dev)
    eng = build_engine(cfg, max_batch=RWKV_SLOTS, cache_len=RWKV_CACHE_LEN,
                       budget_headroom_bytes=RWKV_HEADROOM,
                       latency_goal_s=0.02, device=dev, seed=0)
    kv = "paged" if eng.paged else "dense"
    rings = transformer.ring_lens(eng.caches)
    say(f"[rwkv6-slice] {cfg.name} bf16, {cfg.num_layers} layers, weights "
        f"{eng.accountant.breakdown()['weights'] / 1e9:.3f} GB, HBM goal "
        f"{eng.accountant.budget_bytes / 1e9:.3f} GB; kv[{kv}], rings "
        f"{sorted(rings)}, KV block bytes {eng.pool.block_bytes}, prefill "
        f"[{eng.prefill_impl}]; prompts {lens.tolist()}, {new_tokens} new "
        "tokens each")
    if eng.paged or rings or eng.prefill_impl != "packed":
        fail("default options did not resolve to packed ticks on recurrent "
             "state alone")
    knobs = {"serve.max_queue_tokens": [eng.max_queue_tokens],
             "serve.kv_block_budget": [eng.pool.max_blocks],
             "serve.prefill_chunk_tokens": [eng.prefill_chunk]}
    tick_s = {"mixed": [], "decode-only": []}
    last = [0.0]

    def on_tick(e, st):
        knobs["serve.max_queue_tokens"].append(e.max_queue_tokens)
        knobs["serve.kv_block_budget"].append(e.pool.max_blocks)
        knobs["serve.prefill_chunk_tokens"].append(e.prefill_chunk)
        torch.cuda.synchronize()
        now = time.perf_counter()
        kind = "mixed" if st["prefill_issued_tokens"] else "decode-only"
        tick_s[kind].append(now - last[0])
        last[0] = now

    torch.cuda.reset_peak_memory_stats(dev)
    rwkv6_scan_state.launches = 0
    t0 = last[0] = time.perf_counter()
    stats = serve_requests(eng, prompts, new_tokens, on_tick=on_tick)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rwkv6_scan_state": rwkv6_scan_state.launches}
    say("[rwkv6-slice] " + summary(eng, len(prompts), len(stats)))
    n_done = len(eng.finished)
    max_disp = max(st["dispatches"] for st in stats)
    gen_tokens = sum(len(r.generated) for r in eng.finished)
    n_mixed = len(tick_s["mixed"])
    say(f"[rwkv6-slice] finished {n_done}/{len(prompts)} in {len(stats)} "
        f"ticks ({n_mixed} mixed); max dispatches/tick {max_disp}; HBM "
        f"violations {eng.accountant.violations}; preemptions "
        f"{eng.preemptions}; kernel launches {launches} = "
        f"{launches['rwkv6_scan_state'] / max(1, n_mixed):g} RWKV-6 per "
        "mixed tick")
    for k, vals in knobs.items():
        say(f"[rwkv6-slice] knob {k}: {vals[0]} -> {vals[-1]}, distinct "
            f"values {len(set(vals))}, trajectory {runs(vals)}")
    say(f"[rwkv6-slice] device memory: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; accountant "
        f"peak {eng.accountant.peak_bytes / 1e9:.3f} GB")
    in_phase_peak("[rwkv6-slice]", dev, eng, held)
    say(f"[rwkv6-slice] on {card}: {gen_tokens} tokens in {wall:.3f} s = "
        f"{gen_tokens / wall:.2f} tokens/s (first launches included); "
        f"TTFT mean {eng.ttft.mean() * 1e3:.1f} ms, p99 "
        f"{eng.ttft.p99() * 1e3:.1f} ms")
    for kind, ts in tick_s.items():
        if ts:
            say(f"[rwkv6-slice] {kind} ticks on {card}: {len(ts)}, mean "
                f"{np.mean(ts) * 1e3:.1f} ms, first {ts[0] * 1e3:.1f} ms, "
                f"max {max(ts) * 1e3:.1f} ms")
    if n_done != len(prompts):
        fail("not every request finished")
    for r in eng.finished:
        g = np.asarray(r.generated)
        if len(g) != new_tokens or g.min() < 0 or g.max() >= cfg.vocab_size:
            fail(f"request {r.req_id} generated {g!r}")
    if max_disp > 1:
        fail("more than one model dispatch in a tick")
    if eng.accountant.violations:
        fail("the HBM goal was violated")
    if not n_mixed or launches["rwkv6_scan_state"] != cfg.num_layers * n_mixed:
        fail(f"expected {cfg.num_layers} RWKV-6 launches per mixed tick, got "
             f"{launches} in {n_mixed} mixed ticks")
    if not all(len(set(v)) > 1 for v in knobs.values()):
        fail("a SmartConf knob never moved")
    rows_cost(eng, card, "rwkv6", "rwkv6-slice")
    eng.close()
    params = eng.params
    tokens = {r.req_id: list(r.generated) for r in eng.finished}
    del eng
    torch.cuda.empty_cache()
    # the one-shot prefill and the decode steps are plain tensor code on
    # rwkv6, as in the reference: no kernel launches
    got = legacy_slice(dev, card, cfg, params, prompts, new_tokens, tokens,
                       dict(max_batch=RWKV_SLOTS, cache_len=RWKV_CACHE_LEN,
                            budget_headroom_bytes=RWKV_HEADROOM),
                       "rwkv6-legacy", (rwkv6_scan_state, flash_attention,
                                        decode_attention),
                       lambda e, n_decode: {})
    f32_modes_agree(dev, card, cfg, 2, prompts, new_tokens,
                    dict(max_batch=RWKV_SLOTS, cache_len=RWKV_CACHE_LEN,
                         budget_headroom_bytes=RWKV_HEADROOM), "rwkv6-legacy")
    return {k: launches.get(k, 0) + got.get(k, 0)
            for k in set(launches) | set(got)}


def legacy_slice(dev, card, cfg, params, prompts, new_tokens, packed_tokens,
                 opts, tag, counted, expect) -> dict:
    """The same weights and requests again with ``prefill_mode="legacy"``
    (``opts``: the packed run's engine settings): one-shot prefill per
    admitted request through the recurrent one-shot forms, then decode
    ticks, knobs live.  Prints tokens/s, TTFT, admission-tick and
    decode-tick ms, dispatches per tick (1 plus the tick's admissions at
    most), the in-phase peak beside the goal, the tokens each request
    shares with the packed run (bf16 near-ties: information) and the
    one-shot forms' ms per layer at the longest prompt.  ``expect(eng,
    n_decode)`` gives the launches of ``counted`` the run must make (the
    others none); every flash forward launch takes the CUDA-core route
    (D 256)."""
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    held = torch.cuda.memory_allocated(dev) - weights
    eng = build_engine(cfg, latency_goal_s=0.02, device=dev, params=params,
                       prefill_mode="legacy", **opts)
    tag = f"[{tag}]"
    say(f"{tag} {cfg.name} bf16, {cfg.num_layers} layers, the packed run's "
        f"weights; prefill[{eng.prefill_impl}], kv["
        f"{'paged' if eng.paged else 'dense'}]; HBM goal "
        f"{eng.accountant.budget_bytes / 1e9:.3f} GB")
    if eng.paged or eng.prefill_impl != "legacy":
        fail("prefill_mode='legacy' did not resolve to one-shot prefill on "
             "dense KV")
    knobs = {"serve.max_queue_tokens": [eng.max_queue_tokens],
             "serve.kv_block_budget": [eng.pool.max_blocks],
             "serve.prefill_chunk_tokens": [eng.prefill_chunk]}
    tick_s = {"admission": [], "decode-only": []}
    per_tick = []            # (dispatches, prefill calls, decoded)
    last, calls = [0.0], [0]

    def on_tick(e, st):
        knobs["serve.max_queue_tokens"].append(e.max_queue_tokens)
        knobs["serve.kv_block_budget"].append(e.pool.max_blocks)
        knobs["serve.prefill_chunk_tokens"].append(e.prefill_chunk)
        torch.cuda.synchronize()
        now = time.perf_counter()
        new_calls = e.prefill_calls - calls[0]
        tick_s["admission" if new_calls else "decode-only"].append(
            now - last[0])
        last[0] = now
        per_tick.append((st["dispatches"], new_calls, st["decode_tokens"] > 0))
        calls[0] = e.prefill_calls

    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counted:
        fn.launches = 0
    flash_attention.route_launches = dict.fromkeys(
        flash_attention.route_launches, 0)
    t0 = last[0] = time.perf_counter()
    with first_token_top2(eng) as margins:
        stats = serve_requests(eng, prompts, new_tokens, on_tick=on_tick)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {fn.__name__: fn.launches for fn in counted}
    routes = dict(flash_attention.route_launches)
    say(f"{tag} " + summary(eng, len(prompts), len(stats)))
    n_done = len(eng.finished)
    gen_tokens = sum(len(r.generated) for r in eng.finished)
    n_decode = sum(d for _, _, d in per_tick)
    tokens = {r.req_id: list(r.generated) for r in eng.finished}
    say(f"{tag} finished {n_done}/{len(prompts)} in {len(stats)} ticks "
        f"({n_decode} with a decode step); dispatches per tick "
        f"{[d for d, _, _ in per_tick]}; prefill calls {eng.prefill_calls}; "
        f"kernel launches {got}, the flash forward's by route {routes}; "
        f"preemptions {eng.preemptions}; HBM violations "
        f"{eng.accountant.violations}")
    for k, vals in knobs.items():
        say(f"{tag} knob {k}: {vals[0]} -> {vals[-1]}, distinct values "
            f"{len(set(vals))}, trajectory {runs(vals)}")
    say(f"{tag} device memory: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; accountant "
        f"peak {eng.accountant.peak_bytes / 1e9:.3f} GB")
    in_phase_peak(tag, dev, eng, held)
    say(f"{tag} on {card}: {gen_tokens} tokens in {wall:.3f} s = "
        f"{gen_tokens / wall:.2f} tokens/s (first launches included); "
        f"TTFT mean {eng.ttft.mean() * 1e3:.1f} ms, p99 "
        f"{eng.ttft.p99() * 1e3:.1f} ms")
    for kind, ts in tick_s.items():
        if ts:
            say(f"{tag} {kind} ticks on {card}: {len(ts)}, mean "
                f"{np.mean(ts) * 1e3:.1f} ms, first {ts[0] * 1e3:.1f} ms, "
                f"max {max(ts) * 1e3:.1f} ms")
    same = sum(a == b for i, g in tokens.items()
               for a, b in zip(g, packed_tokens[i]))
    say(f"{tag} greedy tokens equal to the packed run's: {same}/"
        f"{gen_tokens}, by request "
        + ", ".join(f"{i}: {sum(a == b for a, b in zip(g, packed_tokens[i]))}"
                    for i, g in sorted(tokens.items()))
        + " (information: bf16 near-ties may differ; the CPU tests hold "
        "token identity)")
    gaps = {i: float(v[0] - v[1]) for i, v in sorted(margins.items())}
    say(f"{tag} first-token top-2 logit margin by request: "
        + ", ".join(f"{i}: {g:.4f}" for i, g in gaps.items())
        + f"; first tokens equal to the packed run's "
        f"{sum(g[:1] == packed_tokens[i][:1] for i, g in tokens.items())}/"
        f"{len(tokens)} (bf16 logits; information)")
    oneshot_layer_ms(eng, card, tag, max(len(p) for p in prompts))
    oneshot_vs_packed(card, cfg, params, prompts, opts["cache_len"], tag)
    if n_done != len(prompts):
        fail("not every request finished")
    if eng.accountant.violations:
        fail("the HBM goal was violated")
    for r in eng.finished:
        g = np.asarray(r.generated)
        if len(g) != new_tokens or g.min() < 0 or g.max() >= cfg.vocab_size:
            fail(f"request {r.req_id} generated {g!r}")
    for disp, new_calls, decoded in per_tick:
        if disp != new_calls + decoded:
            fail(f"a legacy tick made {disp} dispatches for {new_calls} "
                 f"prefill calls and {int(decoded)} decode steps")
    if eng.prefill_calls != len(prompts):
        fail(f"{eng.prefill_calls} one-shot prefills for {len(prompts)} "
             "requests")
    want = expect(eng, n_decode)
    want = {fn.__name__: want.get(fn.__name__, 0) for fn in counted}
    if got != want:
        fail(f"legacy kernel launches {got}, expected {want}")
    if routes != {"tensor_core": 0, "cuda_core": got.get("flash_attention",
                                                          0)}:
        fail(f"flash forward launches by route {routes}: the D 256 launches "
             "must take the CUDA-core route")
    eng.close()
    return got


def oneshot_vs_packed(card, cfg, params, prompts, cache_len: int,
                      tag: str) -> None:
    """One prompt (the longest of at most 2048 tokens) through the model
    layer by layer three times, bf16, each into fresh dense caches: the
    one-shot form (``block_apply_seq``, as ``zoo.prefill``), the packed
    form (``block_apply_packed``, one segment, as ``zoo.step_packed``) and
    the one-shot form again with its input embeddings times 1 + 2^-9 N(0,
    1) in bf16 (about the spread of one more bf16 rounding), the noise
    floor.  Prints the hidden states' max|d| / max|x| after every layer
    and the first-token logits' max|dlogit| / max|logit|, one-shot against
    packed beside one-shot against the floor; fails when a layer's or the
    logits' gap exceeds GAP_FLOOR_TIMES times its floor (a fault of one
    path in bf16)."""
    dev = params["embed"].device
    i = max((j for j, pr in enumerate(prompts) if len(pr) <= 2048),
            key=lambda j: len(prompts[j]))
    s = len(prompts[i])
    tokens = torch.as_tensor(np.asarray(prompts[i], np.int32)[None],
                             device=dev)
    noise = torch.Generator(device=dev).manual_seed(8)
    slot = torch.zeros(s, dtype=torch.int32, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    seg_len = torch.full((1,), s, dtype=torch.int32, device=dev)
    gaps, floors, out = [], [], {}
    with torch.no_grad():
        x, positions = transformer._inputs_embeds(cfg, params,
                                                  {"tokens": tokens})
        xn = (x.float() * (1 + 2.0 ** -9 * torch.randn(
            x.shape, generator=noise, device=dev))).to(x.dtype)
        xs = {"oneshot": x, "packed": x, "floor": xn}
        caches = {m: zoo.init_cache(cfg, 1, cache_len, dev) for m in xs}
        plan = transformer.dense_packed_plans(caches["packed"], slot, pos,
                                              start, seg_len)
        walks = [transformer._layers(cfg, params, caches[m]) for m in xs]
        for (kind, p, c1), (_, _, c2), (_, _, c3) in zip(*walks):
            xs["oneshot"] = blocks.block_apply_seq(cfg, kind, p, xs["oneshot"],
                                                   positions, c1)[0]
            xs["packed"] = blocks.block_apply_packed(
                cfg, kind, p, xs["packed"], pos, slot, start, seg_len, c2,
                None, plan)
            xs["floor"] = blocks.block_apply_seq(cfg, kind, p, xs["floor"],
                                                 positions, c3)[0]
            a = xs["oneshot"].float()
            gaps.append(rel(a, xs["packed"].float()))
            floors.append(rel(a, xs["floor"].float()))
        for m, h in xs.items():
            out[m] = transformer._logits(
                cfg, params, apply_norm(cfg.norm, params["ln_f"], h[:, -1]))
    gap, floor = rel(out["oneshot"], out["packed"]), rel(out["oneshot"],
                                                         out["floor"])
    first = {m: int(lg.argmax()) for m, lg in out.items()}
    say(f"{tag} request {i} ({s} tokens) layer by layer, bf16 on {card}: "
        "hidden max|d| / max|x|, one-shot against packed "
        + ", ".join(f"{g:.2e}" for g in gaps) + "; one-shot against its "
        "input rounded once more (the floor) "
        + ", ".join(f"{f:.2e}" for f in floors))
    say(f"{tag} request {i} first-token logits: one-shot against packed "
        f"max|dlogit| / max|logit| = {gap:.3e}, the floor {floor:.3e} "
        f"(limit {GAP_FLOOR_TIMES}x the floor, as for each layer); first "
        f"tokens {first}")
    if not all(g <= GAP_FLOOR_TIMES * f for g, f in zip(gaps + [gap],
                                                         floors + [floor])):
        fail(f"{cfg.name}: the one-shot and packed forms disagree in bf16 "
             "beyond the rounding floor")


def f32_modes_agree(dev, card, cfg, layers: int, prompts, new_tokens, opts,
                    tag) -> None:
    """The same requests through a ``layers``-layer full-width f32 cut of
    ``cfg`` (TF32 off since phase 5), packed and legacy: in f32 the two
    modes must give the same greedy tokens, as the CPU tests hold them to
    (in bf16 near-ties of the random weights make the shares
    information)."""
    cut = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    params = zoo.init(cut, torch.Generator(device=dev).manual_seed(0), dev)
    out = {}
    for mode in ("packed", "legacy"):
        eng = build_engine(cut, latency_goal_s=0.02, device=dev,
                           params=params, prefill_mode=mode, **opts)
        serve_requests(eng, prompts, new_tokens)
        out[mode] = {r.req_id: list(r.generated) for r in eng.finished}
        eng.close()
    del params
    torch.cuda.empty_cache()
    same = sum(a == b for i, g in out["legacy"].items()
               for a, b in zip(g, out["packed"][i]))
    say(f"[{tag}] {cfg.name} {layers} layers f32 on {card}: legacy greedy "
        f"tokens equal to the packed engine's {same}/"
        f"{len(prompts) * new_tokens}")
    if out["legacy"] != out["packed"]:
        fail(f"{cfg.name}: legacy and packed serving give other tokens in "
             "f32")


def oneshot_layer_ms(eng, card, tag, s: int) -> None:
    """One recurrent layer's one-shot form (``rglru_block`` or
    ``time_mix_chunked``) over a seeded bf16 input of the longest prompt's
    ``s`` tokens from zero state, on the first group layer's weights, and
    times the arch's number of such layers."""
    cfg, dev = eng.cfg, eng.device
    kinds = cfg.block_pattern * cfg.num_layers
    for kind in sorted({blocks.split_kind(k)[0] for k in cfg.block_pattern}
                       & set(blocks.RECURRENT_KINDS)):
        p = tree_map(lambda t: t[0],
                     eng.params["groups"][list(cfg.block_pattern).index(kind)])
        x = torch.randn(1, s, cfg.d_model, device=dev, dtype=torch.bfloat16,
                        generator=torch.Generator(device=dev).manual_seed(3))
        if kind == "rglru":
            st = rglru_model.init_state(cfg, 1, dev)
            fn, name = (lambda: rglru_model.rglru_block(p["rglru"], x, st),
                        "rglru_block")
        else:
            st = rwkv6_model.init_state(cfg, 1, dev)
            fn, name = (lambda: rwkv6_model.time_mix_chunked(
                p["tm_cm"], x, st["S"], st["tm_last"]), "time_mix_chunked")
        with torch.no_grad():
            ms = time_ms(fn, iters=5, warmup=1)
        n = sum(blocks.split_kind(k)[0] == kind
                for k in kinds[:cfg.num_layers])
        say(f"{tag} {name} at the longest prompt ({s} tokens, bf16, one "
            f"row) on {card}: {ms:.3f} ms per layer; x {n} layers: "
            f"{n * ms:.1f} ms of a one-shot prefill")


def phase_train_slice(dev, card, timing) -> dict:
    """yi-6b at full width and TRAIN_LAYERS layers, bf16, seeded random
    weights, through the Trainer: TRAIN_STEPS AdamW steps (batch
    TRAIN_BATCH x TRAIN_SEQ, TRAIN_MICRO microbatches, default remat, both
    SmartConf knobs live, the first checkpoint after step 3, one kept),
    then a validation loss without gradients on a held-out batch, then a
    preemption checkpoint of the final state that a fresh Trainer
    restores bit for bit, its data stream at the saved position."""
    cfg = dataclasses.replace(get_config("yi-6b"), num_layers=TRAIN_LAYERS)
    workdir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    free = shutil.disk_usage(workdir).free
    if free < TRAIN_MIN_FREE_DISK:
        fail(f"{free / 1e9:.1f} GB free under {workdir}: the training slice "
             f"writes two 12.2 GB checkpoints and needs "
             f"{TRAIN_MIN_FREE_DISK / 1e9:.0f} GB")
    tc = TrainerConfig(workdir=str(workdir), total_steps=TRAIN_STEPS,
                       ckpt_interval=3, ckpt_keep=1, batch_size=TRAIN_BATCH,
                       seq_len=TRAIN_SEQ, n_micro=TRAIN_MICRO, seed=0)
    opt = adamw.AdamWConfig(warmup_steps=2, total_steps=TRAIN_STEPS)
    tr = Trainer(cfg, opt, tc, device=dev)
    n_par = sum(p.numel() for p in tree_leaves(tr.params))
    # weights and their gradients in bf16, f32 moments and accumulator
    state = n_par * (2 + 2 + 4 + 4 + 4)
    say(f"[train] {cfg.name} bf16, {cfg.num_layers} of 32 layers at full "
        f"width: {n_par / 1e9:.3f} B parameters, {state / 1e9:.1f} GB of "
        f"weights, grads, moments and accumulator; batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} in {TRAIN_MICRO} microbatches, remat {tc.remat}; "
        f"{free / 1e9:.0f} GB free on disk")
    knobs = {"data.prefetch_depth": [tr.pipeline.depth],
             "train.ckpt_interval_steps": [tr.ckpt.interval_steps]}
    counted = (flash_attention, flash_attention_fwd_lse, flash_attention_dq,
               flash_attention_dkv)
    step_s = []
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counted:
        fn.launches = 0
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)
    for i in range(TRAIN_STEPS):
        w0 = tr.ckpt.write_seconds
        t0 = time.perf_counter()
        if i == TRAIN_STEPS - 1:     # the last step runs under the profiler
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                tr.run(1)
        else:
            tr.run(1)
        step_s.append(time.perf_counter() - t0 - (tr.ckpt.write_seconds - w0))
        knobs["data.prefetch_depth"].append(tr.pipeline.depth)
        knobs["train.ckpt_interval_steps"].append(tr.ckpt.interval_steps)
    peak = torch.cuda.max_memory_allocated(dev)
    held_out = SyntheticTokens(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                               seed=1).next_batch()
    with torch.no_grad():
        val, _ = zoo.loss_fn(cfg, tr.params,
                             {n: torch.from_numpy(a).to(dev)
                              for n, a in held_out.items()})
    val = float(val)
    launches = {fn.__name__: fn.launches for fn in counted}
    routes = {fn.__name__: dict(fn.route_launches) for fn in counted}
    write_s = tr.ckpt.write_seconds / max(1, tr.ckpt.writes)
    losses = [m["loss"] for m in tr.metrics_log]
    gnorms = [m["grad_norm"] for m in tr.metrics_log]
    med = float(np.median(step_s[1:]))
    per_step = {"flash_attention_fwd_lse": 2 * TRAIN_LAYERS * TRAIN_MICRO,
                "flash_attention_dq": TRAIN_LAYERS * TRAIN_MICRO,
                "flash_attention_dkv": TRAIN_LAYERS * TRAIN_MICRO}
    # phase 4 timed the kernels at batch FA_B; a microbatch is
    # TRAIN_BATCH / TRAIN_MICRO, and the work is linear in the batch
    scale = TRAIN_BATCH / TRAIN_MICRO / FA_B
    kern_s = sum(n * timing[k]["ms"] * scale for k, n in per_step.items()) / 1e3
    say(f"[train] losses {[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 4) for x in gnorms]}; validation loss (no gradients) "
        f"{val:.4f}; ln {cfg.vocab_size} = {math.log(cfg.vocab_size):.4f}")
    say(f"[train] on {card}: step ms {[round(x * 1e3, 1) for x in step_s]},"
        f" median of steps 2-{TRAIN_STEPS} {med * 1e3:.1f} ms = "
        f"{TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s; flash kernels "
        f"~{kern_s * 1e3:.1f} ms of a step ({kern_s / med:.1%}) from the "
        "counts times phase 4's times")
    kinds, busy, span = device_breakdown(prof)
    say(f"[train] profiled step {TRAIN_STEPS} on {card}: device busy "
        f"{busy:.1f} of {span:.1f} ms ({busy / span:.1%}); device ms by "
        "kind: " + ", ".join(f"{k} {v:.1f}" for k, v in kinds.items()))
    say(f"[train] flash forward device ms in the profiled step on {card}: "
        f"{kinds.get('flash forward', 0.0):.1f} "
        f"({2 * TRAIN_LAYERS * TRAIN_MICRO} launches)")
    if not all(kinds.get(k) for k in ("flash forward", "flash dQ",
                                      "flash dK/dV")):
        fail("the profiler saw no flash forward or backward kernel on the "
             "device")
    say(f"[train] kernel launches {launches}: per step "
        f"{ {k: launches[k] / TRAIN_STEPS for k in per_step} } against "
        f"{per_step}; flash_attention (no lse) {launches['flash_attention']}"
        f" in the validation pass ({TRAIN_LAYERS} layers); launches by "
        f"route {routes}")
    say(f"[train] device memory: max_memory_allocated {peak / 1e9:.3f} GB "
        f"against {state / 1e9:.3f} GB of state; checkpoint writes "
        f"{tr.ckpt.writes}, {write_s:.1f} s each")
    for k, vals in knobs.items():
        say(f"[train] knob {k}: {vals[0]} -> {vals[-1]}, distinct values "
            f"{len(set(vals))}, trajectory {runs(vals)}")
    if not all(math.isfinite(x) for x in losses + gnorms + [val]):
        fail("a loss or gradient norm is not finite")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        fail(f"the first loss {losses[0]} is not within 1 of "
             f"ln {cfg.vocab_size}")
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    want["flash_attention"] = TRAIN_LAYERS
    if launches != want:
        fail(f"flash kernel launches {launches}, expected {want}")
    for k, r in routes.items():
        if r != {"tensor_core": launches[k], "cuda_core": 0}:
            fail(f"{k} launches by route {r}: not all on the tensor cores")
    if not tr.ckpt.writes:
        fail("no checkpoint was written in training")
    if not all(len(set(v)) > 1 for v in knobs.values()):
        fail("a SmartConf knob never moved")

    tr.preemption.trigger()
    w0 = tr.ckpt.write_seconds
    tr.run(1)                       # writes the final state and stops
    say(f"[train] preemption checkpoint at step {tr.ckpt.last_saved}: "
        f"{tr.ckpt.write_seconds - w0:.1f} s")
    if tr.step != TRAIN_STEPS or tr.ckpt.last_saved != TRAIN_STEPS:
        fail("preemption did not checkpoint the final step and stop")
    t0 = time.perf_counter()
    fresh = Trainer(cfg, opt, tc, device=dev)
    load_s = time.perf_counter() - t0
    saved = dict(keyed_leaves({"params": tr.params, "opt": tr.opt_state}))
    back = dict(keyed_leaves({"params": fresh.params,
                              "opt": fresh.opt_state}))
    same = [k for k in saved if saved[k].dtype == back[k].dtype
            and torch.equal(saved[k], back[k])]
    stream = SyntheticTokens(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    stream.restore({"step": tr.data_step, "seed": 0})
    first = fresh.pipeline.get()
    resumed = fresh.data_step == tr.data_step and all(
        np.array_equal(first[n], a) for n, a in stream.next_batch().items())
    say(f"[train] a fresh Trainer restored step {fresh.step} in {load_s:.1f}"
        f" s (init included): {len(same)}/{len(saved)} leaves of params and "
        f"moments bit for bit; data stream at {fresh.data_step} (saved "
        f"{tr.data_step}), next batch the stream's: {resumed}")
    fresh.close()
    tr.close()
    shutil.rmtree(workdir)
    if fresh.step != tr.step or len(same) != len(saved) or not resumed:
        fail("the restored trainer differs from the one that was saved")
    return launches, dict(step_ms=med * 1e3, losses=losses)


def train_reckoning(cfg, n_par: int, largest: int, micro: int,
                    seq: int) -> dict:
    """What a training step should hold at its peak, reckoned from the
    shapes before it runs (bytes): weights and grads in bf16, f32 moments
    and accumulator; the input of every layer, which remat keeps; one
    recurrent layer's graph as the backward pass recomputes it (the
    RG-LRU's doubling scan saves two [micro, S, F] f32 tensors a level;
    ``time_mix_chunked`` about four [micro, L, L, H, N] f32 tensors a
    chunk, measured at small widths on the CPU); one loss chunk's f32
    logits, three times over (logits, softmax, gradient); and AdamW's f32
    temporaries, about three of the largest leaf at a time."""
    d = cfg.d_model
    kinds = {blocks.split_kind(k)[0] for k in cfg.block_pattern}
    layer = 0
    if "rglru" in kinds:
        f = cfg.num_heads * cfg.resolved_head_dim
        layer = 2 * math.ceil(math.log2(seq + 1)) * micro * seq * f * 4
    if "rwkv6" in kinds:
        layer = 4 * micro * seq * rwkv6_model.CHUNK * d * 4
    out = dict(state=n_par * (2 + 2 + 4 + 4 + 4),
               inputs=cfg.num_layers * micro * seq * d * 2, layer=layer,
               loss=3 * transformer.LOSS_CHUNK * cfg.vocab_size * 4,
               optimizer=3 * largest * 4)
    out["total"] = sum(out.values())
    return out


def phase_train_cut(dev, card, arch: str, layers: int) -> dict:
    """``arch`` at full width and ``layers`` layers (full depth does not
    fit: bf16 weights and grads with f32 moments), bf16, seeded random
    weights, through the Trainer as phase 9 runs yi-6b: TRAIN_STEPS AdamW
    steps at batch TRAIN_BATCH x TRAIN_SEQ in TRAIN_MICRO microbatches,
    remat, no checkpoint.  The recurrent layers train through their
    one-shot forms; every flash launch (recurrentgemma's swa layer, D
    256) must take the CUDA-core route.  Returns the flash launches."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    workdir = ROOT / "build" / f"chip_smoke_train_{arch}"
    shutil.rmtree(workdir, ignore_errors=True)
    tc = TrainerConfig(workdir=str(workdir), total_steps=TRAIN_STEPS,
                       ckpt_interval=1000, ckpt_keep=1,
                       batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                       n_micro=TRAIN_MICRO, seed=0)
    opt = adamw.AdamWConfig(warmup_steps=2, total_steps=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    tr = Trainer(cfg, opt, tc, device=dev)
    n_par = sum(p.numel() for p in tree_leaves(tr.params))
    micro = TRAIN_BATCH // TRAIN_MICRO
    reckon = train_reckoning(cfg, n_par,
                             max(p.numel() for p in tree_leaves(tr.params)),
                             micro, TRAIN_SEQ)
    tag = f"[train-{arch}]"
    say(f"{tag} {cfg.name} bf16, {layers} of {get_config(arch).num_layers} "
        f"layers {(cfg.block_pattern * layers)[:layers]} at full width: "
        f"{n_par / 1e9:.3f} B parameters; batch {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"in {TRAIN_MICRO} microbatches, remat {tc.remat}; reckoned peak "
        f"{reckon['total'] / 1e9:.2f} GB = "
        + " + ".join(f"{k} {v / 1e9:.2f}" for k, v in reckon.items()
                     if k != "total"))
    if reckon["total"] + held > torch.cuda.mem_get_info(dev)[1]:
        fail(f"{tag} the reckoned peak does not fit on the card")
    counted = (flash_attention, flash_attention_fwd_lse, flash_attention_dq,
               flash_attention_dkv)
    for fn in counted:
        fn.launches = 0
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        tr.run(1)                    # waits for the step's metrics
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) - held
    launches = {fn.__name__: fn.launches for fn in counted}
    routes = {fn.__name__: dict(fn.route_launches) for fn in counted}
    losses = [m["loss"] for m in tr.metrics_log]
    gnorms = [m["grad_norm"] for m in tr.metrics_log]
    med = float(np.median(step_s[1:]))
    swa = sum(blocks.split_kind(k)[0] in blocks.ATTN_KINDS
              for k in (cfg.block_pattern * layers)[:layers])
    per_step = {"flash_attention": 0,
                "flash_attention_fwd_lse": 2 * swa * TRAIN_MICRO,
                "flash_attention_dq": swa * TRAIN_MICRO,
                "flash_attention_dkv": swa * TRAIN_MICRO}
    say(f"{tag} losses {[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 4) for x in gnorms]}; ln {cfg.vocab_size} = "
        f"{math.log(cfg.vocab_size):.4f}")
    say(f"{tag} on {card}: step ms {[round(x * 1e3, 1) for x in step_s]}, "
        f"median of steps 2-{TRAIN_STEPS} {med * 1e3:.1f} ms = "
        f"{TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s")
    say(f"{tag} device memory: max_memory_allocated {peak / 1e9:.3f} GB "
        f"(less {held / 1e9:.3f} GB other phases hold) against the "
        f"reckoned {reckon['total'] / 1e9:.3f} GB")
    say(f"{tag} flash launches {launches} against {per_step} per step; by "
        f"route {routes}")
    tr.close()
    shutil.rmtree(workdir, ignore_errors=True)
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail("a loss or gradient norm is not finite")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        fail(f"the first loss {losses[0]} is not within 1 of "
             f"ln {cfg.vocab_size}")
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    if launches != want:
        fail(f"flash kernel launches {launches}, expected {want}")
    for k, r in routes.items():
        if r != {"tensor_core": 0, "cuda_core": launches[k]}:
            fail(f"{k} launches by route {r}: the D "
                 f"{cfg.resolved_head_dim} launches must take the CUDA-core "
                 "route")
    return launches


def phase_split_slice(dev, card, params, packed_tokens) -> dict:
    """Full yi-6b bf16 (phase 6's weights) through the launcher's own
    functions in the split modes, knobs live: ``prefill_mode="legacy"``
    (one-shot prefill per admitted request, then dense decode ticks) and
    ``"bucketed"`` (padded chunks at engine batch width on paged KV, then
    decode ticks), the same 8 requests as phase 6."""
    cfg = get_config("yi-6b")
    lens = prompt_lens()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]
    new_tokens, layers = 32, cfg.num_layers
    counted = (flash_attention, decode_attention, paged_decode_attention,
               paged_segment_attention, segment_attention)
    launches = {}
    # each run's greedy tokens by request, to compare the next runs with
    earlier = {"phase 6's packed run": packed_tokens}
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    for mode in SPLIT_MODES:
        # what other phases hold: the engine's own weights are in its goal
        held = torch.cuda.memory_allocated(dev) - weights
        eng = build_engine(cfg, max_batch=SLOTS, cache_len=CACHE_LEN,
                           budget_headroom_bytes=1e9, latency_goal_s=0.02,
                           device=dev, params=params, prefill_mode=mode)
        kv = "paged" if eng.paged else "dense"
        tag = f"[split-{mode}]"
        say(f"{tag} {cfg.name} bf16, {cfg.num_layers} layers, phase 6's "
            f"weights; prefill[{eng.prefill_impl}], kv[{kv}]; HBM goal "
            f"{eng.accountant.budget_bytes / 1e9:.3f} GB")
        if eng.paged != (mode == "bucketed") or eng.prefill_impl != mode:
            fail(f"prefill_mode={mode!r} resolved to prefill "
                 f"{eng.prefill_impl}, kv {kv}")
        if None in (eng.sc_queue, eng.sc_kv, eng.sc_chunk):
            fail("a SmartConf knob is not live")
        knobs = {"serve.max_queue_tokens": [eng.max_queue_tokens],
                 "serve.kv_block_budget": [eng.pool.max_blocks],
                 "serve.prefill_chunk_tokens": [eng.prefill_chunk]}
        tick_s = {"mixed": [], "decode-only": []}
        per_tick = []            # (dispatches, prefill calls, decoded)
        last, calls = [0.0], [0]

        def on_tick(e, st):
            for name, val in (("serve.max_queue_tokens", e.max_queue_tokens),
                              ("serve.kv_block_budget", e.pool.max_blocks),
                              ("serve.prefill_chunk_tokens",
                               e.prefill_chunk)):
                knobs[name].append(val)
            torch.cuda.synchronize()
            now = time.perf_counter()
            kind = "mixed" if st["prefill_issued_tokens"] else "decode-only"
            tick_s[kind].append(now - last[0])
            last[0] = now
            per_tick.append((st["dispatches"], e.prefill_calls - calls[0],
                             st["decode_tokens"] > 0))
            calls[0] = e.prefill_calls

        torch.cuda.reset_peak_memory_stats(dev)
        for fn in counted:
            fn.launches = 0
        flash_attention.route_launches = dict.fromkeys(
            flash_attention.route_launches, 0)
        t0 = last[0] = time.perf_counter()
        with first_token_top2(eng) as margins:
            stats = serve_requests(eng, prompts, new_tokens,
                                   on_tick=on_tick)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {fn.__name__: fn.launches for fn in counted}
        fwd_routes = dict(flash_attention.route_launches)
        say(f"{tag} " + summary(eng, len(prompts), len(stats)))
        n_done = len(eng.finished)
        gen_tokens = sum(len(r.generated) for r in eng.finished)
        n_decode = sum(d for _, _, d in per_tick)
        tokens = {r.req_id: list(r.generated) for r in eng.finished}
        say(f"{tag} finished {n_done}/{len(prompts)} in {len(stats)} ticks "
            f"({n_decode} with a decode step); dispatches per tick "
            f"{[d for d, _, _ in per_tick]}; prefill calls "
            f"{eng.prefill_calls}; kernel launches {got}, the flash "
            f"forward's by route {fwd_routes}; preemptions "
            f"{eng.preemptions}; HBM violations {eng.accountant.violations}")
        for k, vals in knobs.items():
            say(f"{tag} knob {k}: {vals[0]} -> {vals[-1]}, distinct values "
                f"{len(set(vals))}, trajectory {runs(vals)}")
        say(f"{tag} device memory: max_memory_allocated "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; accountant "
            f"peak {eng.accountant.peak_bytes / 1e9:.3f} GB")
        in_phase_peak(tag, dev, eng, held)
        gaps = {i: float(v[0] - v[1]) for i, v in sorted(margins.items())}
        say(f"{tag} first-token top-2 logit margin by request: "
            + ", ".join(f"{i}: {g:.4f}" for i, g in gaps.items())
            + f"; min {min(gaps.values()):.4f}, median "
            f"{float(np.median(list(gaps.values()))):.4f} (bf16 logits; "
            "information)")
        say(f"{tag} on {card}: {gen_tokens} tokens in {wall:.3f} s = "
            f"{gen_tokens / wall:.2f} tokens/s (first launches included); "
            f"TTFT mean {eng.ttft.mean() * 1e3:.1f} ms, p99 "
            f"{eng.ttft.p99() * 1e3:.1f} ms")
        for kind, ts in tick_s.items():
            if ts:
                say(f"{tag} {kind} ticks on {card}: {len(ts)}, mean "
                    f"{np.mean(ts) * 1e3:.1f} ms, first {ts[0] * 1e3:.1f} ms, "
                    f"max {max(ts) * 1e3:.1f} ms")
        for name, other in earlier.items():
            same = sum(a == b for i, g in tokens.items()
                       for a, b in zip(g, other[i]))
            first = sum(g[:1] == other[i][:1] for i, g in tokens.items())
            say(f"{tag} greedy tokens equal to {name}: {same}/{gen_tokens}, "
                f"first tokens {first}/{len(tokens)} (information: bf16 "
                "near-ties may differ; the CPU tests hold token identity)")
        earlier[f"the {mode} run"] = tokens
        if mode == "legacy":
            oneshot_vs_packed(card, cfg, params, prompts, CACHE_LEN, tag)
        if n_done != len(prompts):
            fail("not every request finished")
        if eng.accountant.violations:
            fail("the HBM goal was violated")
        if sorted(margins) != sorted(tokens):
            fail(f"first-token margins for {sorted(margins)}, requests "
                 f"{sorted(tokens)}")
        for r in eng.finished:
            g = np.asarray(r.generated)
            if len(g) != new_tokens or g.min() < 0 or g.max() >= cfg.vocab_size:
                fail(f"request {r.req_id} generated {g!r}")
        for disp, new_calls, decoded in per_tick:
            if mode == "bucketed" and (disp > 2 or new_calls > 1):
                fail(f"a bucketed tick made {disp} dispatches")
            if disp != new_calls + decoded:
                fail(f"a {mode} tick made {disp} dispatches for {new_calls} "
                     f"prefill calls and {int(decoded)} decode steps")
        if mode == "legacy":
            want = {"flash_attention": layers * eng.prefill_calls,
                    "decode_attention": layers * n_decode}
        else:
            want = {"paged_decode_attention": layers * n_decode}
        want = {fn.__name__: want.get(fn.__name__, 0) for fn in counted}
        if got != want:
            fail(f"{mode} kernel launches {got}, expected {want}")
        if fwd_routes != {"tensor_core": got["flash_attention"],
                          "cuda_core": 0}:
            fail(f"{mode} flash forward launches by route {fwd_routes}: not "
                 "all on the tensor cores")
        if mode == "legacy" and eng.prefill_calls != len(prompts):
            fail(f"{eng.prefill_calls} one-shot prefills for {len(prompts)} "
                 "requests")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        eng.close()
        del eng
        torch.cuda.empty_cache()
    # the same requests through yi-6b at full width, 2 layers, f32 (TF32
    # off since phase 5), in each mode: in f32 the split modes must give
    # the packed engine's tokens, as the CPU tests hold them to (in bf16,
    # above, near-ties of the random weights make the shares information)
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    p2 = zoo.init(cfg2, torch.Generator(device=dev).manual_seed(0), dev)
    f32 = {}
    for mode in ("packed",) + SPLIT_MODES:
        eng = build_engine(cfg2, max_batch=SLOTS, cache_len=CACHE_LEN,
                           budget_headroom_bytes=1e9, latency_goal_s=0.02,
                           device=dev, params=p2, prefill_mode=mode)
        serve_requests(eng, prompts, new_tokens)
        f32[mode] = {r.req_id: list(r.generated) for r in eng.finished}
        eng.close()
    for mode in SPLIT_MODES:
        same = sum(a == b for i, g in f32[mode].items()
                   for a, b in zip(g, f32["packed"][i]))
        say(f"[split-{mode}] yi-6b 2 layers f32 on {card}: greedy tokens "
            f"equal to the packed engine's {same}/{len(prompts) * new_tokens}")
        if f32[mode] != f32["packed"]:
            fail(f"{mode} and packed serving give other tokens in f32")
    del p2
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------- phase 11: SLO serving
def slo_tiers() -> tuple:
    return tuple(TierSpec(i, share, deadline_s=dl) for i, (share, dl)
                 in enumerate(zip(SLO_SHARES, SLO_DEADLINES)))


def shift_trace(horizon_s: float, calm_rps: float, storm_rps: float,
                seeds: tuple[int, int], burst_factor: float,
                burst_duty: float) -> list:
    """A calm poisson half, then a sustained bursty storm half: the regime
    shift no static setting matches on both sides."""
    half = horizon_s / 2.0
    shape = dict(prompt_lo=4, prompt_hi=24, prompt_alpha=1.3, new_lo=2,
                 new_hi=8, new_alpha=1.6, tiers=slo_tiers())
    calm = TraceConfig(process="poisson", rate_rps=calm_rps,
                       horizon_s=half, seed=seeds[0], **shape)
    storm = TraceConfig(process="bursty", rate_rps=storm_rps,
                        horizon_s=half, t_start=half, seed=seeds[1],
                        burst_factor=burst_factor, burst_period_s=half / 2.0,
                        burst_duty=burst_duty, **shape)
    return concat_traces(synthesize_trace(calm), synthesize_trace(storm))


def admission_trace(horizon_s: float = SLO_HORIZON_S) -> list:
    return shift_trace(horizon_s, SLO_CALM_RPS, SLO_STORM_RPS, (17, 23),
                       SLO_STORM_FACTOR, SLO_STORM_DUTY)


def router_trace(horizon_s: float = SLO_HORIZON_S) -> list:
    return shift_trace(horizon_s, ROUTER_CALM_RPS, ROUTER_STORM_RPS,
                       (31, 37), 2.0, 0.5)


def admission_chaos() -> ChaosSpec:
    """Slow ticks, a KV budget cut at tick 30 restored at 60, a NaN window
    on the latency sensors at 40, one worker preemption at 20."""
    return ChaosSpec(
        seed=5, slow_tick_prob=0.04, slow_tick_s=0.15,
        budget_cut_tick=30, budget_cut_frac=0.6, budget_restore_tick=60,
        sensor_fault_tick=40, sensor_fault_ticks=10, sensor_fault_mode="nan",
        preempt_tick=20, preempt_resume_ticks=3)


def router_sensor_chaos() -> ChaosSpec:
    """The router's own NaN window: its sensor for replica 1."""
    return ChaosSpec(seed=7, sensor_fault_tick=40, sensor_fault_ticks=10,
                     sensor_fault_mode="nan",
                     sensor_names=("route.replica1.ttft_p99_s",))


def nan_window(spec: ChaosSpec) -> range:
    return range(spec.sensor_fault_tick,
                 spec.sensor_fault_tick + spec.sensor_fault_ticks)


def timed_ticks(obj, device) -> list:
    """Wraps ``obj.tick``: each tick's stats and its wall ms, device work
    complete."""
    log = []
    tick = obj.tick

    def timed():
        t0 = time.perf_counter()
        st = tick()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        log.append((st, (time.perf_counter() - t0) * 1e3))
        return st

    obj.tick = timed
    return log


def store_cuts(eng, device) -> list:
    """Wraps ``eng.set_kv_budget`` (the chaos budget cut and restore):
    the block store's capacity and bytes, and the device's allocated
    bytes, before and after each call."""
    log = []
    inner = eng.set_kv_budget

    def state():
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(eng.caches))
        mem = (torch.cuda.memory_allocated(device)
               if device.type == "cuda" else 0)
        return eng.pool.capacity, nbytes, mem

    def cut(blocks):
        before = state()
        inner(blocks)
        log.append((blocks, before, state()))

    eng.set_kv_budget = cut
    return log


def drive_lane(target, arrivals, vc, chaos, device,
               cost: TickCostModel | None = None) -> dict:
    """The open-loop driver over ``target`` (an engine or the router) at
    the lanes' cost model (or ``cost``); besides its summary, every tick's
    stats but ``hbm`` (the one weight-dependent key) and wall ms by kind
    of tick."""
    log = timed_ticks(target, device)
    drv = OpenLoopDriver(target, arrivals, clock=vc,
                         cost=cost or TickCostModel(**SLO_COST), chaos=chaos,
                         drain_s=max(SLO_DEADLINES) + 8.0)
    t0 = time.perf_counter()
    out = drv.run()
    out["wall_s"] = time.perf_counter() - t0
    out["per_tick"] = [{k: v for k, v in st.items() if k != "hbm"}
                       for st, _ in log]
    out["tick_ms"] = {"mixed": [], "decode-only": []}
    for st, ms in log:
        if st["dispatches"]:
            out["tick_ms"]["mixed" if st["prefill_issued_tokens"]
                           else "decode-only"].append(ms)
    return out


def run_admission(cfg, params, device, trace, *, adaptive: bool,
                  admit_tier_max: int | None = None,
                  telemetry_dir: str | None = None) -> dict:
    """``bench_slo._run_policy`` on the port: one engine under the
    admission lane's trace, chaos schedule and virtual-time cost model."""
    device = torch.device(device)
    vc = VirtualClock()
    tel = Telemetry(enabled=True, clock=vc) if telemetry_dir else None
    eng = ServeEngine(cfg, params, device=device, options=ServeOptions(
        max_batch=SLO_MAX_BATCH, cache_len=SLO_CACHE_LEN, block_tokens=16,
        enable_smartconf=adaptive,
        slo=SLOSpec(ttft_s=SLO_TTFT_S, window=SLO_WINDOW),
        num_tiers=len(SLO_SHARES), admit_tier_max=admit_tier_max,
        telemetry=tel), registry=ConfRegistry(), clock=vc)
    monkey = ChaosMonkey(admission_chaos()).install(eng)
    cuts = store_cuts(eng, device)
    out = drive_lane(eng, as_requests(trace, vocab=cfg.vocab_size, seed=1),
                     vc, monkey, device)
    out["chaos_events"] = len(monkey.events)
    out["chaos_schedule"] = list(monkey.events)
    out["sensor_faults"] = sum(sc.sensor_faults for sc in eng.controllers())
    out["store_cuts"] = cuts
    if tel is not None:
        out["telemetry_paths"] = tel.write(telemetry_dir)
    eng.close()
    return out


def run_router(cfg, params, device, trace, *, adaptive: bool,
               weights=None, telemetry_dir: str | None = None) -> dict:
    """``bench_slo._run_router_policy`` on the port: two replicas sharing
    ``params`` behind one router, engine-level SmartConf off (the
    policies differ only in the router's weights); replica 1 runs one
    tick in ``ROUTER_STALL_PERIOD`` all storm long, is preempted at tick
    12, and the router's sensor for it reads NaN for ticks 40-49."""
    device = torch.device(device)
    vc = VirtualClock()
    tel = Telemetry(enabled=True, clock=vc) if telemetry_dir else None
    slo = SLOSpec(ttft_s=SLO_TTFT_S, window=SLO_WINDOW)
    engines = [ServeEngine(cfg, params, device=device, options=ServeOptions(
        max_batch=SLO_MAX_BATCH, cache_len=SLO_CACHE_LEN, block_tokens=16,
        enable_smartconf=False, prefill_mode="packed", slo=slo,
        num_tiers=len(SLO_SHARES)), clock=vc) for _ in range(2)]
    half = SLO_HORIZON_S / 2.0

    def stall(tick):
        if vc.now >= half and tick % ROUTER_STALL_PERIOD:
            return 1
        return None

    rt = ReplicaRouter(engines, clock=vc, slo=slo, adaptive=adaptive,
                       weights=weights, telemetry=tel, stall=stall)
    m_eng = ChaosMonkey(ChaosSpec(
        seed=5, slow_tick_prob=0.03, slow_tick_s=0.1,
        preempt_tick=12, preempt_resume_ticks=3)).install(engines[1])
    m_rt = ChaosMonkey(router_sensor_chaos()).install(rt)
    out = drive_lane(rt, as_requests(trace, vocab=cfg.vocab_size, seed=1),
                     vc, lambda d, t: m_eng(d, t) + m_rt(d, t), device)
    out["chaos_events"] = len(m_eng.events) + len(m_rt.events)
    out["sensor_faults"] = rt.sensor_faults
    out["final_weights"] = list(rt.weights)
    out["reroutes"] = rt.reroutes
    out["stalled_ticks"] = rt.stalled_ticks
    if tel is not None:
        out["telemetry_paths"] = tel.write(telemetry_dir)
    rt.close()
    return out


def read_audit(paths: dict) -> list[dict]:
    with open(paths["audit"]) as fh:
        return [json.loads(line) for line in fh]


def admission_audit_faults(r: dict) -> list[str]:
    """``bench_slo._assert_telemetry`` from the written artifacts: every
    chaos fault followed by a Decision within ``SLO_REACTION_TICKS``, a
    last-known-good fallback of ``serve.admit_tier_max`` in the NaN
    window, chaos marks on the trace.  Returns what failed."""
    audit = read_audit(r["telemetry_paths"])
    ticks = sorted({d["tick"] for d in audit})
    bad = [f"chaos event {name} at tick {t} has no Decision within "
           f"{SLO_REACTION_TICKS} ticks" for t, name in r["chaos_schedule"]
           if not any(t <= d <= t + SLO_REACTION_TICKS for d in ticks)]
    window = nan_window(admission_chaos())
    if not any(d["fallback"] and d["conf"] == "serve.admit_tier_max"
               and d["tick"] in window for d in audit):
        bad.append("no fallback Decision of serve.admit_tier_max in the "
                   "NaN window")
    with open(r["telemetry_paths"]["trace"]) as fh:
        events = json.load(fh)["traceEvents"]
    if not any(e["name"].startswith("chaos:") for e in events):
        bad.append("trace.json carries no chaos marks")
    return bad


def router_audit_faults(r: dict) -> list[str]:
    """The replica lane's gates on the written audit trail: weight
    Decisions, insane readings and a fallback inside the router's NaN
    window."""
    wdec = [d for d in read_audit(r["telemetry_paths"])
            if d["conf"].startswith("route.replica_weights")]
    if not wdec:
        return ["no route.replica_weights Decisions in audit.jsonl"]
    bad = []
    window = nan_window(router_sensor_chaos())
    if not any(d["fallback"] and d["tick"] in window for d in wdec):
        bad.append("the router's NaN window engaged no fallback")
    if not any(not d["sane"] for d in wdec):
        bad.append("no insane reading in the router's audit trail")
    return bad


def lane_faults(res: dict, lane: str) -> list[str]:
    """The bench's gates on one lane's runs: no unhandled exception, the
    chaos schedule fired, the adaptive run saw sensor faults, adaptive
    goodput above every static policy's."""
    bad = []
    for name, r in res.items():
        if r["unhandled"]:
            bad.append(f"{lane} {name}: unhandled {r['unhandled']}")
        if not r["chaos_events"]:
            bad.append(f"{lane} {name}: the chaos schedule never fired")
    ad = res["adaptive"]
    if not ad["sensor_faults"]:
        bad.append(f"{lane}: the NaN window never reached a controller")
    for name, r in res.items():
        if name != "adaptive" and not ad["goodput_tps"] > r["goodput_tps"]:
            bad.append(f"{lane}: adaptive goodput {ad['goodput_tps']} tok/s "
                       f"not above {name}'s {r['goodput_tps']}")
    return bad


def lane_rows(tag: str, res: dict, card: str, weights_gb: float) -> None:
    for name, r in res.items():
        ms = {k: (f"{statistics.median(v):.1f} ms (x{len(v)})" if v
                  else "none") for k, v in r["tick_ms"].items()}
        say(f"{tag} {name}: goodput {r['goodput_tps']} tok/s, throughput "
            f"{r['throughput_tps']} tok/s (virtual); finished "
            f"{r['finished']}, rejected {r['reject_counts']}, preemptions "
            f"{r['preemptions']}, sensor faults {r['sensor_faults']}, chaos "
            f"events {r['chaos_events']}; on {card}: {r['wall_s']:.2f} s "
            f"wall, {r['ticks']} ticks, median mixed tick {ms['mixed']}, "
            f"decode-only {ms['decode-only']}; in-phase peak "
            f"{r['peak_gb']:.3f} GB beside {weights_gb:.3f} GB of weights")
    best = max((n for n in res if n != "adaptive"),
               key=lambda n: res[n]["goodput_tps"])
    ad = res["adaptive"]["goodput_tps"]
    say(f"{tag} adaptive {ad} tok/s against the best static, {best}, "
        f"{res[best]['goodput_tps']} tok/s: margin "
        f"{ad / max(res[best]['goodput_tps'], 1e-9)}x")


def phase_slo(dev, card, params) -> dict:
    """``bench_slo``'s admission lane on full yi-6b (phase 6's weights)
    and its replica lane on 4 of its layers, each adaptive policy beside
    the static ones, every tick one packed dispatch on the card; the
    adaptive admission run's trajectory against the same run of the port
    on the CPU at ``reduced()`` size."""
    cfg = get_config("yi-6b")
    counted = (paged_segment_attention, paged_decode_attention)
    launches = dict.fromkeys((f.__name__ for f in counted), 0)
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    held = torch.cuda.memory_allocated(dev) - weights
    routes = dict.fromkeys(paged_segment_attention.route_launches, 0)

    def run(fn, *a, **kw):
        # each run sets the counts it reads to 0 before driving its path
        for f in counted:
            f.launches = 0
        paged_segment_attention.route_launches = dict.fromkeys(routes, 0)
        torch.cuda.reset_peak_memory_stats(dev)
        r = fn(*a, **kw)
        r["peak_gb"] = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
        for f in counted:
            launches[f.__name__] += f.launches
        for k, n in paged_segment_attention.route_launches.items():
            routes[k] += n
        return r

    trace = admission_trace()
    say(f"[slo] {cfg.name} {cfg.dtype}, {cfg.num_layers} layers, phase 6's "
        f"weights; admission lane: {len(trace)} arrivals over "
        f"{SLO_HORIZON_S} virtual s, max_batch {SLO_MAX_BATCH}, cache_len "
        f"{SLO_CACHE_LEN}, TTFT SLO {SLO_TTFT_S} s, window {SLO_WINDOW}")
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        res = {"adaptive": run(run_admission, cfg, params, dev, trace,
                               adaptive=True,
                               telemetry_dir=f"{tmp}/admission")}
        for name, tier in SLO_STATIC.items():
            res[name] = run(run_admission, cfg, params, dev, trace,
                            adaptive=False, admit_tier_max=tier)
        bad += lane_faults(res, "admission")
        bad += admission_audit_faults(res["adaptive"])
        lane_rows("[slo]", res, card, weights / 1e9)
        for blocks, (c0, b0, m0), (c1, b1, m1) in \
                res["adaptive"]["store_cuts"]:
            say(f"[slo] set_kv_budget({blocks}): store {c0} -> {c1} blocks, "
                f"{b0 / 1e6:.2f} -> {b1 / 1e6:.2f} MB; memory_allocated "
                f"{m0 / 1e9:.4f} -> {m1 / 1e9:.4f} GB")
        cut = res["adaptive"]["store_cuts"][0]
        if not (cut[2][0] < cut[1][0] and cut[2][1] < cut[1][1]
                and cut[2][2] < cut[1][2]):
            bad.append(f"the budget cut did not shrink the block store on "
                       f"the card: {cut}")

        # the same adaptive run of the port on the CPU at reduced() size:
        # no controller reading depends on a token's value
        small = reduced(cfg)
        cpu = torch.device("cpu")
        t0 = time.perf_counter()
        ref = run_admission(small, zoo.init(
            small, torch.Generator().manual_seed(0), cpu), cpu, trace,
            adaptive=True)
        ad = res["adaptive"]
        same = [k for k in ("per_tick", "goodput_tokens_by_tier",
                            "reject_counts", "preemptions", "sensor_faults",
                            "chaos_schedule", "ticks", "finished")
                if ad[k] == ref[k]]
        say(f"[slo] the adaptive run against the port's on the CPU at "
            f"reduced() size ({time.perf_counter() - t0:.1f} s): "
            f"{ad['ticks']} ticks against {ref['ticks']}; admit_tier_max by "
            f"tick {runs([st['admit_tier_max'] for st in ad['per_tick']])}; "
            f"goodput tokens by tier {ad['goodput_tokens_by_tier']} against "
            f"{ref['goodput_tokens_by_tier']}; equal: {same}")
        if len(same) != 8:
            bad.append("the adaptive admission run left the CPU's "
                       "trajectory")

        rcfg = dataclasses.replace(cfg, num_layers=ROUTER_LAYERS)
        rparams = dict(params, groups=[tree_map(lambda t: t[:ROUTER_LAYERS],
                                                g)
                                       for g in params["groups"]])
        rtrace = router_trace()
        say(f"[slo-router] {cfg.name} {cfg.dtype} at full width, {ROUTER_LAYERS} "
            f"of {cfg.num_layers} layers, two replicas sharing the "
            f"weights; {len(rtrace)} arrivals")
        rres = {"adaptive": run(run_router, rcfg, rparams, dev, rtrace,
                                adaptive=True,
                                telemetry_dir=f"{tmp}/router")}
        for name, w in ROUTER_SPLITS.items():
            rres[f"static_{name}"] = run(run_router, rcfg, rparams, dev,
                                         rtrace, adaptive=False, weights=w)
        bad += lane_faults(rres, "router")
        bad += [f"router {name}: the straggler stall never engaged"
                for name, r in rres.items() if not r["stalled_ticks"]]
        bad += router_audit_faults(rres["adaptive"])
        lane_rows("[slo-router]", rres, card, weights / 1e9)
        say(f"[slo-router] adaptive final weights "
            f"{rres['adaptive']['final_weights']}, reroutes "
            f"{rres['adaptive']['reroutes']}, stalled ticks "
            f"{rres['adaptive']['stalled_ticks']}")
    say(f"[slo] kernel launches {launches}; paged segment launches by "
        f"route {routes}")
    if not all(launches.values()):
        bad.append(f"a kernel of the path never launched: {launches}")
    if routes["tensor_core"] != launches["paged_segment_attention"]:
        bad.append(f"a paged segment launch left the tensor cores: {routes}")
    if bad:
        fail("; ".join(bad))
    return launches


@contextlib.contextmanager
def first_token_top2(eng):
    """While open, one split-mode engine's prefill step keeps, by request
    id, the two largest logits of the row its first token is the argmax of
    (device tensors: no synchronisation in the serving loop).  Legacy: each
    request's one-shot ``zoo.prefill``; bucketed: the request's last
    ``zoo.prefill_chunk`` row, the chunk that completes its prompt.  On
    exit the engine's own method is back (no reference cycle keeps the
    engine alive)."""
    out = {}

    def top2(row):
        return row.float().topk(2).values

    if eng.prefill_impl == "legacy":
        step = eng._do_prefill_legacy

        def legacy(req):
            real = zoo.prefill

            def spy(*a, **k):
                logits, one = real(*a, **k)
                out[req.req_id] = top2(logits[0])
                return logits, one
            zoo.prefill = spy
            try:
                step(req)
            finally:
                zoo.prefill = real
        name, wrapper = "_do_prefill_legacy", legacy
    else:
        step = eng._step_prefill_chunk

        def chunk(*args):
            real, slots = zoo.prefill_chunk, dict(eng.prefilling)

            def spy(*a, **k):
                logits = real(*a, **k)
                for slot, req in slots.items():
                    out[req.req_id] = top2(logits[slot])
                return logits
            zoo.prefill_chunk = spy
            try:
                step(*args)
            finally:
                zoo.prefill_chunk = real
        name, wrapper = "_step_prefill_chunk", chunk
    setattr(eng, name, wrapper)
    try:
        yield out
    finally:
        delattr(eng, name)


def device_breakdown(prof) -> tuple[dict, float, float]:
    """From a ``torch.profiler`` run: device ms by kind of kernel, the
    device's busy ms (the union of its kernels' intervals) and the span
    from the first kernel's start to the last one's end."""
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kinds: dict[str, float] = {}
    for e in evs:
        n = e.name
        kind = ("flash forward" if "flash_fwd_kernel" in n
                else "flash dQ" if "flash_dq_kernel" in n
                else "flash dK/dV" if "flash_dkv_kernel" in n
                else "matrix products" if any(
                    w in n for w in ("gemm", "nvjet", "cutlass", "xmma"))
                else "torch elementwise, reductions, copies"
                if "at::native" in n else "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in evs):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    span = (max(e.time_range.end for e in evs)
            - min(e.time_range.start for e in evs)) if evs else 0.0
    return (dict(sorted(kinds.items(), key=lambda kv: -kv[1])), busy / 1e3,
            span / 1e3)


def runs(vals) -> str:
    """A knob's trajectory as value (xN) runs, first tick first."""
    out = []
    for v in vals:
        if out and out[-1][0] == v:
            out[-1][1] += 1
        else:
            out.append([v, 1])
    return ", ".join(f"{v} (x{n})" if n > 1 else f"{v}" for v, n in out)


def in_phase_peak(tag: str, dev, eng, held: int) -> None:
    """A serving phase's in-phase peak device memory beside its HBM goal:
    ``max_memory_allocated`` since the phase's reset, less ``held``, what
    other phases keep resident (phase 6's weights in phases 7 and 8).
    Information, not a check: the ledger the goal is enforced on counts
    weights and KV, not activations (ROADMAP Queue 3)."""
    peak = torch.cuda.max_memory_allocated(dev) - held
    goal = eng.accountant.budget_bytes
    say(f"{tag} in-phase peak {peak / 1e9:.3f} GB (max_memory_allocated "
        f"less {held / 1e9:.3f} GB other phases hold) beside the HBM goal "
        f"{goal / 1e9:.3f} GB: {(peak - goal) / 1e9:+.3f} GB")


def rows_cost(eng, card, kind: str, tag: str) -> None:
    """What the reference's B x P recurrent rows cost on a full-width tick:
    one ``kind`` layer over a stream as wide as the engine's packed width,
    cut into one segment per slot (slots x width rows through the layer),
    against the same tokens as one row, on a scratch copy of the layer's
    state; then times the arch's number of such layers."""
    cfg = eng.cfg
    j = list(cfg.block_pattern).index(kind)
    p = tree_map(lambda t: t[0], eng.params["groups"][j])
    state = tree_map(lambda t: t[0].clone(), eng.caches["groups"][j])
    slots, width = eng.max_batch, eng.packed_width
    n = width // slots
    layers = sum(k == kind for k in (cfg.block_pattern * cfg.num_layers)
                 [:cfg.num_layers])
    dev = eng.device
    slot = torch.arange(slots, dtype=torch.int32,
                        device=dev).repeat_interleave(n)
    pos = torch.arange(n, dtype=torch.int32, device=dev).repeat(slots)
    start = torch.zeros(slots, dtype=torch.int32, device=dev)
    seg_len = torch.full((slots,), n, dtype=torch.int32, device=dev)
    x = torch.randn(1, width, cfg.d_model, device=dev, dtype=torch.bfloat16)
    one = tree_map(lambda t: t[:1].clone(), state)
    t_pos = torch.arange(width, dtype=torch.int32, device=dev)[None]
    packed = time_ms(lambda: blocks.block_apply_packed(
        cfg, kind, p, x, pos, slot, start, seg_len, state), iters=5,
        warmup=1)
    row = time_ms(lambda: blocks.block_apply_chunk(
        cfg, kind, p, x, t_pos, torch.ones_like(t_pos, dtype=torch.bool),
        one), iters=5, warmup=1)
    say(f"[{tag}] B x P recurrent rows on {card}: one {kind} layer over a "
        f"{width}-lane stream of {slots} segments takes {packed:.3f} ms "
        f"({slots} x {width} rows) against {row:.3f} ms for the same "
        f"tokens as one row; x {layers} layers: {layers * packed:.1f} ms "
        f"against {layers * row:.1f} ms per full-width mixed tick")

# ------------------------------------ phase 12: prefix cache, speculation
def cycle_map() -> dict:
    """The token map markov weights decode: 1 -> 2 -> ... -> 12 -> 1."""
    cyc = np.arange(1, SPEC_CYCLE + 1)
    return {int(cyc[i]): int(cyc[(i + 1) % SPEC_CYCLE])
            for i in range(SPEC_CYCLE)}


class OracleDrafter:
    """Replays a reference continuation as the draft, corrupting one
    token of every ``corrupt_every``-th proposal, so mid-draft rejections
    come on a fixed schedule (the reference's test drafter): correct
    drafts are accepted whole, corrupted ones rejected at the corrupted
    offset."""

    def __init__(self, refs, vocab, corrupt_every=0):
        self.refs = {r: [int(t) for t in toks] for r, toks in refs.items()}
        self.vocab = int(vocab)
        self.corrupt_every = corrupt_every
        self.calls = 0
        self._rid = {}
        self._emitted = {}

    def begin(self, slot, req):
        self._rid[slot] = req.req_id
        self._emitted[slot] = 0

    def extend(self, slot, toks):
        if slot in self._emitted:
            self._emitted[slot] += int(np.asarray(toks).size)

    def drop(self, slot):
        self._rid.pop(slot, None)
        self._emitted.pop(slot, None)

    def propose(self, slot, k):
        rid = self._rid.get(slot)
        if rid is None or k <= 0:
            return np.zeros(0, np.int32)
        e = self._emitted[slot]
        d = np.asarray(self.refs.get(rid, [])[e:e + k], np.int32)
        self.calls += 1
        if (self.corrupt_every and d.size
                and self.calls % self.corrupt_every == 0):
            d = d.copy()
            j = d.size // 2
            d[j] = (int(d[j]) + 1) % self.vocab   # not the model's argmax
        return d


def prefix_prompts(vocab: int) -> list[list[np.ndarray]]:
    """PREFIX_GROUPS groups of PREFIX_PER_GROUP prompts from seed 12: the
    group's preamble, then each request's own tail."""
    rng = np.random.default_rng(12)
    groups = []
    for _ in range(PREFIX_GROUPS):
        pre = rng.integers(0, vocab, PREFIX_LEN)
        groups.append([np.concatenate([pre, rng.integers(
            0, vocab, int(rng.integers(PREFIX_TAIL[0], PREFIX_TAIL[1] + 1)))])
            .astype(np.int32) for _ in range(PREFIX_PER_GROUP)])
    return groups


def drive_prefix(eng, groups, new_tokens: int) -> dict:
    """Each group's first request runs to its first token (its prompt
    enters the cache when its prefill completes), then the other requests
    are submitted; ticks until all finish.  Returns the per-tick stats
    and wall ms, the tokens by request, the borrowers' TTFT and their
    admission receipts' hits, and the host seconds the scheduling's store
    growth and copy-on-write took (device work complete)."""
    log = timed_ticks(eng, eng.device)
    host = {"_grow_store_for": 0.0, "_apply_cow": 0.0}
    for name in host:
        def timed(*a, _fn=getattr(eng, name), _name=name):
            t0 = time.perf_counter()
            out = _fn(*a)
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            host[_name] += time.perf_counter() - t0
            return out
        setattr(eng, name, timed)
    per = len(groups[0])
    firsts = [Request(g * per, grp[0], new_tokens)
              for g, grp in enumerate(groups)]
    for r in firsts:
        eng.submit(r)
    while (any(r.first_token_t is None for r in firsts)
           and len(log) < 2000):
        eng.tick()
    rest = [Request(g * per + i, grp[i], new_tokens)
            for g, grp in enumerate(groups) for i in range(1, per)]
    probes = [eng.submit(r).prefix_hit_tokens for r in rest]
    total = len(firsts) + len(rest)
    while len(eng.finished) < total and len(log) < 2000:
        eng.tick()
    for name in ("tick", *host):   # the wrappers' cycles would keep it
        delattr(eng, name)
    return {"host_s": host,"stats": [st for st, _ in log], "ms": [ms for _, ms in log],
            "tokens": {r.req_id: list(r.generated) for r in eng.finished},
            "ttft": [r.first_token_t - r.submitted_t for r in rest
                     if r.first_token_t is not None],
            "probes": probes, "finished": len(eng.finished),
            "total": total}


COUNTED = (paged_segment_attention, paged_decode_attention,
           segment_attention, rglru_scan_state, rwkv6_scan_state)


@contextlib.contextmanager
def counted_launches(total: dict):
    """Sets every kernel's launch count and the paged segment kernel's
    route counts to 0, and on exit adds what the block launched to
    ``total`` (by kernel name, routes under ``"routes"``)."""
    for f in COUNTED:
        f.launches = 0
    routes = paged_segment_attention.route_launches
    paged_segment_attention.route_launches = dict.fromkeys(routes, 0)
    try:
        yield
    finally:
        for f in COUNTED:
            total[f.__name__] = total.get(f.__name__, 0) + f.launches
        r = total.setdefault("routes", {})
        for k, n in paged_segment_attention.route_launches.items():
            r[k] = r.get(k, 0) + n


def f32_cut(params, layers: int) -> dict:
    """A ``layers``-layer cut of a group-stacked bf16 tree, in f32."""
    return tree_map(lambda t: t.float(),
                    dict(params, groups=[tree_map(lambda t: t[:layers], g)
                                         for g in params["groups"]]))


def tick_ms(res: dict) -> str:
    kinds = {"mixed": [], "decode-only": []}
    for st, ms in zip(res["stats"], res["ms"]):
        if st["dispatches"]:
            kinds["mixed" if st["prefill_issued_tokens"]
                  else "decode-only"].append(ms)
    return ", ".join(f"{k} {statistics.median(v):.1f} ms (x{len(v)})"
                     for k, v in kinds.items() if v)


def phase_prefix(dev, card, params, launches: dict) -> None:
    """12a: the prefix cache on full yi-6b, cold (cache off) then warm,
    three knobs and sc_cache live; then both on a 2-layer f32 cut, where
    warm tokens must equal cold ones."""
    cfg = get_config("yi-6b")
    groups = prefix_prompts(cfg.vocab_size)
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    held = torch.cuda.memory_allocated(dev) - weights
    say(f"[prefix] {cfg.name} bf16, {cfg.num_layers} layers, phase 6's "
        f"weights; {PREFIX_GROUPS} groups of {PREFIX_PER_GROUP}: preambles "
        f"of {PREFIX_LEN} tokens, prompts "
        f"{[[len(p) for p in g] for g in groups]}, {PREFIX_NEW} new each")
    res, bad = {}, []
    for warm in (False, True):
        tag = "warm" if warm else "cold"
        eng = build_engine(cfg, max_batch=SLOTS, cache_len=CACHE_LEN,
                           budget_headroom_bytes=PREFIX_HEADROOM,
                           latency_goal_s=PREFIX_LATENCY_GOAL_S, device=dev,
                           params=params, kv_mode="paged",
                           prefix_cache=warm)
        torch.cuda.reset_peak_memory_stats(dev)
        got = {}
        t0 = time.perf_counter()
        with counted_launches(got):
            r = drive_prefix(eng, groups, PREFIX_NEW)
            torch.cuda.synchronize()
        r["wall_s"] = time.perf_counter() - t0
        for k, n in got.items():
            if k != "routes":
                launches[k] = launches.get(k, 0) + n
        r.update(launches=got, hits=eng.prefix_hit_tokens_total,
                 cow=eng.cow_copied_blocks,
                 violations=eng.accountant.violations)
        res[tag] = r
        gen = sum(len(t) for t in r["tokens"].values())
        issued = sum(st["prefill_issued_tokens"] for st in r["stats"])
        live = sum(st["prefill_tokens"] for st in r["stats"])
        say(f"[prefix] {tag}: " + summary(eng, r["total"], len(r["stats"])))
        say(f"[prefix] {tag} on {card}: {gen} tokens in {r['wall_s']:.3f} "
            f"s = {gen / r['wall_s']:.2f} tokens/s; ticks {tick_ms(r)}; "
            f"prefill tokens {live} of {issued} lanes issued; borrowers' "
            f"TTFT mean {np.mean(r['ttft'] or [0]) * 1e3:.1f} ms, max "
            f"{max(r['ttft'] or [0]) * 1e3:.1f} ms; hit tokens {r['hits']} "
            f"(receipts {r['probes']}), COW copies {r['cow']}; kernel "
            f"launches {got}; serve.kv_cache_share by tick "
            f"{runs([round(st['kv_cache_share'], 3) for st in r['stats']])}"
            f"; serve.prefill_chunk_tokens at the end {eng.prefill_chunk}")
        mixed = [(round(ms, 1), st["prefill_tokens"], st["prefix_hit_tokens"])
                 for st, ms in zip(r["stats"], r["ms"])
                 if st["prefill_issued_tokens"]]
        say(f"[prefix] {tag} mixed ticks on {card} (ms, prefill tokens, hit "
            f"tokens): {mixed}; store growth "
            f"{r['host_s']['_grow_store_for'] * 1e3:.1f} ms, copy-on-write "
            f"{r['host_s']['_apply_cow'] * 1e3:.1f} ms")
        in_phase_peak(f"[prefix] {tag}", dev, eng, held)
        if r["finished"] != r["total"]:
            bad.append(f"{tag}: {r['finished']}/{r['total']} finished")
        if r["violations"]:
            bad.append(f"{tag}: {r['violations']} HBM violations")
        if max(st["dispatches"] for st in r["stats"]) > 1:
            bad.append(f"{tag}: more than one dispatch in a tick")
        if got["routes"]["tensor_core"] != got["paged_segment_attention"]:
            bad.append(f"{tag}: a paged segment launch left the tensor "
                       f"cores: {got['routes']}")
        eng.close()
        del eng
    borrowers = PREFIX_GROUPS * (PREFIX_PER_GROUP - 1)
    if res["warm"]["hits"] != borrowers * PREFIX_LEN:
        bad.append(f"warm hit tokens {res['warm']['hits']}, not "
                   f"{borrowers * PREFIX_LEN}")
    if res["warm"]["cow"] != borrowers:
        bad.append(f"warm COW copies {res['warm']['cow']}, not {borrowers}")
    if res["cold"]["hits"] or res["cold"]["cow"]:
        bad.append("the cold run hit a cache it does not have")
    same = sum(a == b for i, g in res["warm"]["tokens"].items()
               for a, b in zip(g, res["cold"]["tokens"][i]))
    say(f"[prefix] bf16 warm tokens equal to cold ones: {same}/"
        f"{len(groups) * PREFIX_PER_GROUP * PREFIX_NEW} (near-ties of the "
        f"random weights: information)")
    cut_cfg = dataclasses.replace(cfg, num_layers=SPEC_CUT_LAYERS,
                                  dtype="float32")
    cut = f32_cut(params, SPEC_CUT_LAYERS)
    out = {}
    for warm in (False, True):
        eng = build_engine(cut_cfg, max_batch=SLOTS, cache_len=CACHE_LEN,
                           budget_headroom_bytes=PREFIX_HEADROOM,
                           latency_goal_s=PREFIX_LATENCY_GOAL_S, device=dev,
                           params=cut, kv_mode="paged",
                           prefix_cache=warm)
        with counted_launches(launches):
            out[warm] = drive_prefix(eng, groups, PREFIX_NEW)
        out[warm]["hits"] = eng.prefix_hit_tokens_total
        eng.close()
    say(f"[prefix] {SPEC_CUT_LAYERS} layers f32 on {card}: warm tokens equal "
        f"to cold ones: {out[True]['tokens'] == out[False]['tokens']} (hit "
        f"tokens {out[True]['hits']})")
    if out[True]["tokens"] != out[False]["tokens"]:
        bad.append("warm tokens differ from cold ones on the f32 cut")
    del cut
    launches.pop("routes", None)
    torch.cuda.empty_cache()
    if bad:
        fail("; ".join(bad))


def spec_prompts() -> list[np.ndarray]:
    """SPEC_PROMPTS forward laps of the cycle, 40-200 tokens from seed 12,
    each starting at its own place on the cycle."""
    rng = np.random.default_rng(12)
    cyc = np.arange(1, SPEC_CYCLE + 1, dtype=np.int32)
    return [cyc[(i + np.arange(int(rng.integers(40, 201)))) % SPEC_CYCLE]
            for i in range(SPEC_PROMPTS)]


def serve_spec(cfg, params, dev, prompts, new_tokens, *, depth=0,
               adaptive=False, drafter=None, max_batch=SLOTS,
               cache_len=CACHE_LEN, **options) -> dict:
    """One engine (HBM goal weights + 1 GB, no decode-latency goal, so
    the depth answers to the accept rate alone) over ``prompts``; the
    per-tick stats, wall ms, tokens, and the spec counters."""
    eng = build_engine(cfg, max_batch=max_batch, cache_len=cache_len,
                       budget_headroom_bytes=1e9, latency_goal_s=None,
                       device=dev, params=params, spec_depth=depth,
                       spec_adaptive=adaptive, **options)
    if drafter is not None:
        eng._drafter = drafter
    log = timed_ticks(eng, dev)
    t0 = time.perf_counter()
    serve_requests(eng, prompts, new_tokens)
    torch.cuda.synchronize()
    del eng.tick             # the wrapper's cycle would keep the engine
    out = {"stats": [st for st, _ in log], "ms": [ms for _, ms in log],
           "wall_s": time.perf_counter() - t0,
           "tokens": {r.req_id: list(r.generated) for r in eng.finished},
           "proposed": eng.spec_proposed, "accepted": eng.spec_accepted,
           "rings": sorted(transformer.ring_lens(eng.caches)) if not eng.paged
           else [], "line": summary(eng, len(prompts), len(log))}
    eng.close()
    return out


def phase_spec(dev, card, params, launches: dict) -> None:
    """12b: markov weights on full yi-6b at k = 0, static k = 4 and
    adaptive; then a 2-layer f32 cut on random weights, the oracle
    drafter corrupting every third proposal, paged and dense."""
    cfg = get_config("yi-6b")
    mparams = markov_params(cfg, params, cycle_map())
    prompts = spec_prompts()
    say(f"[spec] {cfg.name} bf16, {cfg.num_layers} layers, markov weights "
        f"from phase 6's (a {SPEC_CYCLE}-token cycle); {len(prompts)} "
        f"forward-lap prompts {[len(p) for p in prompts]}, {SPEC_NEW} new "
        f"each")
    runs_ = {}
    bad = []
    for name, depth, adaptive in (("k0", 0, False),
                                  (f"static_k{SPEC_K}", SPEC_K, False),
                                  ("adaptive", 2, True)):
        with counted_launches(launches):
            r = runs_[name] = serve_spec(cfg, mparams, dev, prompts,
                                         SPEC_NEW, depth=depth,
                                         adaptive=adaptive)
        st = r["stats"]
        dec = [s_ for s_ in st if s_["decode_slots"]]
        per_tick = (sum(s_["decode_tokens"] for s_ in dec)
                    / max(1, sum(s_["decode_slots"] for s_ in dec)))
        gen = sum(len(t) for t in r["tokens"].values())
        say(f"[spec] {name}: {r['line']}")
        say(f"[spec] {name} on {card}: {len(st)} ticks, {gen} tokens in "
            f"{r['wall_s']:.3f} s = {gen / r['wall_s']:.2f} tokens/s; "
            f"ticks {tick_ms(r)}; decode tokens per slot a tick "
            f"{per_tick:.2f}; drafts accepted {r['accepted']}/"
            f"{r['proposed']}; serve.spec_depth by tick "
            f"{runs([s_['spec_depth'] for s_ in st])}")
        if max(s_["dispatches"] for s_ in st) > 1:
            bad.append(f"{name}: more than one dispatch in a tick")
    want = {i: [cycle_map()[int(p[-1])]] for i, p in enumerate(prompts)}
    for i, toks in want.items():
        while len(toks) < SPEC_NEW:
            toks.append(cycle_map()[toks[-1]])
    if runs_["k0"]["tokens"] != want:
        bad.append("k = 0 does not decode the markov map")
    for name, r in runs_.items():
        if r["tokens"] != runs_["k0"]["tokens"]:
            bad.append(f"{name}'s tokens differ from k = 0's")
    k4 = runs_[f"static_k{SPEC_K}"]
    rate = k4["accepted"] / max(1, k4["proposed"])
    say(f"[spec] accept rate at k = {SPEC_K}: {rate:.4f}")
    if not rate > 0.9:
        bad.append(f"accept rate {rate} at k = {SPEC_K}, not above 0.9")
    del mparams
    torch.cuda.empty_cache()
    # the f32 cut: spec tokens equal k = 0's under scheduled rejections
    cut_cfg = dataclasses.replace(cfg, num_layers=SPEC_CUT_LAYERS,
                                  dtype="float32")
    cut = f32_cut(params, SPEC_CUT_LAYERS)
    rng = np.random.default_rng(13)
    cut_prompts = [rng.integers(0, cfg.vocab_size, n) for n in (37, 300, 801)]
    for kv_mode in ("paged", "dense"):
        with counted_launches(launches):
            plain = serve_spec(cut_cfg, cut, dev, cut_prompts, 24,
                               max_batch=2, kv_mode=kv_mode)
            oracle = OracleDrafter(plain["tokens"], cfg.vocab_size,
                                   corrupt_every=3)
            spec = serve_spec(cut_cfg, cut, dev, cut_prompts, 24, depth=4,
                              drafter=oracle, max_batch=2, kv_mode=kv_mode)
        say(f"[spec] {SPEC_CUT_LAYERS} layers f32, {kv_mode} KV, on {card}: "
            f"spec tokens equal to k = 0's: "
            f"{spec['tokens'] == plain['tokens']}; drafts accepted "
            f"{spec['accepted']}/{spec['proposed']}; ticks "
            f"{len(spec['stats'])} against {len(plain['stats'])}")
        if spec["tokens"] != plain["tokens"]:
            bad.append(f"f32 cut, {kv_mode}: spec tokens differ from k = 0")
        if not 0 < spec["accepted"] < spec["proposed"]:
            bad.append(f"f32 cut, {kv_mode}: no partial acceptance")
    del cut
    launches.pop("routes", None)
    torch.cuda.empty_cache()
    if bad:
        fail("; ".join(bad))


@contextlib.contextmanager
def t1_calls(counts: dict):
    """Counts the model's scan calls at T = 1 (a spec row's column calls)
    by scan, while open."""
    real = {"rglru_scan_state": (importlib.import_module(
                "repro_torch.kernels.rglru"), "rglru_state_op"),
            "rwkv6_scan_state": (importlib.import_module(
                "repro_torch.kernels.rwkv6"), "rwkv6_state_op")}
    saved = {}
    for name, (mod, attr) in real.items():
        fn = saved[name] = getattr(mod, attr)

        def wrap(*a, _fn=fn, _name=name, **k):
            if a[0].shape[1] == 1:
                counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)
        setattr(mod, attr, wrap)
    try:
        yield
    finally:
        for name, (mod, attr) in real.items():
            setattr(mod, attr, saved[name])


def phase_spec_recurrent(dev, card, launches: dict) -> None:
    """12c: spec against k = 0 on a 5-layer f32 cut of recurrentgemma-9b
    (dense rings widened to 2056 entries, one prompt past them) and a
    2-layer f32 cut of rwkv6-7b, the oracle drafter corrupting every
    third proposal."""
    bad = []
    for arch, layers, lens, cache_len in (
            ("recurrentgemma-9b", 5, (2100, 130), 4096),
            ("rwkv6-7b", 2, (300, 77), 1024)):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  dtype="float32")
        params = zoo.init(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
        rng = np.random.default_rng(14)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
        got, t1 = {}, {}
        with counted_launches(got):
            plain = serve_spec(cfg, params, dev, prompts, 16, max_batch=2,
                               cache_len=cache_len)
        with counted_launches(got), t1_calls(t1):
            spec = serve_spec(cfg, params, dev, prompts, 16, depth=4,
                              drafter=OracleDrafter(plain["tokens"],
                                                    cfg.vocab_size,
                                                    corrupt_every=3),
                              max_batch=2, cache_len=cache_len)
        got.pop("routes", None)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        say(f"[spec] {arch} {layers} layers f32 on {card}: spec tokens "
            f"equal to k = 0's: {spec['tokens'] == plain['tokens']}; drafts "
            f"accepted {spec['accepted']}/{spec['proposed']}; dense rings "
            f"{spec['rings']}; kernel launches {got}, of them scans at "
            f"T = 1 {t1}")
        if spec["tokens"] != plain["tokens"]:
            bad.append(f"{arch}: spec tokens differ from k = 0's")
        if not 0 < spec["accepted"] < spec["proposed"]:
            bad.append(f"{arch}: no partial acceptance")
        if not t1:
            bad.append(f"{arch}: no scan ran at T = 1")
        ring = cfg.window + 8          # spec_depth_max's default margin
        if "swa" in cfg.block_pattern and spec["rings"] != [ring]:
            bad.append(f"{arch}: rings {spec['rings']}, not [{ring}]")
        del params
        torch.cuda.empty_cache()
    if bad:
        fail("; ".join(bad))


def spec_workload(cfg, horizon_s: float = SLO_HORIZON_S) -> list:
    """``bench_slo._spec_workload``: a poisson trace whose prompts lap the
    cycle forward in the first half (drafts land) and in reverse in the
    second (the drafter stays confident, every draft is wrong)."""
    trace = synthesize_trace(TraceConfig(
        process="poisson", rate_rps=SPEC_RATE_RPS, horizon_s=horizon_s,
        seed=29, prompt_lo=16, prompt_hi=24, prompt_alpha=1.3, new_lo=8,
        new_hi=16, new_alpha=1.6, tiers=slo_tiers()))
    cyc = np.arange(1, SPEC_CYCLE + 1, dtype=np.int32)
    half = horizon_s / 2.0
    arrivals = []
    for t, req in as_requests(trace, vocab=cfg.vocab_size, seed=1):
        idx = np.arange(len(req.prompt))
        a = req.req_id % SPEC_CYCLE
        req.prompt = cyc[((a + idx) if t < half else (a - idx)) % SPEC_CYCLE]
        arrivals.append((t, req))
    return arrivals


def run_spec(cfg, params, device, *, depth: int, adaptive: bool,
             telemetry_dir: str | None = None) -> dict:
    """``bench_slo._run_spec_policy`` on the port (with a telemetry hub
    when ``telemetry_dir`` is given, which switches no path)."""
    device = torch.device(device)
    vc = VirtualClock()
    tel = Telemetry(enabled=True, clock=vc) if telemetry_dir else None
    eng = ServeEngine(cfg, params, device=device, options=ServeOptions(
        max_batch=SLO_MAX_BATCH, cache_len=SLO_CACHE_LEN, block_tokens=16,
        enable_smartconf=True, prefill_mode="packed",
        slo=SLOSpec(ttft_s=SLO_TTFT_S, window=SLO_WINDOW),
        num_tiers=len(SLO_SHARES), spec_depth=depth, spec_adaptive=adaptive,
        telemetry=tel), registry=ConfRegistry(), clock=vc)
    monkey = ChaosMonkey(admission_chaos()).install(eng)
    out = drive_lane(eng, spec_workload(cfg), vc, monkey, device,
                     cost=TickCostModel(**SLO_COST, spec_lane_s=SPEC_LANE_S))
    out["max_dispatches"] = max(st["dispatches"] for st in out["per_tick"])
    out["chaos_events"] = len(monkey.events)
    out["proposed"] = eng.spec_proposed
    out["accepted"] = eng.spec_accepted
    out["final_depth"] = eng.spec_depth
    out["sensor_faults"] = sum(sc.sensor_faults for sc in eng.controllers())
    if tel is not None:
        out["telemetry_paths"] = tel.write(telemetry_dir)
    del eng.tick             # the wrapper's cycle would keep the engine
    eng.close()
    return out


def phase_spec_lane(dev, card, params, launches: dict) -> None:
    """12d: ``bench_slo``'s speculation lane on full yi-6b with markov
    weights, chaos on: adaptive depth against static depths 0, 1, 2, 4
    and 8; the adaptive run tick for tick against the same run of the
    port on the CPU at ``reduced()`` size."""
    cfg = get_config("yi-6b")
    mparams = markov_params(cfg, params, cycle_map())
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(mparams))

    def run(**kw):
        # the run's peak above what it found allocated, plus the markov
        # weights: its in-phase peak were they alone resident
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with counted_launches(launches):
            r = run_spec(cfg, mparams, dev, **kw)
        r["peak_gb"] = (torch.cuda.max_memory_allocated(dev) - base
                        + weights) / 1e9
        return r

    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        res = {"adaptive": run(depth=2, adaptive=True,
                               telemetry_dir=f"{tmp}/spec")}
        for k in SPEC_STATIC_DEPTHS:
            res[f"static_k{k}"] = run(depth=k, adaptive=False)
        bad += lane_faults(res, "spec")
        lane_rows("[spec-lane]", res, card, weights / 1e9)
        ad = res["adaptive"]
        say(f"[spec-lane] adaptive: drafts accepted {ad['accepted']}/"
            f"{ad['proposed']}, final depth {ad['final_depth']}; "
            f"serve.spec_depth by tick "
            f"{runs([st['spec_depth'] for st in ad['per_tick']])}")
        audit = read_audit(ad["telemetry_paths"])
        window = nan_window(admission_chaos())
        fb = sorted({d["conf"] for d in audit
                     if d["fallback"] and d["tick"] in window})
        say(f"[spec-lane] fallback Decisions in the NaN window (ticks "
            f"{window.start}-{window.stop - 1}): {fb}")
        if not fb:
            bad.append("the spec lane's NaN window engaged no fallback")
        for name, r in res.items():
            if r["max_dispatches"] > 1:
                bad.append(f"spec {name}: more than one dispatch in a tick")
        small = reduced(cfg)
        cpu = torch.device("cpu")
        t0 = time.perf_counter()
        ref = run_spec(small, markov_params(small, zoo.init(
            small, torch.Generator().manual_seed(0), cpu), cycle_map()), cpu,
            depth=2, adaptive=True)
        same = [k for k in ("per_tick", "goodput_tokens_by_tier",
                            "reject_counts", "preemptions", "sensor_faults",
                            "ticks", "finished", "accepted", "proposed")
                if ad[k] == ref[k]]
        say(f"[spec-lane] the adaptive run against the port's on the CPU at "
            f"reduced() size ({time.perf_counter() - t0:.1f} s): "
            f"{ad['ticks']} ticks against {ref['ticks']}; equal: {same}")
        if len(same) != 9:
            bad.append("the adaptive spec run left the CPU's trajectory")
    del mparams
    launches.pop("routes", None)
    torch.cuda.empty_cache()
    if bad:
        fail("; ".join(bad))


def phase_prefix_spec(dev, card, params) -> dict:
    """Phase 12: the prefix cache and speculation.  Returns the kernel
    launches of its serving runs."""
    launches: dict = {}
    t0 = time.perf_counter()
    phase_prefix(dev, card, params, launches)
    t1 = time.perf_counter()
    phase_spec(dev, card, params, launches)
    t2 = time.perf_counter()
    phase_spec_recurrent(dev, card, launches)
    t3 = time.perf_counter()
    phase_spec_lane(dev, card, params, launches)
    say(f"[times] phase 12: 12a {t1 - t0:.1f} s, 12b {t2 - t1:.1f} s, 12c "
        f"{t3 - t2:.1f} s, 12d {time.perf_counter() - t3:.1f} s")
    say(f"[prefix-spec] kernel launches {launches}")
    return launches


# ------------------------------------------------------ phase 13: MoE archs
def moe_slice(dev, card, cfg, prompts, new_tokens: int, tag: str):
    """One MoE arch in bf16 through the launcher's functions: what earlier
    phases left unreachable collected first (their engines hold reference
    cycles, so their weights wait for the cyclic collector), weights drawn
    on the card from seed 0, phase 6's settings (8 slots, cache_len 2048,
    paged KV at T 16, a 0.02 s decode-latency goal, the three knobs live)
    under an HBM goal of weights + MOE_HEADROOM.  Asserts every request
    finishes, at most one dispatch a tick, no ledger violation, both paged
    kernels launched and every paged segment launch on the tensor cores.
    Returns ``(launches, the engine)``."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = build_engine(cfg, max_batch=SLOTS, cache_len=CACHE_LEN,
                       budget_headroom_bytes=MOE_HEADROOM,
                       latency_goal_s=0.02, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = eng.accountant.breakdown()["weights"]
    n_par = sum(t.numel() for t in tree_leaves(eng.params))
    say(f"[{tag}] {cfg.name} bf16, {cfg.num_layers} layers "
        f"({cfg.first_k_dense} dense first, pattern {cfg.block_pattern}), "
        f"{cfg.num_experts} experts top-{cfg.top_k} of {cfg.moe_d_ff}, "
        f"{cfg.num_shared_experts} shared, capacity factor "
        f"{cfg.capacity_factor}; {n_par / 1e9:.3f} B parameters, weights "
        f"{weights / 1e9:.3f} GB drawn in {init_s:.1f} s (peak "
        f"{(torch.cuda.max_memory_allocated(dev) - held) / 1e9:.3f} GB "
        f"while drawing), HBM goal {eng.accountant.budget_bytes / 1e9:.3f} "
        f"GB; prompts {[len(p) for p in prompts]}, {new_tokens} new each")
    knobs = {"serve.max_queue_tokens": [eng.max_queue_tokens],
             "serve.kv_block_budget": [eng.pool.max_blocks],
             "serve.prefill_chunk_tokens": [eng.prefill_chunk]}
    tick_s = {"mixed": [], "decode-only": []}
    last = [0.0]

    def on_tick(e, st):
        knobs["serve.max_queue_tokens"].append(e.max_queue_tokens)
        knobs["serve.kv_block_budget"].append(e.pool.max_blocks)
        knobs["serve.prefill_chunk_tokens"].append(e.prefill_chunk)
        torch.cuda.synchronize()
        now = time.perf_counter()
        if st["dispatches"]:
            kind = "mixed" if st["prefill_issued_tokens"] else "decode-only"
            tick_s[kind].append(now - last[0])
        last[0] = now

    torch.cuda.reset_peak_memory_stats(dev)
    got: dict = {}
    t0 = last[0] = time.perf_counter()
    with counted_launches(got):
        stats = serve_requests(eng, prompts, new_tokens, on_tick=on_tick)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes = got.pop("routes")
    gen = sum(len(r.generated) for r in eng.finished)
    max_disp = max(st["dispatches"] for st in stats)
    say(f"[{tag}] " + summary(eng, len(prompts), len(stats)))
    say(f"[{tag}] on {card}: {gen} tokens in {wall:.3f} s = "
        f"{gen / wall:.2f} tokens/s (first launches included); TTFT mean "
        f"{eng.ttft.mean() * 1e3:.1f} ms, p99 {eng.ttft.p99() * 1e3:.1f} "
        f"ms; max dispatches/tick {max_disp}; kernel launches {got}; paged "
        f"segment launches by route {routes}")
    for kind, ts in tick_s.items():
        if ts:
            say(f"[{tag}] {kind} ticks on {card}: {len(ts)}, median "
                f"{statistics.median(ts) * 1e3:.1f} ms, mean "
                f"{np.mean(ts) * 1e3:.1f} ms, first {ts[0] * 1e3:.1f} ms, "
                f"max {max(ts) * 1e3:.1f} ms")
    for k, vals in knobs.items():
        say(f"[{tag}] knob {k} by tick: {runs(vals)}")
    in_phase_peak(f"[{tag}]", dev, eng, held)
    bad = []
    if len(eng.finished) != len(prompts):
        bad.append(f"{len(eng.finished)}/{len(prompts)} finished")
    for r in eng.finished:
        g = np.asarray(r.generated)
        if len(g) != new_tokens or g.min() < 0 or g.max() >= cfg.vocab_size:
            bad.append(f"request {r.req_id} generated {g!r}")
    if max_disp > 1:
        bad.append("more than one model dispatch in a tick")
    if eng.accountant.violations:
        bad.append(f"{eng.accountant.violations} HBM violations")
    if not (got["paged_segment_attention"] and got["paged_decode_attention"]):
        bad.append(f"a paged kernel of the path never launched: {got}")
    if routes["tensor_core"] != got["paged_segment_attention"]:
        bad.append(f"a paged segment launch left the tensor cores: {routes}")
    if bad:
        fail(f"{cfg.name}: " + "; ".join(bad))
    return got, eng


def kernels_a_call(fn) -> int:
    """How many kernels one call of ``fn`` launches on the card (the
    profiler's device events)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def moe_alone(dev, card, cfg, params) -> None:
    """13b: ``moe_apply`` alone on one layer of phase 13's weights, at the
    decode shape [SLOTS, 1, d] (every row live) and on a MOE_STREAM-token
    packed stream (every lane live), outside the engine's ticks: ms by
    CUDA events and by the profiler's device time, the kernels a call
    launches, its bound (the expert and shared weights read once, and
    the products of the assignments kept, whichever takes longer) and the
    share of assignments dropped at the configured capacity."""
    gen = torch.Generator(device=dev).manual_seed(13)
    d, k = cfg.d_model, cfg.top_k
    w_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params))
    ms_shared = cfg.moe_d_ff * cfg.num_shared_experts
    for name, shape in (("decode", (SLOTS, 1, d)),
                        ("stream", (1, MOE_STREAM, d))):
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        valid = (None if name == "decode" else
                 torch.ones(shape[:2], dtype=torch.bool, device=dev))
        g, gt = moe_model._group_shape(*shape[:2])
        cap = moe_model.capacity(cfg, gt)
        probs = torch.softmax(x.reshape(g, gt, d).float() @ params["router"],
                              dim=-1)
        kept = int(moe_model.assign(probs, cfg, cap, valid)[3].sum())
        tokens = shape[0] * shape[1]
        flops = 2 * d * (3 * cfg.moe_d_ff * kept + 3 * ms_shared * tokens
                         + cfg.num_experts * tokens)
        bound = max((w_bytes + 2 * x.numel() * x.element_size())
                    / PEAK_BYTES, flops / PEAK_BF16_FLOPS) * 1e3

        def call():
            return moe_model.moe_apply(params, x, cfg, valid=valid)
        ms = time_ms(call, iters=10, warmup=2)
        dev_ms = device_ms(call, bound, iters=10)
        n_kernels = kernels_a_call(call)
        dsum = sum(dev_ms.values())
        say(f"[moe] moe_apply {name} {list(shape)} bf16 on {card}: "
            f"{ms:.4f} ms by events, "
            + (f"{dsum:.4f} ms device" if dev_ms else "device not measured")
            + f" ({n_kernels} kernels a call); bound {bound:.4f} ms "
            f"(weights {w_bytes / 1e9:.4f} GB over {PEAK_BYTES / 1e12:g} "
            f"TB/s; {flops / 1e9:.1f} GFLOP kept over "
            f"{PEAK_BF16_FLOPS / 1e12:g} TFLOP/s): {bound / ms:.1%} of it by "
            f"events" + (f", {bound / dsum:.1%} by device time" if dev_ms
                         else "") + f"; {g} groups of {gt}, capacity {cap}; assignments "
            f"dropped {1 - kept / (tokens * k):.2%} ({tokens * k - kept} of "
            f"{tokens * k})")
        if dev_ms:
            top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:4]
            say(f"[moe] {name} device ms by kernel, largest: "
                + ", ".join(f"{n[:60]} {v:.4f}" for n, v in top))


def phase_moe(dev, card) -> dict:
    """Phase 13: (a) full deepseek-moe-16b serves phase 6's requests
    (:func:`moe_slice`); (b) its ``moe_apply`` alone (:func:`moe_alone`);
    (c) llama4-maverick-400b-a17b cut to MAVERICK_LAYERS of its 48 layers
    at every width and all 128 experts (one full, one full+moe layer)
    serves MAVERICK_PROMPTS of the same prompts, deepseek's weights freed
    first.  Returns the kernel launches of both serving runs."""
    launches: dict = {}
    lens = prompt_lens()
    t0 = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]
    got, eng = moe_slice(dev, card, cfg, prompts, 32, "moe")
    launches.update(got)
    t1 = time.perf_counter()
    moe_alone(dev, card, cfg, tree_map(lambda t: t[0],
                                       eng.params["groups"][0]["moe"]))
    eng.close()
    del eng
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MAVERICK),
                              num_layers=MAVERICK_LAYERS)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in lens][:MAVERICK_PROMPTS]
    got, eng = moe_slice(dev, card, cfg, prompts, 32, "maverick")
    for k, n in got.items():
        launches[k] = launches.get(k, 0) + n
    eng.close()
    del eng
    torch.cuda.empty_cache()
    say(f"[times] phase 13: 13a {t1 - t0:.1f} s, 13b {t2 - t1:.1f} s, 13c "
        f"{time.perf_counter() - t2:.1f} s")
    say(f"[moe] kernel launches {launches}")
    return launches


# ------------------------------------- phase 14: the modality frontends
CROSS_COUNTED = (flash_attention, flash_attention_fwd_lse, decode_attention)
SERVE_COUNTED = (flash_attention, decode_attention)
TRAIN_COUNTED = (flash_attention, flash_attention_fwd_lse, flash_attention_dq,
                 flash_attention_dkv)


@contextlib.contextmanager
def cross_launches(total: dict):
    """While open, the kernel launches made for cross-attention are added
    to ``total`` by kernel name: the forward ones inside each
    ``transformer.cross_attend`` call (the flash forwards at Sq = S, Sk =
    Se; the dense decode kernel over the frames), the backward ones inside
    each ``flash_attention_bwd`` call of the autograd Function whose keys
    differ in length from its queries.  Read off the wrappers' own counts
    before and after each call."""
    orig_cross, orig_bwd = transformer.cross_attend, flash_vjp.flash_attention_bwd

    def tally(fns, before):
        for f, n in zip(fns, before):
            total[f.__name__] = total.get(f.__name__, 0) + f.launches - n

    def cross(*a, **kw):
        before = [f.launches for f in CROSS_COUNTED]
        try:
            return orig_cross(*a, **kw)
        finally:
            # also when remat's recompute stops early by raising, once it
            # has what the backward pass needs
            tally(CROSS_COUNTED, before)

    def bwd(q, k, *a, **kw):
        fns = (flash_attention_dq, flash_attention_dkv)
        before = [f.launches for f in fns]
        try:
            return orig_bwd(q, k, *a, **kw)
        finally:
            if k.shape[2] != q.shape[2]:
                tally(fns, before)

    transformer.cross_attend, flash_vjp.flash_attention_bwd = cross, bwd
    try:
        yield
    finally:
        transformer.cross_attend = orig_cross
        flash_vjp.flash_attention_bwd = orig_bwd


def reset_counts(fns) -> None:
    for fn in fns:
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def front_layers(cfg) -> dict:
    """Attention launches of one pass by kind: the decoder's layers, the
    encoder's and the cross-attentions (one a decoder layer)."""
    enc = cfg.enc_layers if cfg.encoder_decoder else 0
    return dict(decoder=cfg.num_layers, encoder=enc,
                cross=cfg.num_layers if cfg.encoder_decoder else 0)


def front_cut(params, cfg, layers: int) -> tuple:
    """(config, weights): the first ``layers`` decoder layers (and as many
    encoder layers and cross-attentions) of a full bf16 tree, in f32."""
    cut = dict(params, groups=[tree_map(lambda t: t[:layers], g)
                               for g in params["groups"]])
    for key in ("encoder", "cross"):
        if key in cut:
            cut[key] = tree_map(lambda t: t[:layers], cut[key])
    extra = {"enc_layers": layers} if cfg.encoder_decoder else {}
    return (dataclasses.replace(cfg, num_layers=layers, dtype="float32",
                                **extra),
            tree_map(lambda t: t.detach().float(), cut))


def front_engine(cfg, params, dev):
    """Phase 14's engine: the launcher's build under default options (so
    ``auto`` resolves to the one-shot legacy prefill on dense KV, with the
    reference's RuntimeWarning) and the HBM goal weights +
    FRONT_HEADROOM; fails without the warning."""
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        eng = build_engine(cfg, max_batch=FRONT_SLOTS,
                           cache_len=FRONT_CACHE_LEN,
                           budget_headroom_bytes=FRONT_HEADROOM,
                           latency_goal_s=None, device=dev, params=params,
                           seed=0)
    if not any(issubclass(w.category, RuntimeWarning)
               and "keeps the one-shot legacy prefill path" in str(w.message)
               for w in warned):
        fail(f"{cfg.name}: no RuntimeWarning that auto keeps the one-shot "
             "path")
    if eng.paged or eng.prefill_impl != "legacy":
        fail(f"{cfg.name}: default options did not resolve to the one-shot "
             f"prefill on dense KV (prefill {eng.prefill_impl}, paged "
             f"{eng.paged})")
    return eng


def front_serve(dev, card, arch: str, prompts, launches: dict):
    """14a/b: full ``arch`` in bf16, seed-0 weights drawn on the card,
    serves ``prompts`` (FRONT_NEW new tokens each) through the launcher's
    functions; prints tokens/s, each one-shot prefill's ms, the median
    prefill and decode-only tick ms, the knobs' trajectories and the
    in-phase peak beside the HBM goal.  Asserts every request finishes
    with FRONT_NEW tokens, no ledger violation, serve.prefill_chunk_tokens
    at its initial value, and the attention launches: the flash forward
    once a layer (encoder, decoder and cross) a prefill, the dense decode
    kernel once a layer (decoder and cross) a decode step, every flash
    launch on the tensor cores.  Returns the engine."""
    cfg = get_config(arch)
    tag = f"[front {arch}]"
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = front_engine(cfg, None, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par = sum(t.numel() for t in tree_leaves(eng.params))
    lay = front_layers(cfg)
    say(f"{tag} {cfg.name} bf16, {cfg.num_layers} layers"
        + (f" + {cfg.enc_layers} encoder layers over {cfg.enc_seq} frames "
           "(zeros, as the reference serves)" if cfg.encoder_decoder else
           f" after {cfg.num_patches} patch positions (zeros, as the "
           "reference serves)")
        + f", {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}; {n_par / 1e9:.3f} B parameters, weights "
        f"{eng.accountant.breakdown()['weights'] / 1e9:.3f} GB drawn in "
        f"{init_s:.1f} s, HBM goal {eng.accountant.budget_bytes / 1e9:.3f} "
        f"GB; prefill [{eng.prefill_impl}], kv[dense], cache_len "
        f"{eng.cache_len}, {FRONT_SLOTS} slots; prompts "
        f"{[len(p) for p in prompts]}, {FRONT_NEW} new each")
    knobs = {"serve.max_queue_tokens": [eng.max_queue_tokens],
             "serve.kv_block_budget": [eng.pool.max_blocks],
             "serve.prefill_chunk_tokens": [eng.prefill_chunk]}
    tick_s = {"prefill": [], "decode-only": []}
    prefill_ms = []
    decode_steps = [0]
    last = [0.0]
    one_shot = eng._do_prefill_legacy

    def timed_prefill(req):
        torch.cuda.synchronize()
        t = time.perf_counter()
        one_shot(req)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)

    def on_tick(e, st):
        for k, v in (("serve.max_queue_tokens", e.max_queue_tokens),
                     ("serve.kv_block_budget", e.pool.max_blocks),
                     ("serve.prefill_chunk_tokens", e.prefill_chunk)):
            knobs[k].append(v)
        torch.cuda.synchronize()
        now = time.perf_counter()
        decode_steps[0] += st["decode_tokens"] > 0
        kind = "prefill" if st["prefill_tokens"] else "decode-only"
        tick_s[kind].append(now - last[0])
        last[0] = now

    eng._do_prefill_legacy = timed_prefill
    reset_counts(SERVE_COUNTED)
    cross: dict = {}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = last[0] = time.perf_counter()
    with cross_launches(cross):
        stats = serve_requests(eng, prompts, FRONT_NEW, on_tick=on_tick)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng._do_prefill_legacy
    got = {fn.__name__: fn.launches for fn in SERVE_COUNTED}
    routes = dict(flash_attention.route_launches)
    gen = sum(len(r.generated) for r in eng.finished)
    say(f"{tag} " + summary(eng, len(prompts), len(stats)))
    say(f"{tag} on {card}: {gen} tokens in {wall:.3f} s = {gen / wall:.2f} "
        f"tokens/s (first launches included); TTFT mean "
        f"{eng.ttft.mean() * 1e3:.1f} ms, p99 {eng.ttft.p99() * 1e3:.1f} "
        f"ms; one-shot prefill ms by request "
        f"{[round(x, 1) for x in prefill_ms]}, median "
        f"{statistics.median(prefill_ms):.1f}")
    for kind, ts in tick_s.items():
        if ts:
            say(f"{tag} {kind} ticks on {card}: {len(ts)}, median "
                f"{statistics.median(ts) * 1e3:.2f} ms, mean "
                f"{np.mean(ts) * 1e3:.2f} ms, first {ts[0] * 1e3:.1f} ms, "
                f"max {max(ts) * 1e3:.1f} ms")
    for k, vals in knobs.items():
        say(f"{tag} knob {k} by tick: {runs(vals)}")
    if cfg.encoder_decoder:
        cross_kv_cost(eng, card, tag, tick_s["decode-only"])
    chunk = knobs["serve.prefill_chunk_tokens"]
    say(f"{tag} serve.prefill_chunk_tokens stayed at its initial value "
        f"{chunk[0]}: {len(set(chunk)) == 1} (it cannot actuate on the "
        "one-shot path)")
    in_phase_peak(tag, dev, eng, held)
    want = {"flash_attention": eng.prefill_calls * sum(lay.values()),
            "decode_attention": decode_steps[0] * (lay["decoder"]
                                                   + lay["cross"])}
    want_cross = ({"flash_attention": eng.prefill_calls * lay["cross"],
                   "decode_attention": decode_steps[0] * lay["cross"]}
                  if cfg.encoder_decoder else {})
    cross = {k: n for k, n in cross.items() if n}
    say(f"{tag} kernel launches {got} ({eng.prefill_calls} one-shot "
        f"prefills, {decode_steps[0]} decode steps; expected {want}), of "
        f"them cross-attention {cross} (expected {want_cross}); flash "
        f"launches by route {routes}")
    bad = []
    if len(eng.finished) != len(prompts):
        bad.append(f"{len(eng.finished)}/{len(prompts)} finished")
    for r in eng.finished:
        g = np.asarray(r.generated)
        if len(g) != FRONT_NEW or g.min() < 0 or g.max() >= cfg.vocab_size:
            bad.append(f"request {r.req_id} generated {g!r}")
    if eng.accountant.violations:
        bad.append(f"{eng.accountant.violations} HBM violations")
    if len(set(chunk)) != 1:
        bad.append("serve.prefill_chunk_tokens moved")
    if got != want or cross != want_cross:
        bad.append(f"launches {got} / cross {cross}, expected {want} / "
                   f"{want_cross}")
    if routes["tensor_core"] != got["flash_attention"]:
        bad.append(f"a flash launch left the tensor cores: {routes}")
    if bad:
        fail(f"{cfg.name}: " + "; ".join(bad))
    for k, n in cross.items():
        launches["cross"][k] = launches["cross"].get(k, 0) + n
    for k, n in got.items():
        launches[k] = launches.get(k, 0) + n
    return eng


def cross_kv_cost(eng, card, tag: str, decode_ticks: list) -> None:
    """What re-projecting the cross-attention's K and V from ``enc_out``
    at every decode step costs (the reference's design, kept): one
    layer's two projections over the slots' frames by CUDA events, times
    the layers, beside the median decode-only tick."""
    cfg = eng.cfg
    cp = tree_map(lambda t: t[0], eng.params["cross"])
    enc = eng.caches["enc_out"]
    ms = time_ms(lambda: (project(enc, cp["attn"]["wk"]),
                          project(enc, cp["attn"]["wv"])))
    tick = statistics.median(decode_ticks) * 1e3
    say(f"{tag} cross K/V re-projected from enc_out {list(enc.shape)} each "
        f"decode step on {card}: {ms:.4f} ms a layer, x {cfg.num_layers} = "
        f"{ms * cfg.num_layers:.4f} ms against a {tick:.2f} ms median "
        f"decode-only tick ({ms * cfg.num_layers / tick:.1%})")


def front_cut_tokens(dev, card, eng, prompts) -> None:
    """The f32 2-layer cut of ``eng``'s weights serves FRONT_CUT_PROMPTS of
    the prompts (FRONT_CUT_NEW new each) on the card and, on the same
    weights, on the CPU under the same options: the tokens must be
    equal."""
    cfg, cut = front_cut(eng.params, eng.cfg, 2)
    out = []
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        e = front_engine(cfg, tree_map(lambda t: t.to(where), cut), where)
        stats = serve_requests(e, prompts[:FRONT_CUT_PROMPTS], FRONT_CUT_NEW)
        out.append({r.req_id: list(r.generated) for r in e.finished})
        say(f"[front {eng.cfg.name}] f32 2-layer cut on {where}: "
            f"{summary(e, FRONT_CUT_PROMPTS, len(stats))} "
            f"({time.perf_counter() - t0:.1f} s)")
        e.close()
    same = out[0] == out[1]
    say(f"[front {eng.cfg.name}] f32 2-layer cut: card tokens equal the "
        f"CPU engine's: {same} ({len(out[0])} requests)")
    if not same or len(out[0]) != FRONT_CUT_PROMPTS:
        fail(f"{cfg.name}: the f32 cut's tokens on the card differ from the "
             f"CPU engine's: {out}")


def front_train(dev, card, cfg, params, launches: dict) -> None:
    """14c: FRONT_TRAIN_STEPS AdamW steps of ``make_train_step`` at full
    size on ``zoo.make_batch`` (batch 2, remat as the trainer's default):
    finite losses, ms a step, and the flash launches (forward with
    logsumexp twice a layer a step under remat, the backward kernels
    once; the encoder's layers once each), every one on the tensor
    cores."""
    tag = f"[front {cfg.name}]"
    seq = FRONT_TRAIN_SEQ[cfg.name]
    batch = zoo.make_batch(cfg, ShapeConfig("train", seq,
                                            FRONT_TRAIN_BATCH, "train"),
                           np.random.default_rng(7), dev)
    opt = adamw.AdamWConfig(lr=1e-4, warmup_steps=1,
                            total_steps=FRONT_TRAIN_STEPS)
    step = train_step.make_train_step(cfg, opt)
    state = adamw.init(params)
    reset_counts(TRAIN_COUNTED)
    cross: dict = {}
    losses, step_ms = [], []
    with cross_launches(cross):
        for _ in range(FRONT_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))     # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
    got = {fn.__name__: fn.launches for fn in TRAIN_COUNTED}
    routes = {fn.__name__: dict(fn.route_launches) for fn in TRAIN_COUNTED}
    lay = front_layers(cfg)
    dec = lay["decoder"] + lay["cross"]
    n = FRONT_TRAIN_STEPS
    want = {"flash_attention": 0,
            "flash_attention_fwd_lse": n * (2 * dec + lay["encoder"]),
            "flash_attention_dq": n * (dec + lay["encoder"]),
            "flash_attention_dkv": n * (dec + lay["encoder"])}
    want_cross = ({"flash_attention_fwd_lse": 2 * n * lay["cross"],
                   "flash_attention_dq": n * lay["cross"],
                   "flash_attention_dkv": n * lay["cross"]}
                  if cfg.encoder_decoder else {})
    cross = {k: v for k, v in cross.items() if v}
    tokens = FRONT_TRAIN_BATCH * zoo.token_seq_len(cfg, seq)
    say(f"{tag} make_train_step at full size, bf16, batch "
        f"{FRONT_TRAIN_BATCH} x {zoo.token_seq_len(cfg, seq)} tokens"
        + (f" after {cfg.num_patches} patches" if cfg.frontend == "vision"
           else f" against {cfg.enc_seq} frames")
        + f" on {card}: losses {[round(x, 4) for x in losses]} (ln "
        f"{cfg.vocab_size} = {math.log(cfg.vocab_size):.4f}); step ms "
        f"{[round(x, 1) for x in step_ms]}, the last {step_ms[-1]:.1f} ms = "
        f"{tokens / step_ms[-1] * 1e3:.0f} tokens/s")
    say(f"{tag} training flash launches {got} (expected {want}), of them "
        f"cross-attention {cross} (expected {want_cross}); by route "
        f"{routes}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{cfg.name}: a training loss is not finite: {losses}")
    if got != want or cross != want_cross:
        fail(f"{cfg.name}: training launches {got} / cross {cross}, "
             f"expected {want} / {want_cross}")
    for k, r in routes.items():
        if r["cuda_core"]:
            fail(f"{k} launches by route {r}: bf16 D 64 takes the tensor "
                 "cores")
    for k, n in cross.items():
        launches["cross"][k] = launches["cross"].get(k, 0) + n
    for k, n in got.items():
        launches[k] = launches.get(k, 0) + n
    del state


def phase_frontends(dev, card) -> dict:
    """Phase 14: (a) full internvl2-1b and (b) full whisper-tiny serve
    FRONT_SLOTS requests each (:func:`front_serve`), each followed by its
    f32 2-layer cut's tokens card against CPU (:func:`front_cut_tokens`)
    and (c) FRONT_TRAIN_STEPS training steps on the serving weights
    (:func:`front_train`).  Returns the kernel launches, the
    cross-attention's under ``"cross"``."""
    launches: dict = {"cross": {}}
    rng = np.random.default_rng(1)
    t = [time.perf_counter()]
    for arch in FRONT_ARCHS:
        vocab = get_config(arch).vocab_size
        prompts = [rng.integers(0, vocab, int(n)) for n in front_prompt_lens()]
        eng = front_serve(dev, card, arch, prompts, launches)
        t.append(time.perf_counter())
        front_cut_tokens(dev, card, eng, prompts)
        t.append(time.perf_counter())
        params, cfg = eng.params, eng.cfg
        eng.close()
        del eng
        front_train(dev, card, cfg, params, launches)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        t.append(time.perf_counter())
    d = np.diff(t)
    say(f"[times] phase 14: internvl2-1b serve {d[0]:.1f} s, f32 cut "
        f"{d[1]:.1f} s, train {d[2]:.1f} s; whisper-tiny serve {d[3]:.1f} "
        f"s, f32 cut {d[4]:.1f} s, train {d[5]:.1f} s")
    say(f"[front] kernel launches {launches}")
    return launches


# ----------------------------------------------- phase 15: mesh serving
def head_chunk(x, r: int, dim: int = 1):
    """Head chunk ``r`` of ``MESH_TP`` along ``dim``, as a rank holds it:
    a tensor of its own (a ring's ``[B, Kv, S, D]`` view: the view of a
    ``[B, S, Kv / M, D]`` ring of its own)."""
    n = x.shape[dim] // MESH_TP
    if x.is_contiguous():
        return x.narrow(dim, r * n, n).contiguous()
    ring = x.transpose(1, 2)                      # [B, S, Kv, D]
    return ring.narrow(2, r * n, n).contiguous().transpose(1, 2)


def phase_mesh_kernels(dev) -> None:
    """15a: each of the slice's four attention kernels on head chunk r of
    MESH_TP at yi-6b's serving shapes, against the full launch's slice of
    those heads, bit for bit; the decode kernels with ``split_groups`` the
    global B x Kv (a shard's own heads at the single-device split), then
    again at their default split (the shard's B x Kv / 4), max|diff|
    printed.  Comparison launches: not counted."""
    gen = torch.Generator().manual_seed(15)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lens = prompt_lens()
    bf = torch.bfloat16
    seg = on(dev, segment_case(gen, segs=main_segment_segs(), p=WIDTH, h=H,
                               kv=KV, d=D, t=T, b=SLOTS, m=M), bf)
    flat = on(dev, flat_case(gen, segs=main_segment_segs(), p=WIDTH, h=H,
                             kv=KV, d=D, b=SLOTS, ring=CACHE_LEN), bf)
    dec = on(dev, decode_case(gen, q_pos=[int(n) + 5 for n in lens], h=H,
                              kv=KV, d=D, t=T, m=M), bf)
    dense = dense_args(on(dev, dense_case(
        gen, q_pos=[int(n) + 5 for n in lens], h=H, kv=KV, d=D,
        s=CACHE_LEN), bf))
    pairs = SLOTS * KV
    cases = (
        ("paged segment", paged_segment_attention, seg,
         ("q", "k_store", "v_store"), None),
        ("flat segment", segment_attention, flat, ("q", "k", "v"), None),
        ("paged decode", paged_decode_attention, dec,
         ("q", "k_store", "v_store"),
         lambda g: "blocks a split %d, %d splits" % split_blocks(M, g, sms)),
        ("dense decode", decode_attention, dense, ("q", "k", "v"),
         lambda g: "%(n_split)d splits of %(split)d slots, %(ctas)d CTAs"
         % dense_mod.launch_plan(SLOTS, H // MESH_TP, KV // MESH_TP,
                                 CACHE_LEN, D, 2, sms, g)))
    for name, kernel, x, heads, split in cases:
        full = kernel(**x)
        torch.cuda.synchronize()
        if split is not None:
            say(f"[mesh] 15a {name}: the full launch ({H}/{KV} heads) "
                f"takes {split(pairs)}")
        worst = 0.0
        for r in range(MESH_TP):
            part = {k: head_chunk(v, r) if k in heads else v
                    for k, v in x.items()}
            want = head_chunk(full, r)
            kw = {} if split is None else {"split_groups": pairs}
            got = kernel(**part, **kw)
            if not torch.equal(got, want):
                fail(f"15a {name}: head chunk {r} of {MESH_TP} differs from "
                     f"the full launch's slice by "
                     f"{(got.float() - want.float()).abs().max().item():.3e}")
            if split is not None:
                own = kernel(**part)
                worst = max(worst, (own.float() - want.float()).abs()
                            .max().item())
        torch.cuda.synchronize()
        say(f"[mesh] 15a {name}: {MESH_TP} head chunks of {H // MESH_TP}/"
            f"{KV // MESH_TP} heads equal the full launch's slices bit for "
            f"bit" + ("" if split is None else
                      f" with split_groups {pairs} ({split(pairs)}); at "
                      f"the default split ({split(pairs // MESH_TP)}) "
                      f"max|diff| {worst:.3e}"))
        del full, x


def mesh_cfg(arch: str, layers: int, dtype: str, capacity=None):
    """``arch`` at full width cut to its first ``layers`` layers, in
    ``dtype`` (and with ``capacity`` as its MoE capacity factor)."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype=dtype)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity)
    return cfg


def expert_shapes(params) -> list:
    """Each MoE layer's ``w_gate`` shape (stacked layers keep their lead
    dim)."""
    out = []

    def walk(tree):
        if isinstance(tree, dict):
            if "moe" in tree:
                out.append(tuple(tree["moe"]["w_gate"].shape))
            for v in tree.values():
                walk(v)
        elif isinstance(tree, list):
            for v in tree:
                walk(v)

    walk(params)
    return out


def mesh_serve(arch: str, layers: int, dtype: str, mesh, prompts,
               new_tokens: int, device: str, capacity=None,
               record: bool = False, kv_mode: str = "auto") -> dict:
    """One engine (this process's rank of ``mesh``, or one device with
    ``mesh`` None) over ``prompts``: seed-0 weights drawn on the card,
    default options but cache_len CACHE_LEN (and ``kv_mode``).  Returns the tokens, each
    tick's kind, ms and all-gather ms, the launches of the run (counts
    set to 0 just before, read just after), this process's peak, the
    per-rank KV bytes, the expert slices and, with ``record``, every
    dispatch's logits."""
    dev = torch.device(device)
    cfg = mesh_cfg(arch, layers, dtype, capacity)
    n, rank = world()
    for r in range(n):
        # one rank draws at a time: a draw's f32 transients (a stacked
        # leaf, 5.8 GB for yi-6b's w_down) beside four replicas overrun
        # the card; each hands its cache back before the next draws
        if r == rank:
            params = zoo.init(cfg, torch.Generator(device=dev).manual_seed(0),
                              dev)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
        if n > 1:
            torch.distributed.barrier()
    eng = ServeEngine(cfg, params, device=dev, options=ServeOptions(
        cache_len=CACHE_LEN, mesh=mesh, kv_mode=kv_mode))
    del params
    gather_s, logits, ticks = [0.0], [], []
    real_gather = collectives.all_gather

    def timed_gather(*a, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = real_gather(*a, **kw)
        gather_s[0] += time.perf_counter() - t0
        return out

    saved = {n: getattr(zoo, n) for n in ("step_packed", "decode_step")}
    moe_saved = {n: getattr(moe_model, n)
                 for n in ("moe_apply_ep", "moe_apply_ep_serve")}
    drops = [0, 0]          # moe_apply's, the EP bodies', same inputs

    def recording(fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            logits.append(out.float().cpu().numpy())
            return out
        return run

    def counting(fn):
        def run(params, x, c, *a, valid=None, **kw):
            for i, grouped in enumerate((True, False)):
                drops[i] += moe_model.dropped_assignments(
                    params["router"], x, c, valid, grouped=grouped)
            return fn(params, x, c, *a, valid=valid, **kw)
        return run

    last = [0.0]

    def on_tick(e, st):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        ticks.append(("mixed" if st["prefill_issued_tokens"]
                      else "decode-only", (now - last[0]) * 1e3,
                      gather_s[0] * 1e3))
        gather_s[0] = 0.0
        last[0] = now

    collectives.all_gather = timed_gather
    if record:
        for n, fn in saved.items():
            setattr(zoo, n, recording(fn))
        for n, fn in moe_saved.items():
            setattr(moe_model, n, counting(fn))
    try:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for k in MESH_KERNELS:
            k.launches = 0
        last[0] = time.perf_counter()
        serve_requests(eng, prompts, new_tokens, on_tick=on_tick)
        launches = {k.__name__: k.launches for k in MESH_KERNELS}
    finally:
        collectives.all_gather = real_gather
        for n, fn in saved.items():
            setattr(zoo, n, fn)
        for n, fn in moe_saved.items():
            setattr(moe_model, n, fn)
    out = dict(
        rank=rank, layers=cfg.num_layers, paged=eng.paged,
        tokens={r.req_id: [int(t) for t in r.generated]
                for r in eng.finished},
        ticks=ticks, launches=launches, tp_shards=eng.tp_shards,
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        kv_shard_bytes=eng.kv_shard_bytes(),
        weights_gb=sum(t.numel() * t.element_size()
                       for t in tree_leaves(eng.params)) / 1e9,
        experts=expert_shapes(eng.params),
        logits=logits if record else None, drops=drops)
    eng.close()
    return out


def mesh_ticks(res: dict) -> str:
    kinds: dict[str, list] = {}
    for kind, ms, gather in res["ticks"]:
        kinds.setdefault(kind, []).append((ms, gather))
    return "; ".join(
        f"{k} x{len(v)}: median {statistics.median(m for m, _ in v):.1f} "
        f"ms a tick, all-gathers {statistics.median(g for _, g in v):.2f} "
        f"ms of it" for k, v in kinds.items())


def mesh_run(card: str, tag: str, arch: str, layers: int, dtype: str,
             mesh: str, prompts, capacity=None, record=False,
             kv_mode="auto"):
    """One process's run, then the same on ``mesh``'s ranks (the parent's
    engine and weights released first); every rank's tokens must equal
    the one process's, and each rank must have launched its KV layout's
    two attention kernels.  Returns (one process's run, the ranks'
    runs)."""
    one = mesh_serve(arch, layers, dtype, None, prompts, MESH_NEW, "cuda",
                     capacity, record, kv_mode)
    gc.collect()
    torch.cuda.empty_cache()
    data, model = (int(v) for v in mesh.split("x"))
    t0 = time.perf_counter()
    ranks = spawn_mesh(data, model, mesh_serve, arch, layers, dtype, mesh,
                       prompts, MESH_NEW, "cuda", capacity, record, kv_mode,
                       device="cuda", timeout_s=300.0)
    wall = time.perf_counter() - t0
    say(f"[mesh] {tag} {arch} {layers} layers {dtype} on {card}: one "
        f"process: {mesh_ticks(one)}; peak {one['peak_gb']:.3f} GB")
    for r in ranks:
        say(f"[mesh] {tag} rank {r['rank']} of {mesh}: {mesh_ticks(r)}; "
            f"in-phase peak {r['peak_gb']:.3f} GB (weights "
            f"{r['weights_gb']:.3f} GB); launches {r['launches']}")
    say(f"[mesh] {tag} {mesh}: {data * model} ranks started, served and "
        f"stopped in {wall:.1f} s")
    for r in ranks:
        if r["tokens"] != one["tokens"]:
            bad = [i for i in one["tokens"]
                   if r["tokens"].get(i) != one["tokens"][i]]
            fail(f"{tag}: rank {r['rank']}'s tokens differ from one "
                 f"process's (requests {bad})")
        if r["tp_shards"] != model:
            fail(f"{tag}: rank {r['rank']} served {r['tp_shards']}-way")
        path = (("paged_segment_attention", "paged_decode_attention")
                if r["paged"] else ("segment_attention", "decode_attention"))
        if not all(r["launches"][k] for k in path):
            fail(f"{tag}: rank {r['rank']} launched a kernel of its path "
                 f"no time: {r['launches']}")
    if len(one["tokens"]) != len(prompts) or any(
            len(t) != MESH_NEW for t in one["tokens"].values()):
        fail(f"{tag}: not every request finished")
    say(f"[mesh] {tag} rank 0's greedy tokens equal one process's: "
        f"{len(prompts)} requests x {MESH_NEW}")
    return one, ranks


def phase_mesh(dev, card) -> dict:
    """Phase 15; returns the launches of 15b and 15c's ranks."""
    t0 = time.perf_counter()
    phase_mesh_kernels(dev)
    t_a = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("yi-6b")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in prompt_lens()][:MESH_PROMPTS]
    free, _ = torch.cuda.mem_get_info(dev)
    layers = (cfg.num_layers if free >= MESH_TP * MESH_RANK_BYTES
              else MESH_CUT_LAYERS)
    say(f"[mesh] 15b {free / 1e9:.1f} GB free on {card}: "
        + ("full depth, " if layers == cfg.num_layers else
           f"cut to {layers} of {cfg.num_layers} layers (four replicas need "
           f"{MESH_TP * MESH_RANK_BYTES / 1e9:.0f} GB), ")
        + f"prompts {[len(p) for p in prompts]}, {MESH_NEW} new each")
    t1 = time.perf_counter()
    one, ranks = mesh_run(card, "15b", "yi-6b", layers, "bfloat16",
                          f"1x{MESH_TP}", prompts)
    for r in ranks:
        if r["kv_shard_bytes"] * MESH_TP != one["kv_shard_bytes"]:
            fail(f"15b: rank {r['rank']} holds {r['kv_shard_bytes']} KV "
                 f"bytes, x {MESH_TP} != {one['kv_shard_bytes']}")
    say(f"[mesh] 15b KV per rank {ranks[0]['kv_shard_bytes'] / 1e6:.1f} MB "
        f"x {MESH_TP} = the one process's store, "
        f"{one['kv_shard_bytes'] / 1e6:.1f} MB")
    launches: dict = {}
    for r in ranks:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    t_b = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    for cap in (MESH_MOE_CAPACITY, MESH_MOE_NO_DROP):
        gc.collect()
        torch.cuda.empty_cache()
        tag = f"15c capacity {cap:g}"
        one, ranks = mesh_run(card, tag, MOE_ARCH, MESH_MOE_LAYERS,
                              "float32", "2x2", prompts, cap, record=True,
                              kv_mode="dense")
        gap = max(float(np.abs(a - b).max())
                  for a, b in zip(ranks[0]["logits"], one["logits"]))
        scale = max(float(np.abs(b).max()) for b in one["logits"])
        say(f"[mesh] {tag} max logit gap, rank 0 against one process over "
            f"{len(one['logits'])} dispatches: {gap:.3e} (largest |logit| "
            f"{scale:.3e}: {gap / scale:.3e} of it)")
        # the EP bodies cap over a rank's whole stream, moe_apply per
        # group: where either drops, the two paths route differently
        say(f"[mesh] {tag} dropped assignments on the same MoE inputs, "
            f"moe_apply's groups / the EP bodies' one group: one process "
            f"{one['drops'][0]} / {one['drops'][1]}, rank 0 "
            f"{ranks[0]['drops'][0]} / {ranks[0]['drops'][1]}")
        for r in ranks:
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
    if one["drops"] != [0, 0] or ranks[0]["drops"] != [0, 0]:
        fail(f"15c: assignments dropped at capacity {MESH_MOE_NO_DROP:g}")
    if gap > MESH_MOE_GAP:
        fail(f"15c: with nothing dropped rank 0's logits are {gap:.3e} "
             f"from one process's (limit {MESH_MOE_GAP:g})")
    moe_cfg = mesh_cfg(MOE_ARCH, MESH_MOE_LAYERS, "float32")
    for r in ranks:
        say(f"[mesh] 15c rank {r['rank']} holds w_gate {r['experts']} of "
            f"{one['experts']}: its {moe_cfg.num_experts // 2} of "
            f"{moe_cfg.num_experts} experts, and on decode their "
            f"{moe_cfg.moe_d_ff // 2} of {moe_cfg.moe_d_ff} moe_ff columns")
        if any(s[-3] != moe_cfg.num_experts // 2 for s in r["experts"]):
            fail(f"15c: rank {r['rank']} holds {r['experts']}")
    t_c = time.perf_counter() - t2
    say(f"[times] phase 15: kernels {t_a:.1f} s, yi-6b 1x{MESH_TP} "
        f"{t_b:.1f} s, deepseek-moe-16b 2x2 {t_c:.1f} s")
    say(f"[mesh] kernel launches of the ranks {launches}")
    return launches


# --------------------------------------- phase 16: data-parallel training
def fingerprint(t: torch.Tensor) -> tuple[int, int]:
    """Two 64-bit sums of ``t``'s bits, each element's bit pattern times
    an odd weight of its position (integer sums wrap, so the order of
    addition does not matter): equal tensors give equal fingerprints,
    and a change of any one element changes both."""
    x = t.detach().contiguous().reshape(-1)
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    bits = x.view(ints[x.element_size()])
    out = [0, 0]
    for off in range(0, bits.numel(), 1 << 24):
        b = bits[off:off + (1 << 24)].long()
        i = torch.arange(off, off + b.numel(), dtype=torch.int64,
                         device=b.device)
        for k, (mul, add) in enumerate(((0x5851F42D4C957F2D, 0x14057B7E),
                                        (0x2545F4914F6CDD1D, 0x3C6EF372))):
            w = (i * mul + add) | 1
            out[k] = (out[k] + int((b * w).sum())) % (1 << 64)
    return out[0], out[1]


def fingerprints(tree) -> dict:
    return {k: fingerprint(v) for k, v in keyed_leaves(tree)}


def dp_mesh_of(rank: int):
    """A stand-in for rank ``rank``'s view of the ``DP_DATA x 1`` mesh:
    what ``Placement`` reads (the parent builds no process group)."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": DP_DATA, "model": 1},
                                 data_index=rank, model_index=0, rank=rank)


def dp_batch(vocab: int, seq: int) -> dict:
    rng = np.random.default_rng(16)
    return {n: rng.integers(0, vocab, (TRAIN_BATCH, seq)).astype(np.int32)
            for n in ("tokens", "labels")}


def dp_opt() -> adamw.AdamWConfig:
    return adamw.AdamWConfig(warmup_steps=1, total_steps=10)


def dp_reckoning(n_par: int, largest: int, pbytes: int, fsdp: bool, cfg,
                 seq) -> dict:
    """What a rank should hold at its step's peak (bytes), every term at
    once (an upper reckoning: the gathered weights are freed before the
    optimizer runs): its weights (a 1/D slice of each FSDP leaf, and the
    gathered whole during the step), its gradients in the weights' dtype,
    the f32 sums of the whole gradient, its moments, one f32 bucket, one
    loss chunk's f32 logits three times over, the layers' inputs that
    remat keeps, and AdamW's f32 temporaries, about four of the largest
    leaf (its slice) at a time."""
    d = DP_DATA if fsdp else 1
    out = dict(weights=n_par * pbytes / d,
               gathered=n_par * pbytes if fsdp else 0,
               grads=n_par * pbytes, f32_sums=n_par * 4,
               moments=n_par * 8 / d, bucket=collectives.BUCKET_BYTES,
               loss=3 * transformer.LOSS_CHUNK * cfg.vocab_size * 4,
               inputs=cfg.num_layers * seq * cfg.d_model * pbytes,
               optimizer=4 * largest * 4 / d)
    out["total"] = sum(out.values())
    return out


def compressed_check(cfg, params, rows, mesh) -> dict:
    """16b: this rank's gradients (one forward and backward on its row),
    their compressed mean and their exact f32 mean over ``data``: each
    leaf's max error over its largest |exact mean|, the bytes each sends
    into its all-reduces, and the ms of each."""
    _, _, grads = accum.value_and_grad(
        lambda p, b: zoo.loss_fn(cfg, p, b), params, rows)
    keys = [k for k, _ in keyed_leaves(grads)]
    dev = rows["tokens"].device
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    summed = collectives.reduce_f32_buckets(
        [g for _, g in keyed_leaves(grads)], mesh, "data")
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    packed = collectives.compressed_psum_grads(grads, mesh, "data")
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    errs = {}
    for k, exact, (_, got) in zip(keys, summed, keyed_leaves(packed)):
        exact.mul_(1.0 / DP_DATA)
        errs[k] = float((got.float() - exact).abs().max()
                        / exact.abs().max().clamp_min(1e-30))
    n = [g.numel() for _, g in keyed_leaves(grads)]
    blocks = sum(-(-m // 128) for m in n)
    return dict(errs=errs, exact_ms=(t1 - t0) * 1e3,
                compressed_ms=(t2 - t1) * 1e3, exact_bytes=4 * sum(n),
                compressed_bytes=4 * 128 * blocks + 4 * blocks)


def mesh_train(arch: str, layers: int, dtype: str, batch: dict, fsdp: bool,
               expect: dict, compressed: bool = False,
               ckpt_dir: str | None = None, device: str = "cuda") -> dict:
    """One rank of phase 16: seed-0 weights drawn on the card (the
    parent's), this rank's slices under ``make_mesh_train_step``'s
    placement and its row of ``batch``; one step, timed with its
    all-reduce and all-gather ms.  Then the metrics, the flash launches
    (counts set to 0 just before the step), this rank's state
    fingerprints against ``expect`` (the one process's slices; the first
    leaf that differs comes back whole, as f32 numpy) and with
    ``ckpt_dir`` the gathered state written there by rank 0 (its
    fingerprints returned).  With ``compressed``, 16b first."""
    dev = torch.device(device)
    mesh = make_host_mesh(data=DP_DATA, model=1)
    cfg = mesh_cfg(arch, layers, dtype)
    params = zoo.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    step = train_step.make_mesh_train_step(cfg, dp_opt(), mesh, fsdp=fsdp)
    pl = step.placement
    n_par = sum(p.numel() for p in tree_leaves(params))
    largest = max(p.numel() for p in tree_leaves(params))
    pbytes = torch.empty((), dtype=layers_dtype(dtype)).element_size()
    rows = train_step.local_rows({k: torch.from_numpy(v).to(dev)
                                  for k, v in batch.items()}, mesh)
    out = dict(rank=mesh.rank, n_par=n_par, largest=largest, pbytes=pbytes)
    if compressed:
        out["compressed"] = compressed_check(cfg, params, rows, mesh)
    mine = pl.local({"params": params})["params"]
    del params
    state = adamw.init(mine)
    gc.collect()
    torch.cuda.empty_cache()
    spent = {"all_reduce": 0.0, "all_gather": 0.0}
    real = {"all_reduce": collectives.reduce_f32_buckets,
            "all_gather": collectives.gather_leaves}

    def timed(name):
        def run(*a, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            got = real[name](*a, **kw)
            torch.cuda.synchronize(dev)
            spent[name] += time.perf_counter() - t0
            return got
        return run

    collectives.reduce_f32_buckets = timed("all_reduce")
    collectives.gather_leaves = timed("all_gather")
    try:
        for k in DP_KERNELS:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        mine, state, m = step(mine, state, rows)
        metrics = {k: float(v) for k, v in m.items()}     # waits
        out.update(step_ms=(time.perf_counter() - t0) * 1e3,
                   reduce_ms=spent["all_reduce"] * 1e3,
                   gather_ms=spent["all_gather"] * 1e3)
    finally:
        collectives.reduce_f32_buckets = real["all_reduce"]
        collectives.gather_leaves = real["all_gather"]
    out.update(metrics=metrics,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               launches={k.__name__: k.launches for k in DP_KERNELS})
    tree = {"params": mine, "opt": state}
    got = fingerprints(tree)
    want = expect[mesh.rank]
    out["differ"] = [k for k in want if got[k] != want[k]]
    if out["differ"]:
        leaf = dict(keyed_leaves(tree))[out["differ"][0]]
        out["first"] = leaf.float().cpu().numpy()
    if ckpt_dir is not None:
        full = pl.gather(tree)
        if mesh.rank == 0:
            t1 = time.perf_counter()
            checkpoint_save(ckpt_dir, 1, full)
            out["write_s"] = time.perf_counter() - t1
            out["gathered"] = fingerprints(full)
        del full
        torch.distributed.barrier()
    # the rank lives on in the pool: hand its cached blocks back
    del mine, state, rows, step, tree
    gc.collect()
    torch.cuda.empty_cache()
    return out


def layers_dtype(dtype: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]


def one_process_step(dev, cfg, batch: dict, params=None):
    """One ``make_train_step`` step at TRAIN_BATCH microbatches on the
    whole batch in this process (seed-0 weights drawn on the card unless
    ``params`` are given): its state, metrics and ms."""
    if params is None:
        params = zoo.init(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
    state = adamw.init(params)
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    params, state, m = train_step.make_train_step(
        cfg, dp_opt(), n_micro=TRAIN_BATCH)(params, state, b)
    metrics = {k: float(v) for k, v in m.items()}
    ms = (time.perf_counter() - t0) * 1e3
    return {"params": params, "opt": state}, metrics, ms


def dp_expect(cfg, tree, fsdp: bool) -> dict:
    """Each rank's slices of the one process's ``tree`` under the
    placement ``fsdp`` gives: their fingerprints, by rank."""
    out = {}
    for r in range(DP_DATA):
        pl = train_step.state_placement(cfg, dp_mesh_of(r), fsdp=fsdp)
        out[r] = fingerprints(pl.map(pl.leaf_local, tree))
    return out


def dp_gap(dev, cfg, batch, key: str, rank: int, fsdp: bool, got, want):
    """A leaf that moved: its gap (max |difference| over max |one
    process|) on rank ``rank``'s slice, and the noise floor, the same
    step's gap with the weights nudged at f32 rounding."""
    pl = train_step.state_placement(cfg, dp_mesh_of(rank), fsdp=fsdp)
    mine = dict(keyed_leaves(pl.map(pl.leaf_local, want)))[key].float()
    gap = float((torch.from_numpy(got).to(dev) - mine).abs().max()
                / mine.abs().max())
    params = zoo.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    nudge, _, _ = one_process_step(dev, cfg, batch,
                                   nudged(dev, params, 2))
    del params
    other = dict(keyed_leaves(pl.map(pl.leaf_local, nudge)))[key].float()
    floor = float((other - mine).abs().max() / mine.abs().max())
    return gap, floor


def dp_run(pool, dev, card, tag: str, arch: str, layers: int, dtype: str,
           seq: int, modes=(False, True), ckpt_dir=None) -> dict:
    """16a at one width: one process, then the ranks with each FSDP mode
    of ``modes`` (16b on FSDP off in bf16, the checkpoint of 16c on FSDP
    on); every
    rank's first step must equal one process's bit for bit (or, where a
    bit moves, within DP_FLOOR_TIMES its noise floor: printed with the
    leaf) and launch the three flash kernels of training.  Returns the
    ranks' launches and, with ``ckpt_dir``, what 16c reads."""
    cfg = mesh_cfg(arch, layers, dtype)
    batch = dp_batch(cfg.vocab_size, seq)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    one, metrics, one_ms = one_process_step(dev, cfg, batch)
    peak_one = torch.cuda.max_memory_allocated(dev) - held
    torch.cuda.empty_cache()
    launches: dict = {}
    extra = {}
    for fsdp in modes:
        expect = dp_expect(cfg, one, fsdp)
        t0 = time.perf_counter()
        ranks = pool.run(mesh_train, arch, layers, dtype, batch, fsdp,
                         expect, not fsdp and dtype == "bfloat16",
                         ckpt_dir if fsdp else None, dev.type)
        wall = time.perf_counter() - t0
        r0 = ranks[0]
        reckon = dp_reckoning(r0["n_par"], r0["largest"], r0["pbytes"],
                              fsdp, cfg, seq)
        say(f"[dp] {tag} fsdp {fsdp} on {card}: {DP_DATA} ranks, {wall:.1f}"
            f" s; one process {one_ms:.1f} ms a step at {TRAIN_BATCH} "
            f"microbatches (its peak {peak_one / 1e9:.3f} GB)")
        for r in ranks:
            say(f"[dp] {tag} fsdp {fsdp} rank {r['rank']}: step "
                f"{r['step_ms']:.1f} ms (all-reduce {r['reduce_ms']:.1f} ms,"
                f" all-gather {r['gather_ms']:.1f} ms of it); "
                f"max_memory_allocated "
                f"{r['peak_gb']:.3f} GB against the reckoned "
                f"{reckon['total'] / 1e9:.3f} GB ("
                + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in reckon.items()
                            if k != "total")
                + f"); launches {r['launches']}")
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
            want = {"flash_attention_fwd_lse": 2 * layers,
                    "flash_attention_dq": layers,
                    "flash_attention_dkv": layers}
            if r["launches"] != want:
                fail(f"{tag}: rank {r['rank']} launched {r['launches']} in "
                     f"its first step, expected {want}")
            if r["metrics"] != metrics:
                fail(f"{tag} fsdp {fsdp}: rank {r['rank']}'s metrics "
                     f"{r['metrics']} differ from one process's {metrics}")
            if r["differ"]:
                key = r["differ"][0]
                gap, floor = dp_gap(dev, cfg, batch, key, r["rank"], fsdp,
                                    r["first"], one)
                say(f"[dp] {tag} fsdp {fsdp} rank {r['rank']}: "
                    f"{len(r['differ'])} leaves differ from one process's;"
                    f" the first, {key}, by {gap:.3e} of its largest "
                    f"|value| (noise floor {floor:.3e})")
                if gap > DP_FLOOR_TIMES * floor:
                    fail(f"{tag}: {key} is {gap:.3e} from one process's, "
                         f"over {DP_FLOOR_TIMES} x its floor {floor:.3e}")
        if all(not r["differ"] for r in ranks):
            say(f"[dp] {tag} fsdp {fsdp}: loss {metrics['loss']:.6f}, grad "
                f"norm {metrics['grad_norm']:.6f} and every leaf of every "
                f"rank's params and moments equal one process's bit for "
                f"bit ({len(expect[0])} leaves)")
        if "compressed" in r0:
            c = r0["compressed"]
            worst = max(c["errs"], key=c["errs"].get)
            say(f"[dp] 16b {tag} on {card}: compressed mean of the ranks' "
                f"gradients against the exact f32 mean: worst leaf {worst}"
                f" at {c['errs'][worst]:.3e} of its largest |mean| (limit "
                f"{DP_COMPRESSED_LIMIT}); a rank sends "
                f"{c['compressed_bytes'] / 1e9:.3f} GB (int8 payload summed"
                f" as int32, and the scales) against f32's "
                f"{c['exact_bytes'] / 1e9:.3f} GB; {c['compressed_ms']:.1f}"
                f" ms against {c['exact_ms']:.1f} ms")
            if c["errs"][worst] >= DP_COMPRESSED_LIMIT:
                fail(f"16b: {worst}'s compressed mean is "
                     f"{c['errs'][worst]:.3e} off")
        if fsdp and ckpt_dir is not None:
            extra = dict(gathered=r0["gathered"], write_s=r0["write_s"])
    if ckpt_dir is not None:
        extra["one"] = one
    else:
        del one
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, **extra)


def phase_elastic(dev, card, ckpt_dir: str, got: dict) -> None:
    """16c: the checkpoint the ``2x1`` ranks wrote (rank 0, the gathered
    state) restored in one process: every parameter and moment equal to
    the state the ranks held, gathered, bit for bit."""
    one = got.pop("one")
    like = tree_map(torch.empty_like, one)
    del one
    t0 = time.perf_counter()
    tree, _, step = checkpoint_restore(ckpt_dir, None, like)
    load_s = time.perf_counter() - t0
    back = fingerprints(tree)
    same = [k for k, v in got["gathered"].items() if back.get(k) == v]
    say(f"[dp] 16c on {card}: the {DP_DATA}x1 ranks' checkpoint (written "
        f"in {got['write_s']:.1f} s by rank 0) restored in one process in "
        f"{load_s:.1f} s: {len(same)}/{len(back)} leaves of params and "
        f"moments equal the ranks' gathered state bit for bit")
    del tree, like
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if step != 1 or len(same) != len(back) or set(back) != set(
            got["gathered"]):
        fail("16c: the restored state differs from the ranks'")


def phase_controller_twin(dev, card) -> None:
    """16d: ``tensor_controller.coordinated_step`` on CUDA tensors against
    the host ``core/controller.py`` controllers on the same readings,
    eight controllers (hard and soft goals, super-hard ones sharing
    metrics) over eight intervals."""
    from repro_torch.core import (ControllerModel, GoalSpec,
                                  SmartController)
    from repro_torch.core import tensor_controller as tcl
    cases = [(dict(alpha=2.0, delta=4.0, lam=0.1, conf_max=1e9),
              dict(value=100.0, hard=True), 0),
             (dict(alpha=1.0, conf_max=1e9), dict(value=50.0), 1),
             (dict(alpha=-3.0, delta=2.5, lam=0.2, conf_min=1.0,
                   conf_max=40.0), dict(value=10.0, hard=True,
                                        direction="lower"), 2),
             (dict(alpha=1.0, conf_max=1e9),
              dict(value=100.0, super_hard=True), 0),
             (dict(alpha=0.5, delta=3.0, lam=0.05, conf_max=1e9),
              dict(value=80.0, super_hard=True), 0),
             (dict(alpha=4.0, delta=1.5, conf_max=500.0),
              dict(value=30.0, super_hard=True), 2),
             (dict(alpha=1.0, delta=5.0, lam=0.3, conf_max=1e9),
              dict(value=70.0, hard=True), 3),
             (dict(alpha=2.0, conf_max=1e9),
              dict(value=60.0, super_hard=True), 2)]
    models = [ControllerModel(integer=False, **m) for m, _, _ in cases]
    goals = [GoalSpec(**g) for _, g, _ in cases]
    specs = tcl.stack_specs([tcl.make_spec(m, g, metric_id=i, device=dev)
                             for m, g, (_, _, i) in zip(models, goals,
                                                        cases)])
    n = tcl.interaction_counts(specs.metric_id, 8).cpu().tolist()
    hosts = [SmartController(m, g, 1.0) for m, g in zip(models, goals)]
    for h, g, k in zip(hosts, goals, n):
        h.set_interacting(int(k) if g.super_hard else 1)
    rng = np.random.default_rng(16)
    states = tcl.init_state(torch.ones(len(cases), device=dev))
    worst = 0.0
    for _ in range(8):
        meas = rng.uniform(0.0, 150.0, len(cases)).astype(np.float32)
        states, confs = tcl.coordinated_step(
            specs, states, torch.from_numpy(meas).to(dev))
        want = []
        for h, x in zip(hosts, meas):
            h.observe(float(x))
            want.append(h.actuate())
        got = confs.cpu().numpy().astype(np.float64)
        worst = max(worst, float(np.max(np.abs(got - want)
                                         / np.maximum(np.abs(want), 1.0))))
    say(f"[dp] 16d on {card}: coordinated_step of {len(cases)} controllers "
        f"on {confs.device} over 8 intervals against the host controllers: "
        f"worst relative gap {worst:.3e} (f32 against the host's f64; "
        f"limit 1e-5)")
    if confs.device != dev or worst > 1e-5:
        fail("16d: the controller twin differs from the host controllers")


def phase_dp(dev, card) -> dict:
    """Phase 16; returns the flash launches of the ranks."""
    t0 = time.perf_counter()
    launches: dict = {}
    ckpt_dir = str(ROOT / "build" / "chip_smoke_dp")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    with MeshPool(DP_DATA, 1, device="cuda", timeout_s=300.0) as pool:
        got = dp_run(pool, dev, card, "16a bf16", "yi-6b", DP_LAYERS,
                     "bfloat16", TRAIN_SEQ, ckpt_dir=ckpt_dir)
        t_a = time.perf_counter() - t0
        for k, v in got.pop("launches").items():
            launches[k] = launches.get(k, 0) + v
        t1 = time.perf_counter()
        phase_elastic(dev, card, ckpt_dir, got)
        t_c = time.perf_counter() - t1
        t1 = time.perf_counter()
        f32 = dp_run(pool, dev, card, "16a f32", "yi-6b", DP_LAYERS,
                     "float32", DP_F32_SEQ, modes=(True,))
        for k, v in f32["launches"].items():
            launches[k] = launches.get(k, 0) + v
        t_f = time.perf_counter() - t1
    t1 = time.perf_counter()
    phase_controller_twin(dev, card)
    say(f"[times] phase 16: bf16 {t_a:.1f} s (16b inside), 16c "
        f"{t_c:.1f} s, f32 cut {t_f:.1f} s, 16d "
        f"{time.perf_counter() - t1:.1f} s")
    say(f"[dp] kernel launches of the ranks {launches}")
    return launches


def main() -> None:
    t_start = time.perf_counter()

    def mark(what: str) -> None:
        say(f"[times] {what} done at {time.perf_counter() - t_start:.1f} s")

    dev = phase_device()
    card = card_line()
    phase_build()
    mark("1-2, device and build")
    # phase 5's host weights, drawn one cut after another on a worker
    # thread while phases 3 and 4 keep the card busy
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        drawn = {arch: pool.submit(host_weights, cfg)
                 for arch, cfg in parity_cuts().items()}
        errs = phase_kernels(dev)
        mark("3, kernels")
        timing = phase_timing(dev, card)
        mark("4, timing")
        phase_parity_attention(dev, card, drawn)
        mark("5, parity of the attention archs")
        phase_parity_rg(dev, card, drawn.pop("recurrentgemma-9b"))
        mark("5, parity of recurrentgemma-9b")
        phase_parity_rwkv6(dev, card, drawn.pop("rwkv6-7b"))
        mark("5, parity of rwkv6-7b")
        phase_parity_moe(dev, card, drawn.pop(MOE_ARCH))
        mark("5, parity of deepseek-moe-16b")
        phase_parity_frontends(dev, card, drawn)
        mark("5, parity of internvl2-1b and whisper-tiny")
    launches: dict = {}

    def count(got):
        # each phase resets the counts it reads; the line sums the phases
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    got, yi_params, yi_tokens = phase_slice(dev, card)
    count(got)
    torch.cuda.empty_cache()
    mark("6, yi-6b serving")
    count(phase_rg_slice(dev, card))
    torch.cuda.empty_cache()
    mark("7, recurrentgemma-9b serving, packed and legacy")
    count(phase_rwkv6_slice(dev, card))
    torch.cuda.empty_cache()
    mark("8, rwkv6-7b serving, packed and legacy")
    count(phase_train_slice(dev, card, timing)[0])
    torch.cuda.empty_cache()
    for arch, layers in TRAIN_CUTS:
        count(phase_train_cut(dev, card, arch, layers))
        torch.cuda.empty_cache()
    mark("9, training")
    count(phase_split_slice(dev, card, yi_params, yi_tokens))
    mark("10, split modes")
    count(phase_slo(dev, card, yi_params))
    torch.cuda.empty_cache()
    mark("11, SLO serving")
    count(phase_prefix_spec(dev, card, yi_params))
    del yi_params
    torch.cuda.empty_cache()
    mark("12, prefix cache and speculation")
    count(phase_moe(dev, card))
    mark("13, MoE")
    front = phase_frontends(dev, card)
    cross = front.pop("cross")
    count(front)
    mark("14, modality frontends")
    gc.collect()
    torch.cuda.empty_cache()
    count(phase_mesh(dev, card))
    mark("15, mesh serving")
    gc.collect()
    torch.cuda.empty_cache()
    count(phase_dp(dev, card))
    mark("16, data-parallel training")
    meta = {
        "paged_segment_attention": (
            SEG_SRC,
            "src/repro/kernels/segment_attention/segment_attention.py:204"),
        "paged_decode_attention": (
            DEC_SRC, "src/repro/kernels/paged_attention/paged_attention.py:88"),
        "segment_attention": (
            FLAT_SRC,
            "src/repro/kernels/segment_attention/segment_attention.py:104"),
        "rglru_scan_state": (
            RGLRU_SRC, "src/repro/kernels/rglru/rglru.py:56"),
        "rwkv6_scan_state": (
            RWKV6_SRC, "src/repro/kernels/rwkv6/rwkv6.py:85"),
        "flash_attention": (
            FLASH_SRC, "src/repro/kernels/flash_attention/flash_attention.py:83"),
        "flash_attention_fwd_lse": (
            FLASH_SRC,
            "src/repro/kernels/flash_attention/flash_attention.py:135"),
        "flash_attention_dq": (
            FLASH_BWD_SRC,
            "src/repro/kernels/flash_attention/flash_attention_bwd.py:43"),
        "flash_attention_dkv": (
            FLASH_BWD_SRC,
            "src/repro/kernels/flash_attention/flash_attention_bwd.py:76"),
        "decode_attention": (
            DENSE_SRC,
            "src/repro/kernels/decode_attention/decode_attention.py:84"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if name in cross:
            # of the launches, those of phase 14's cross-attention
            kernels[-1]["cross_launches"] = cross[name]
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            if key == "library_ms" and r[key] is None:
                continue     # no PyTorch call computes this function
            if not math.isfinite(r[key]):
                fail(f"{name} {key} is not finite")
    mark(f"chip_smoke.py on {card}, the build included,")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
