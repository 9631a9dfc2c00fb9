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
                rows with their route, tiles and TFLOP/s; paged decode
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
                flash kernels at D 256); the gradient norm's limit is ten
                times the largest of five nudged readings, for every arch;
                each cut's seconds on the card and the CPU;
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
                where both modes must give the packed engine's tokens.

Before the last line it prints a JSON object with every kernel's numbers
(launches summed over the serving and training phases, each of which sets
the counts it reads to 0 before it drives its path), then the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import importlib
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
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
from repro_torch.launch.serve import (build_engine, serve_requests,  # noqa: E402
                                      summary)
from repro_torch.models import blocks, transformer, zoo  # noqa: E402
from repro_torch.models import rglru as rglru_model  # noqa: E402
from repro_torch.models import rwkv6 as rwkv6_model  # noqa: E402
from repro_torch.models.layers import apply_norm  # noqa: E402
from repro_torch.models.bridge import (keyed_leaves,  # noqa: E402
                                       tree_leaves, tree_map)
from repro_torch.optim import accum, adamw  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

# the wrapper modules (their packages export the functions by these names)
dense_mod = importlib.import_module(
    "repro_torch.kernels.decode_attention.decode_attention")
rwkv6_mod = importlib.import_module("repro_torch.kernels.rwkv6.rwkv6")
rglru_mod = importlib.import_module("repro_torch.kernels.rglru.rglru")

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


def flat_case(gen, *, segs, p, h, kv, d, b, ring, prev=()):
    """The dense packed path's keys, tagged as the model tags them: every
    slot's ring flattened to one axis, then the stream's own keys.
    ``segs`` = [(slot, start, length)]; a slot's ring holds its own last
    ``ring`` positions before its start (wrapped), a slot in ``prev``
    holds an earlier occupant's positions instead, which are at or after
    its start and so stale (masked)."""
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
    errs.update(phase_kernels_flash(dev))
    return errs


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
    return cases


def phase_kernels_dense(dev, gen) -> float:
    """Dense decode attention against its plain version computed in f32
    from the same inputs; rows no key admits exactly zero."""
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
            if name == "main" and dtype == torch.bfloat16:
                main_err = err
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


def flash_case(gen, b, h, kv, s, d):
    """q [B,H,S,D], k, v [B,Kv,S,D] and a random dO, N(0, 1), on ``gen``'s
    device."""
    dev = gen.device
    return dict(q=torch.randn(b, h, s, d, generator=gen, device=dev),
                k=torch.randn(b, kv, s, d, generator=gen, device=dev),
                v=torch.randn(b, kv, s, d, generator=gen, device=dev),
                do=torch.randn(b, h, s, d, generator=gen, device=dev))


# flash_cases() entries at the shapes the main paths give the kernels
MAIN_FLASH = ("main", "rg")


def flash_cases() -> dict:
    """name -> (B, H, Kv, S, D, causal, window): the main paths' shapes
    (yi-6b's training; recurrentgemma-9b's training and legacy prefill:
    16 query heads on one KV head, D 256, window 2048), gemma3's local
    layers (window 1024) and, at every head dim, MHA, GQA (32/4) and MQA
    at S = 1, 63, 130 under causal, windowed (32) and non-causal masks
    (with and without a window)."""
    cases = {"main": (FA_B, H, KV, FA_S, D, True, 0),
             "rg": (FA_B, RG_H, RG_KV, FA_S, RG_D, True, RG_WINDOW),
             "gemma3-local": (1, 8, 4, FA_S, 256, True, 1024)}
    masks = [(True, 0), (True, 32), (False, 0), (False, 32)]
    for i, d in enumerate(HEAD_DIMS):
        for j, (h, kv, what) in enumerate(((4, 4, "mha"), (32, 4, "gqa"),
                                           (8, 1, "mqa"))):
            s = (1, 63, 130)[(i + j) % 3]
            causal, window = masks[(i + 2 * j) % 4]
            cases[f"d{d}-{what}-S{s}-{'c' if causal else 'nc'}-w{window}"] = \
                (2, h, kv, s, d, causal, window)
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
    for name, (b, h, kv, s, d, causal, window) in flash_cases().items():
        case = flash_case(gen, b, h, kv, s, d)
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
            tag = f"flash/{name} [{b}, {h}/{kv}, {s}, {d}]"
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


def device_ms(fn, iters: int = 20) -> dict:
    """Device time per call by kernel, from torch.profiler over ``iters``
    calls after one warm-up: what a kernel takes on the card, apart from
    the host's enqueue cost, which CUDA events over back-to-back calls of
    a short kernel also see.  A profile that caught no device event (it
    happens now and then when profiles follow each other closely) is
    taken again, up to three times; empty if none caught one."""
    fn()
    torch.cuda.synchronize()
    out: dict[str, float] = {}
    for _ in range(3):
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
                             + e.time_range.elapsed_us() / 1e3)
        if out:
            break
    return {k: v / iters for k, v in out.items()}


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
        device_ms=device_ms(lambda: paged_decode_attention(**x)),
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
    for name, r in out.items():
        lib = ("null (" + r["library_note"] + ")" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms ({r['library_note']})")
        say(f"[timing] {name} {r['shapes']} on {card}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        if "device_ms" in r:
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


def timing_dense(dev, gen) -> tuple[dict, dict]:
    """Dense decode attention, bf16, on full rings read in place: yi-6b's
    legacy decode (B 8, H 32, Kv 4, D 128, S 2048, no window) and
    recurrentgemma's swa rings (B 8, H 16, Kv 1, D 256, 2048 entries,
    wrapped, window 2048).  The library call is SDPA on [B, H, 1, S] with
    the boolean mask and ``enable_gqa``, on contiguous copies of the
    rings."""
    import torch.nn.functional as F
    shapes = {
        "yi": (dict(q_pos=[CACHE_LEN - 1] * SLOTS, h=H, kv=KV, d=D,
                    s=CACHE_LEN), 0,
               f"bf16 B{SLOTS} H{H}/Kv{KV} D{D} S{CACHE_LEN} (yi-6b legacy "
               "decode, full rings)"),
        "rg": (dict(q_pos=[RG_WINDOW - 1 + int(n) for n in rg_prompt_lens()],
                    h=RG_H, kv=RG_KV, d=RG_D, s=RG_WINDOW), RG_WINDOW,
               f"bf16 B{RG_SLOTS} H{RG_H}/Kv{RG_KV} D{RG_D} ring {RG_WINDOW} "
               f"window {RG_WINDOW} (recurrentgemma swa, wrapped)")}
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for spec, window, note in shapes.values():
        plan = dense_mod.launch_plan(SLOTS, spec["h"], spec["kv"], spec["s"],
                                     spec["d"], 2, sms)
        say(f"[timing] dense decode at {note}: {plan['n_split']} key splits "
            f"of {plan['split']} slots, {plan['ctas']} split CTAs of "
            f"{dense_mod.WARPS} warps for {sms} SMs ({plan['per_sm']} a SM "
            f"by shared memory, {plan['smem']} bytes), a {plan['stages']}-"
            f"stage ring of {plan['tile']}-key tiles, {plan['head_chunks']} "
            f"head chunk(s); then a combine of {spec['h'] * SLOTS} CTAs")
        x = dense_args(on(dev, dense_case(gen, **spec), torch.bfloat16))
        mask = decode_mask(x["k_pos"], x["q_pos"], window)[:, None, None, :]
        k, v = x["k"].contiguous(), x["v"].contiguous()
        qd = x["q"][:, :, None, :]                        # [B, H, 1, D]
        bound, by = dense_bound(x, window)
        rows.append(dict(
            ms=time_ms(lambda: decode_attention(**x, window=window)),
            device_ms=device_ms(lambda: decode_attention(**x,
                                                         window=window)),
            plain_ms=time_ms(lambda: decode_attention_plain(
                **x, window=window)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qd, k, v, attn_mask=mask, enable_gqa=True)),
            library_note="sdpa, boolean mask, enable_gqa", bound_ms=bound,
            bound_by=by, shapes=note))
        del x, k, v, mask
    return rows[0], rows[1]


def rglru_timed(x, fn, label, card) -> dict:
    """One RG-LRU scan call's time by events and by the profiler, its
    bound, achieved GB/s and share of the bound, printed."""
    b, s, f = x["b"].shape
    nbytes = (3 * b * s * f + 2 * b * f) * 4     # log_a, b in; h out; h0, h_out
    ops = 3 * b * s * f                          # exp, multiply, add
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS
    r = dict(ms=time_ms(lambda: fn(**x)),
             device_ms=device_ms(lambda: fn(**x), iters=5),
             bound_ms=max(t_bytes, t_ops) * 1e3,
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             shapes=f"f32 [{b}, {s}, {f}]")
    dev_ms = sum(r["device_ms"].values())
    by_dev = (f"{dev_ms:.4f} ms device", f"{nbytes / dev_ms / 1e6:.1f} GB/s",
              f"{100 * r['bound_ms'] / dev_ms:.1f}%") if dev_ms else (
        "device time not measured (the profiler caught no kernel)", "-", "-")
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
    r = dict(ms=time_ms(lambda: rwkv6_scan_state(**x)),
             device_ms=device_ms(lambda: rwkv6_scan_state(**x), iters=5),
             plain_ms=time_ms(lambda: rwkv6_ref_state(**x), iters=2,
                              warmup=1),
             library_ms=None,
             library_note="no PyTorch call computes the recurrence",
             bound_ms=max(t_bytes, t_ops) * 1e3,
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


def flash_pairs(s: int, causal: bool, window: int) -> int:
    """Admitted (query, key) pairs of one head: what the kernels' work and
    so their bound depends on."""
    q = np.arange(s)
    hi = q if causal else np.full(s, s - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(s, int)
    return int((hi - lo + 1).sum())


# matrix products per admitted pair and head dim, in units of 2 D flops:
# the forward QK^T and PV; dQ recomputes QK^T and dO V^T, then dS K; dK/dV
# recomputes both, then P^T dO and dS^T Q
FLASH_PRODUCTS = {"flash_attention": 2, "flash_attention_fwd_lse": 2,
                  "flash_attention_dq": 3, "flash_attention_dkv": 4}


def flash_bound(kernel, b, h, kv, s, d, causal, window, dtype):
    """Least time for one kernel's call: its bytes (each input read once,
    each output written once) at 3.35 TB/s against its matrix products
    over the admitted pairs at the peak for the input dtype."""
    esz = torch.tensor([], dtype=dtype).element_size()
    q_b, kv_b, row_b = b * h * s * d * esz, b * kv * s * d * esz, b * h * s * 4
    nbytes = {"flash_attention": 2 * q_b + 2 * kv_b,
              "flash_attention_fwd_lse": 2 * q_b + 2 * kv_b + row_b,
              "flash_attention_dq": 3 * q_b + 2 * kv_b + 2 * row_b,
              "flash_attention_dkv": 2 * q_b + 4 * kv_b + 2 * row_b}[kernel]
    ops = FLASH_PRODUCTS[kernel] * 2 * d * b * h * flash_pairs(s, causal,
                                                                window)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", ops)


def timing_flash(dev, shape=None, what="yi-6b training") -> dict:
    """The three flash kernels at a training shape (bf16): yi-6b's (B, H,
    Kv, S, D, window) by default, causal, beside the plain versions (the
    plain backward computes dq, dk and dv together, so both backward rows
    carry its time) and SDPA: its forward for the two forward rows, its
    autograd backward (dQ, dK and dV together) for the two backward rows;
    with a window SDPA takes the causal window as a boolean mask.  The
    rows are keyed by kernel name, with `` (what)`` after it when a shape
    is given."""
    import torch.nn.functional as F
    b, h, kv, s, d, window = shape or (FA_B, H, KV, FA_S, D, 0)
    x = {n: t.to(torch.bfloat16) for n, t in flash_case(
        torch.Generator(device=dev).manual_seed(6), b, h, kv, s,
        d).items()}
    q, k, v, do = x["q"], x["k"], x["v"], x["do"]
    mask = dict(causal=True, window=window)
    o, lse = flash_attention_fwd_lse(q, k, v, **mask)
    dsum = (do.float() * o.float()).sum(-1)
    if window:
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
    shapes = (f"bf16 B{b} H{h}/Kv{kv} S{s} D{d} causal"
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
    n_kt, n_qt = -(-s // 64), -(-s // 64)
    if route == "tensor_core":
        say(f"[timing] flash forward at bf16 D {d}: route "
            f"{fwd_route(torch.bfloat16, d)}; one CTA (a consumer warpgroup "
            f"and a producer warp) per 64 q rows x query head x batch, the "
            f"longest first: {n_qt * h * b} CTAs for {sms} SMs, two per SM; "
            "64-key tiles in a two-stage TMA ring, P in registers")
        say(f"[timing] flash backward at bf16 D {d}: route {route}; dK/dV "
            f"one CTA (a consumer warpgroup and a producer warp) per 64 keys "
            f"x KV head x batch, key tile 0 (the most causal work) first: "
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
        bound, by, ops = flash_bound(name, b, h, kv, s, d, True, window,
                                     torch.bfloat16)
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
    fwd_ops = flash_bound("flash_attention", b, h, kv, s, d, True, window,
                          torch.bfloat16)[2]
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
                 grad_rows: int = 2):
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
    (:func:`host_weights`)."""
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
    (got, cpu, floor), *dense, train = card_cpu_floor(
        dev, params, host, name, run, *([run_dense] if dense else []), grad)
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
    starcoder2-15b and rwkv6-7b; 5 of recurrentgemma-9b."""
    extra = {"gemma3-4b": {"block_pattern": ("local", "global")},
             "recurrentgemma-9b": {"num_layers": 5}}
    return {arch: dataclasses.replace(
        get_config(arch), **{"num_layers": 2, "dtype": "float32",
                             **extra.get(arch, {})})
        for arch in ("yi-6b", "h2o-danube-3-4b", "gemma3-4b",
                     "starcoder2-15b", "recurrentgemma-9b", "rwkv6-7b")}


def host_weights(cfg):
    """``(cfg, its weights)`` drawn on the host by ``zoo.init`` from seed
    0, the weights phase 5 has held to the card since it began; rwkv6-7b's
    bonus u and decay base w0 are then drawn at random from the same
    generator in place of their constant initial values (0 and -6, a
    decay of ~0.9975), so the bonus and a spread of decays are exercised.
    The host's generator is sequential (~1e8 values a second), so
    :func:`main` draws them on a worker thread while phases 3 and 4 run
    on the card."""
    gen = torch.Generator().manual_seed(0)
    params = zoo.init(cfg, gen, "cpu")
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
    dict empty without ``leaves``)."""
    def run(p, d, leaves=True):
        loss, _, grads = accum.value_and_grad(
            lambda p, b: zoo.loss_fn(cfg, p, b), p,
            {n: torch.from_numpy(a).to(d) for n, a in batch.items()})
        for t in tree_leaves(p):      # marked in place: later runs take none
            t.requires_grad_(False)
        return (float(loss), float(adamw.global_norm(grads)),
                dict(keyed_leaves(grads)) if leaves else {})
    return run


def train_parity_ok(card, cfg, got, cpu, floor, card_gnorms) -> bool:
    """Print the card against the CPU on the loss, the gradient norm and
    every gradient leaf (each relative to its largest value) beside the
    noise floor (the norm's also beside ``card_gnorms``, its readings
    under more nudges); True when all are inside their limits."""
    loss_err = abs(got[0] - cpu[0]) / abs(cpu[0])
    gnorm_err = abs(got[1] - cpu[1]) / cpu[1]
    floors = [abs(g - got[1]) / got[1] for g in (floor[1], *card_gnorms)]
    gnorm_limit = GNORM_FLOOR_TIMES * max(floors)
    say(f"[parity] {cfg.name} {cfg.num_layers} layers f32 training on "
        f"{card}: loss {cpu[0]:.6f}, card - CPU {loss_err:.3e} relative "
        f"(limit {TRAIN_LOSS_LIMIT:g}; noise floor "
        f"{abs(floor[0] - got[0]) / abs(got[0]):.3e}); grad norm {cpu[1]:.6f},"
        f" {gnorm_err:.3e} (limit {gnorm_limit:.3e}, {GNORM_FLOOR_TIMES}x the "
        f"largest floor; floors " + ", ".join(f"{f:.3e}" for f in floors)
        + ")")
    worst = 0.0
    for key, g in cpu[2].items():
        err = rel(g, got[2][key])
        worst = max(worst, err)
        say(f"[parity] grad {key}: max|err| / max|g| = {err:.3e} (limit "
            f"{TRAIN_GRAD_LIMIT:g}; noise floor "
            f"{rel(got[2][key], floor[2][key]):.3e})")
    return (loss_err <= TRAIN_LOSS_LIMIT and gnorm_err <= gnorm_limit
            and worst <= TRAIN_GRAD_LIMIT)


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
    del yi_params
    mark("10, split modes")
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
