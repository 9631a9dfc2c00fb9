"""The segment attention kernels' tensor-core route: its route rules, its
split into work items, and (on the card) both kernels against their plain
versions over both routes.

On the CPU: the route rules of the flat and paged kernels, pinned by
dtype, head dim and block tokens; the work-item split
(:func:`segment_grid`, :func:`tile_items`: one item per (q tile, KV head,
live segment of the tile), from the shapes alone), pinned at the main
paths' shapes and held by a property test over random packed streams:
every live token's segment is among its tile's items, and every row, dead
lanes included, is written by exactly one item.

Tests marked ``cuda`` hold both kernels to their plain versions on the
same CUDA tensors (f32 ``atol=rtol=1e-4``: the kernels scale the dot, the
plain versions q; bf16 ``atol=rtol=2e-2``: the tensor-core route rounds P
to bf16 before it meets V): a tile of decode riders from 7 slots beside a
chunk's start, G = 12 (60 rows of 64), MQA (G 16), GQA, MHA and G = 80 (two
head chunks), block tokens 16 and 32 (tensor cores) and 12 (CUDA cores),
holes inside a segment's table row, windows that cut a key tile, streams
whose length is no multiple of the tile with all-dead tiles (exact zeros),
every head dim, f32 and bf16, recurrentgemma's wrapped and stale rings;
speculation's segments of 2-9 lanes over table rows that share blocks
(and a copied boundary block a prefill starts inside), and over
2056-entry rings; and a stale table entry or segment stops the tensor-core paged kernel on a
device-side assert (in a child process).  They skip where there is no card:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_segment_tc.py
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import HEAD_DIMS
from repro_torch.kernels.segment_attention import (
    paged_segment_attention, paged_segment_attention_ref,
    paged_segment_route, segment_attention, segment_attention_ref,
    segment_grid, segment_route, tile_items)

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (H, Kv): G = 12 (starcoder2-15b: 60 rows), MQA G = 16 (recurrentgemma-9b),
# GQA G = 8 (yi-6b), MHA, and G = 80 (two head chunks of a work item)
HEADS = [(48, 4), (16, 1), (32, 4), (4, 4), (80, 1)]


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


# ------------------------------------------------------------ route rules
@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 16, "cuda_core"), (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 120, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 256, "tensor_core"), (torch.float32, 16, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 120, "cuda_core"),
    (torch.float32, 128, "cuda_core"), (torch.float32, 256, "cuda_core")])
def test_segment_route_rule(dtype, d, want):
    assert segment_route(dtype, d) == want


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("t", [1, 4, 8, 12, 16, 24, 32, 48, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_segment_route_rule(dtype, t, d):
    """Tensor cores for bf16 at D 64/120/128/256 with T 8, 16, 32 or 64
    (whole blocks stack into a 64-key tile on the swizzle's 8-row atoms);
    everything else on the CUDA cores."""
    tc = (dtype == torch.bfloat16 and d in (64, 120, 128, 256)
          and t in (8, 16, 32, 64))
    assert paged_segment_route(dtype, d, t) == (
        "tensor_core" if tc else "cuda_core")


# --------------------------------------------------------- work-item split
@pytest.mark.parametrize("args,want", [
    ((2048, 32, 4, 8), (8, 256, 1, 8)),      # yi-6b's mixed tick, paged
    ((2048, 32, 4, 3), (8, 256, 1, 3)),      # fewer slots than tokens
    ((4096, 16, 1, None), (4, 1024, 1, 4)),  # recurrentgemma-9b, flat MQA
    ((77, 48, 4, None), (5, 16, 1, 5)),      # G 12: 60 rows, ragged P
    ((64, 4, 4, 8), (64, 1, 1, 8)),          # MHA: 64 tokens a tile
    ((10, 80, 1, None), (1, 10, 2, 1))])     # G 80: two head chunks
def test_segment_grid_pinned(args, want):
    assert segment_grid(*args) == want


def test_tile_items_order_and_dead_lanes():
    segs, owner = tile_items([3, 3, -1, 5, 3, -1, 0])
    assert segs == [3, 5, 0]
    assert owner == [0, 0, 0, 1, 0, 0, 2]
    assert tile_items([-1, -1]) == ([], [0, 0])


@st.composite
def packed_streams(draw):
    """A packed stream as the engine builds it or worse: runs of tokens of
    random slots (a slot may come back later in the stream), dead lanes
    anywhere, and the head layout of an arch."""
    h, kv = draw(st.sampled_from(HEADS + [(8, 1), (12, 4), (200, 2)]))
    b = draw(st.integers(1, 12))
    runs = draw(st.lists(st.tuples(st.integers(-1, b - 1),
                                   st.integers(1, 40)), max_size=12))
    q_seg = [s for s, n in runs for _ in range(n)]
    paged = draw(st.booleans())
    return q_seg, h, kv, (b if paged else None)


@settings(max_examples=300, deadline=None)
@given(packed_streams())
def test_work_items_cover_every_row_once(stream):
    q_seg, h, kv, b = stream
    p = len(q_seg)
    bq, n_tiles, chunks, items = segment_grid(p, h, kv, b)
    g = h // kv
    gc = min(g, 64)
    assert bq * gc <= 64 and n_tiles * bq >= p > (n_tiles - 1) * bq
    # the head chunks cover the group's heads once
    heads = [hc * gc + i for hc in range(chunks)
             for i in range(min(gc, g - hc * gc))]
    assert heads == list(range(g))
    for tile in range(n_tiles):
        tok = q_seg[tile * bq:(tile + 1) * bq]
        segs, owner = tile_items(tok)
        assert len(segs) <= items
        writes = [0] * len(tok)
        for z in range(items):
            if z >= max(1, len(segs)):
                continue            # the kernel's item exits at once
            for i, s in enumerate(tok):
                if (s >= 0 and s == segs[z]) or (s < 0 and z == 0):
                    writes[i] += 1
                    assert owner[i] == z
        assert writes == [1] * len(tok)
        for i, s in enumerate(tok):
            if s >= 0:
                assert segs[owner[i]] == s


# ------------------------------------------------------------ on the card
def _tables(rng, b, m, n_blocks, holes):
    tab = rng.permutation(n_blocks)[:b * m].astype(np.int32).reshape(b, m)
    for r, c in holes:
        tab[r, c] = -1
    return tab


def paged_case(rng, *, h, kv, d, t, p, segs, b, m, holes=()):
    """``segs`` = [(slot, start, length)] packed in order, then dead lanes
    up to ``p``; tables out of order with ``holes`` = [(row, col)] -1."""
    n_blocks = b * m + 5
    q_pos = np.zeros(p, np.int32)
    q_seg = np.full(p, -1, np.int32)
    c = 0
    for s, start, n in segs:
        q_pos[c:c + n] = np.arange(start, start + n)
        q_seg[c:c + n] = s
        c += n
    assert c <= p
    return dict(q=rng.standard_normal((p, h, d)).astype(np.float32),
                k_store=rng.standard_normal((n_blocks, kv, t, d))
                .astype(np.float32),
                v_store=rng.standard_normal((n_blocks, kv, t, d))
                .astype(np.float32),
                block_tables=_tables(rng, b, m, n_blocks, holes),
                q_pos=q_pos, q_seg=q_seg)


def riders_stream(t):
    """Decode riders of slots 0-6 at ragged positions (some on a block's
    first key, some on its last), then slot 7's chunk from its start; with
    slot 6's first block a hole, its rider at 2 admits no key."""
    riders = [(0, 5 * t + 3, 1), (1, 9 * t - 1, 1), (2, 300, 1),
              (3, 4 * t, 1), (4, 77, 1), (5, 131, 1), (6, 2, 1)]
    return riders + [(7, 0, 45)]


def to_dev(case, dtype, dev):
    return {k: (torch.from_numpy(v).to(dev, dtype) if v.dtype == np.float32
                else torch.from_numpy(v).to(dev)) for k, v in case.items()}


def check(got, want, dtype, q_seg, zero_rows=()):
    got, want = got.float().cpu(), want.to(dtype).float().cpu()
    tol = TOL[dtype]
    err = float((got - want).abs().max())
    assert torch.allclose(got, want, atol=tol, rtol=tol), err
    dead = torch.from_numpy(q_seg < 0)
    assert (got[dead] == 0).all()
    for r in zero_rows:
        assert (got[r] == 0).all() and (want[r] == 0).all()


def run_paged(dev, case, dtype, window):
    x = to_dev(case, dtype, dev)
    route = paged_segment_route(dtype, x["q"].shape[2],
                                x["k_store"].shape[2])
    before = dict(paged_segment_attention.route_launches)
    got = paged_segment_attention(**x, window=window)
    torch.cuda.synchronize()
    assert paged_segment_attention.route_launches[route] == before[route] + 1
    want = paged_segment_attention_ref(
        **{k: (v.float() if v.is_floating_point() else v)
           for k, v in x.items()}, window=window)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [16, 32, 12])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("h,kv", [hk for hk in HEADS if hk[0] // hk[1] <= 64])
def test_paged_riders_and_chunk_on_card(cuda, h, kv, d, t, dtype, window):
    """Riders of 7 slots beside a chunk's start share the first q tiles;
    holes inside live rows; P = 150 leaves a ragged last tile and, at G >= 8,
    whole tiles of dead lanes.  Slot 6's rider sits in a hole: exact
    zeros."""
    m = -(-320 // t) + 1
    holes = [(0, 2), (2, 1), (2, 300 // t - 1), (4, 3), (6, 0), (7, 1)]
    case = paged_case(np.random.default_rng(d + h + t), h=h, kv=kv, d=d,
                      t=t, p=150, segs=riders_stream(t), b=8, m=m,
                      holes=holes)
    got, want = run_paged(cuda, case, dtype, window)
    check(got, want, dtype, case["q_seg"], zero_rows=[6])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [8, 16, 64])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_long_chunks_on_card(cuda, d, t, dtype):
    """Prefill chunks long enough that whole key tiles take the unmasked
    step, mid-prompt chunks after earlier ones, and a windowed pass."""
    segs = [(1, 200, 130), (0, 0, 70), (2, 400, 1)]
    case = paged_case(np.random.default_rng(d + t), h=8, kv=2, d=d, t=t,
                      p=256, segs=segs, b=3, m=-(-600 // t),
                      holes=[(2, 3)])
    for window in (0, 100):
        got, want = run_paged(cuda, case, dtype, window)
        check(got, want, dtype, case["q_seg"])


def rings_case(rng, *, h, kv, d, p, segs, b, ring, prev=(), ahead=()):
    """The dense packed path's keys as the model tags them: every slot's
    ring (its own last ``ring`` positions before its start, wrapped; a
    slot in ``prev`` holds an earlier occupant's later positions instead,
    stale and masked; a slot in ``ahead`` also holds the 8 positions from
    its start on, a rejected draft's entries, stale and masked), then the
    stream's own keys."""
    ring_pos = np.full((b, ring), -1, np.int64)
    start = np.zeros(b, np.int64)
    q_pos = np.zeros(p, np.int32)
    q_seg = np.full(p, -1, np.int32)
    c = 0
    for s, st_, n in segs:
        start[s] = st_
        hist = np.arange(max(0, st_ - ring), st_)
        ring_pos[s, hist % ring] = hist
        q_pos[c:c + n] = np.arange(st_, st_ + n)
        q_seg[c:c + n] = s
        c += n
    for s in prev:
        occ = np.arange(ring + 37)[-ring:]
        ring_pos[s, occ % ring] = occ
    for s in ahead:
        junk = start[s] + np.arange(8)
        ring_pos[s, junk % ring] = junk
    kpos = np.where(ring_pos < start[:, None], ring_pos, -1)
    k_pos = np.concatenate([kpos.reshape(-1), np.where(q_seg >= 0, q_pos, -1)])
    k_seg = np.concatenate([np.repeat(np.arange(b), ring), q_seg])
    n = len(k_pos)
    return dict(q=rng.standard_normal((p, h, d)).astype(np.float32),
                k=rng.standard_normal((n, kv, d)).astype(np.float32),
                v=rng.standard_normal((n, kv, d)).astype(np.float32),
                q_pos=q_pos, k_pos=k_pos.astype(np.int32),
                q_seg=q_seg, k_seg=k_seg.astype(np.int32))


def run_flat(dev, case, dtype, window):
    x = to_dev(case, dtype, dev)
    route = segment_route(dtype, x["q"].shape[2])
    before = dict(segment_attention.route_launches)
    got = segment_attention(**x, window=window)
    torch.cuda.synchronize()
    assert segment_attention.route_launches[route] == before[route] + 1
    want = segment_attention_ref(
        **{k: (v.float() if v.is_floating_point() else v)
           for k, v in x.items()}, window=window)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 37, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("h,kv", HEADS)
def test_flat_rings_on_card(cuda, h, kv, d, dtype, window):
    """Riders of 7 slots (0 and 1 past the ring, wrapped) beside a chunk
    that starts over an earlier occupant's stale ring (slot 7) and a
    mid-prompt chunk (slot 2 rides first, slot 5 after); 96-entry rings,
    so 64-key tiles straddle two slots; P = 150 leaves dead tiles."""
    segs = [(0, 150, 1), (1, 201, 1), (2, 40, 1), (3, 95, 1), (4, 7, 1),
            (5, 60, 1), (6, 1, 1), (7, 0, 50), (5, 61, 30)]
    case = rings_case(np.random.default_rng(d + h + window), h=h, kv=kv,
                      d=d, p=150, segs=segs, b=8, ring=96, prev=(7,))
    got, want = run_flat(cuda, case, dtype, window)
    check(got, want, dtype, case["q_seg"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_recurrentgemma_tick_on_card(cuda, dtype):
    """recurrentgemma-9b's attention at a mixed tick's shapes, cut to 4
    slots of 2048-entry rings and a 1024-lane stream: MQA, D 256, window
    2048, wrapped rings (slots 0 and 1), a fresh chunk over a stale ring
    (slot 3) and a mid-prompt chunk (slot 2)."""
    segs = [(0, 2400, 1), (1, 2100, 1), (2, 900, 400), (3, 0, 500)]
    case = rings_case(np.random.default_rng(9), h=16, kv=1, d=256, p=1024,
                      segs=segs, b=4, ring=2048, prev=(3,))
    got, want = run_flat(cuda, case, dtype, 2048)
    check(got, want, dtype, case["q_seg"])


# the prefix cache and speculation: decode segments of 2-9 lanes (slot
# 1's ends on a block's last key), slot 2's prefix-hit prefill starting
# mid-block (at 40) in its copied boundary block, slot 0's chunk
SPEC_SEGS = [(3, 100, 9), (1, 44, 4), (4, 31, 2), (5, 200, 7), (2, 40, 50),
             (6, 15, 3), (7, 70, 6), (0, 60, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_spec_segments_over_shared_tables_on_card(cuda, dtype, window):
    """yi-6b's heads at T 16 (bf16: the tensor cores; f32: the CUDA
    cores): spec segments beside a prefix-hit prefill, with slots 0 and 1
    sharing their first three physical blocks (an adopted prefix) and slot
    2 sharing two and holding a copy of the third (the copy-on-write its
    mid-block match made).  Repeated ids across table rows are valid."""
    case = paged_case(np.random.default_rng(23), h=32, kv=4, d=128, t=16,
                      p=128, segs=SPEC_SEGS, b=8, m=15)
    tab = case["block_tables"]
    tab[1, :3] = tab[0, :3]
    tab[2, :2] = tab[0, :2]
    for a in (case["k_store"], case["v_store"]):
        a[tab[2, 2]] = a[tab[0, 2]]
    got, want = run_paged(cuda, case, dtype, window)
    check(got, want, dtype, case["q_seg"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_spec_segments_over_2056_entry_rings_on_card(cuda, dtype):
    """recurrentgemma-9b's attention under speculation: MQA, D 256, window
    2048 over rings widened by ``spec_depth_max`` (2056 entries), spec
    segments of 2-9 lanes on wrapped rings (one at the ring's edge) with a
    rejected draft's stale entries ahead, beside a prefill chunk over an
    earlier occupant's ring."""
    segs = [(0, 3000, 9), (1, 2100, 5), (2, 2056, 4), (3, 500, 1),
            (4, 0, 100), (5, 4000, 6)]
    case = rings_case(np.random.default_rng(12), h=16, kv=1, d=256, p=160,
                      segs=segs, b=6, ring=2056, prev=(4,), ahead=(0, 5))
    got, want = run_flat(cuda, case, dtype, 2048)
    check(got, want, dtype, case["q_seg"])


STALE = """
import sys, numpy as np, torch
sys.path[:0] = ["src", "tests"]
from test_torch_segment_tc import paged_case, riders_stream, to_dev
from repro_torch.kernels.segment_attention import paged_segment_attention
case = paged_case(np.random.default_rng(0), h=32, kv=4, d=128, t=16, p=64,
                  segs=riders_stream(16), b=8, m=21)
{edit}
paged_segment_attention(**to_dev(case, torch.bfloat16, "cuda"))
torch.cuda.synchronize()
"""


@pytest.mark.cuda
@pytest.mark.parametrize("edit", [
    'case["block_tables"][2, 300 // 16] = len(case["k_store"])',
    'case["q_seg"][3] = len(case["block_tables"])'])
def test_paged_tc_fails_on_stale_indices(cuda, edit):
    """Where the plain version raises IndexError, the tensor-core kernel
    stops on a device-side assert: a table entry past the store in a live
    rider's walk, a segment past the tables."""
    run = subprocess.run([sys.executable, "-c", STALE.format(edit=edit)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode != 0
    assert "device-side assert" in run.stdout + run.stderr, run.stderr[-2000:]
