"""The port's attention families against the JAX package: flat-key and
paged segment attention, paged decode attention.

Plain versions (what a CPU tensor runs) are held against both JAX oracles
and the JAX Pallas kernels in interpret mode, on the same inputs made from
a numpy seed: ragged segments with decode riders, MHA/GQA/MQA, a sliding
window, f32 and bf16, out-of-order block tables with interior -1 holes,
dense slot rings that wrapped or hold a previous occupant's stale entries,
dead lanes (exact zeros), and live lanes no key admits (exact zeros).

Tolerances: f32 ``atol=rtol=1e-5`` (the oracles scale q before the dot,
the kernels the dot after it: a few f32 ulps); bf16 ``atol=rtol=2e-2``
(both sides accumulate in f32 from the same bf16 inputs and round once to
bf16, so they differ by at most an ulp or two of the output).

The paged decode kernel splits each row's table across CTAs; the split
choice (:func:`split_blocks`, from the shapes alone) is pinned here on the
CPU.

Tests marked ``cuda`` hold the CUDA kernels against the plain versions on
the card, paged decode also on rows whose live blocks span several splits
or sit in one; and the flash kernels (forward, forward with the
logsumexp, dQ, dK/dV) on keys of another length than the queries (the
modality frontends' cross-attention: whisper-tiny's Sq 77 and 448 against
its 1500 frames, ragged tile edges, GQA, both routes), with the dense
decode kernel at the frontends' decode shapes (one token against 1500
frames at position 0; internvl2-1b's 14 query heads on 2 KV heads, G 7);
the bf16 D 256 backward on the tensor cores at MQA 16/1 and GQA 8/4, S
130 and 1100, causal with and without window 1024, and its dK/dV at the
largest split launched twice, bit for bit; they skip where there is no
card.  The machine with the card has
no JAX, so this file imports the JAX package only inside the ``jx``
fixture, and runs there without the repository's conftest:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_kernels.py
"""

import inspect
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import HEAD_DIMS, check_operand, use_plain
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain,
                                                  padded_cache_len)
from repro_torch.kernels.flash_attention import (
    attention_bwd_ref, attention_lse_ref, dkv_split, flash_attention,
    flash_attention_dkv, flash_attention_dq, flash_attention_fwd_lse,
    fwd_route)
from repro_torch.kernels.paged_attention import (
    paged_decode_attention, paged_decode_attention_op,
    paged_decode_attention_ref, paged_gather, split_blocks)
from repro_torch.kernels.segment_attention import (
    paged_segment_attention, paged_segment_attention_op,
    paged_segment_attention_ref, segment_attention, segment_attention_op,
    segment_attention_ref)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
HEADS = [(4, 4), (4, 2), (4, 1)]                     # MHA / GQA / MQA
IDLE_ROW = 3                                         # of decode_case


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def jx():
    """The JAX package's oracles and Pallas kernels, and the converters
    from numpy cases to JAX arrays and back."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import decode_attention, paged_attention
    from repro.kernels import segment_attention
    dts = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

    def arrays(case, dtype):
        return {k: jnp.asarray(v, dts[dtype]) if v.dtype == np.float32
                else jnp.asarray(v) for k, v in case.items()}

    return types.SimpleNamespace(
        jnp=jnp, arrays=arrays,
        padded_cache_len=decode_attention.padded_cache_len,
        paged_gather=paged_attention.paged_gather,
        paged_decode=paged_attention.paged_decode_attention,
        paged_decode_ref=paged_attention.paged_decode_attention_ref,
        paged_segment=segment_attention.paged_segment_attention,
        paged_segment_ref=segment_attention.paged_segment_attention_ref,
        segment=segment_attention.segment_attention,
        segment_ref=segment_attention.segment_attention_ref)


def _tables(rng, b, m, holes):
    """Out-of-order physical ids with ``holes`` = [(row, col)] set to -1."""
    n = b * m + 3                                    # spare blocks unused
    tab = rng.permutation(n)[:b * m].astype(np.int32).reshape(b, m)
    for r, c in holes:
        tab[r, c] = -1
    return tab, n


def segment_case(rng, *, h, kv, d=16, t=8, b=3, m=4, p=32):
    """A packed stream: slot 0 prefills a ragged chunk, slot 1 rides as a
    length-1 decode segment past a hole, slot 2's chunk sits in a block
    whose table entry is -1 (live lanes no key admits), then dead lanes."""
    tab, n = _tables(rng, b, m, holes=[(1, 2), (2, 0)])
    segs = [(0, int(rng.integers(2, 8)), int(rng.integers(9, 15))),
            (1, 27, 1), (2, 1, 5)]
    q_pos = np.zeros(p, np.int32)
    q_seg = np.full(p, -1, np.int32)
    c = 0
    for s, start, ln in segs:
        q_pos[c:c + ln] = np.arange(start, start + ln)
        q_seg[c:c + ln] = s
        c += ln
    assert c < p
    return dict(q=rng.standard_normal((p, h, d)).astype(np.float32),
                k_store=rng.standard_normal((n, kv, t, d)).astype(np.float32),
                v_store=rng.standard_normal((n, kv, t, d)).astype(np.float32),
                block_tables=tab, q_pos=q_pos, q_seg=q_seg)


def decode_case(rng, *, h, kv, d=16, t=8, m=4):
    """Three rows at ragged positions that scale with ``t``, so the holes
    sit away from each row's own block and each admits at least its own
    key, with or without a window; then an idle row as the engine passes
    it (position 0, table row all -1), which admits no key."""
    q_pos = np.array([5, 27, 30, 0], np.int32) * t // 8
    tab, n = _tables(rng, 4, m, holes=[(1, 1), (2, 0)] + [(3, c)
                                                          for c in range(m)])
    return dict(q=rng.standard_normal((4, h, d)).astype(np.float32),
                k_store=rng.standard_normal((n, kv, t, d)).astype(np.float32),
                v_store=rng.standard_normal((n, kv, t, d)).astype(np.float32),
                block_tables=tab, q_pos=q_pos)


def flat_case(rng, *, h, kv, d=16, ring=12, p=32):
    """The dense packed path's keys: three slots' rings flattened to one
    axis, then the stream's own keys (k_seg = q_seg, so dead lanes admit
    nothing).  Slot 0 prefills a chunk at 20 over a ring that wrapped
    (it holds positions 8..19), slot 1 rides as a decode segment at 27,
    slot 2 starts a new prompt over a previous occupant's entries (30..41),
    which are stale (at or after its start) and masked as the model masks
    them; dead lanes after."""
    segs = [(0, 20, 10), (1, 27, 1), (2, 0, 5)]
    hist = {0: np.arange(8, 20), 1: np.arange(15, 27), 2: np.arange(30, 42)}
    ring_pos = np.full((3, ring), -1, np.int32)
    for s, pos in hist.items():
        pos = pos[-ring:]
        ring_pos[s, pos % ring] = pos
    q_pos = np.zeros(p, np.int32)
    q_seg = np.full(p, -1, np.int32)
    start = np.zeros(3, np.int32)
    c = 0
    for s, st, n in segs:
        q_pos[c:c + n] = np.arange(st, st + n)
        q_seg[c:c + n] = s
        start[s] = st
        c += n
    assert c < p
    stale = ring_pos >= start[:, None]
    k_pos = np.concatenate([np.where(stale, -1, ring_pos).reshape(-1),
                            np.where(q_seg >= 0, q_pos, -1)]).astype(np.int32)
    k_seg = np.concatenate([np.repeat(np.arange(3), ring),
                            q_seg]).astype(np.int32)
    n = len(k_pos)
    return dict(q=rng.standard_normal((p, h, d)).astype(np.float32),
                k=rng.standard_normal((n, kv, d)).astype(np.float32),
                v=rng.standard_normal((n, kv, d)).astype(np.float32),
                q_pos=q_pos, k_pos=k_pos, q_seg=q_seg, k_seg=k_seg)


def to_torch(case, dtype, device="cpu"):
    return {k: (torch.from_numpy(v).to(device, TORCH_DT[dtype])
                if v.dtype == np.float32 else torch.from_numpy(v).to(device))
            for k, v in case.items()}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, dtype, what):
    tol = TOL[dtype]
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert np.allclose(got, want, atol=tol, rtol=tol), f"{what}: {err:.3e}"


# ------------------------------------------------------- segment attention
@pytest.mark.parametrize("h,kv", HEADS)
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_segment_plain_matches_jax(jx, h, kv, window, dtype):
    case = segment_case(np.random.default_rng(h * 10 + kv), h=h, kv=kv)
    got = f32(paged_segment_attention_op(**to_torch(case, dtype),
                                         window=window))
    x = jx.arrays(case, dtype)
    oracle = f32(jx.paged_segment_ref(**x, window=window))
    pallas = f32(jx.paged_segment(**x, window=window, block_q=8,
                                  interpret=True))
    assert_close(got, oracle, dtype, "vs JAX oracle")
    assert_close(got, pallas, dtype, "vs Pallas (interpret)")
    dead = case["q_seg"] < 0
    assert dead.any() and (got[dead] == 0).all()
    # slot 2's chunk sits behind a -1 entry: live, but nothing admitted
    unadmitted = case["q_seg"] == 2
    assert (got[unadmitted] == 0).all() and (pallas[unadmitted] == 0).all()


@pytest.mark.parametrize("h,kv", HEADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_segment_oracle_matches_jax(jx, h, kv, dtype):
    """The flat-key oracle the paged one defers to, on shuffled keys with
    unwritten (-1) positions and foreign segments."""
    rng = np.random.default_rng(7)
    p, n, d = 21, 40, 16
    q_seg = np.full(p, -1, np.int32)
    q_seg[:8], q_seg[8:9], q_seg[9:17] = 0, 1, 2
    q_pos = rng.integers(0, 30, p).astype(np.int32)
    case = dict(q=rng.standard_normal((p, h, d)).astype(np.float32),
                k=rng.standard_normal((n, kv, d)).astype(np.float32),
                v=rng.standard_normal((n, kv, d)).astype(np.float32),
                q_pos=q_pos, k_pos=rng.integers(-1, 30, n).astype(np.int32),
                q_seg=q_seg, k_seg=rng.integers(-1, 3, n).astype(np.int32))
    got = f32(segment_attention_ref(**to_torch(case, dtype), window=6))
    want = f32(jx.segment_ref(**jx.arrays(case, dtype), window=6))
    assert_close(got, want, dtype, "flat oracle")
    assert (got[q_seg < 0] == 0).all()


@pytest.mark.parametrize("h,kv", HEADS)
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_segment_plain_matches_jax(jx, h, kv, window, dtype):
    """The dense packed layout (wrapped ring, decode rider, stale entries
    of an earlier occupant, dead lanes) against the JAX oracle and the
    Pallas kernel in interpret mode, key tiles smaller than the key axis."""
    case = flat_case(np.random.default_rng(h * 10 + kv + 2), h=h, kv=kv)
    got = f32(segment_attention_op(**to_torch(case, dtype), window=window))
    x = jx.arrays(case, dtype)
    oracle = f32(jx.segment_ref(**x, window=window))
    pallas = f32(jx.segment(**x, window=window, block_q=8, block_k=16,
                            interpret=True))
    assert_close(got, oracle, dtype, "vs JAX oracle")
    assert_close(got, pallas, dtype, "vs Pallas (interpret)")
    dead = case["q_seg"] < 0
    assert dead.any() and (got[dead] == 0).all() and (pallas[dead] == 0).all()


# -------------------------------------------------------- decode attention
@pytest.mark.parametrize("h,kv", HEADS)
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_plain_matches_jax(jx, h, kv, window, dtype):
    case = decode_case(np.random.default_rng(h * 10 + kv + 1), h=h, kv=kv)
    got = f32(paged_decode_attention_op(**to_torch(case, dtype),
                                        window=window))
    x = jx.arrays(case, dtype)
    oracle = f32(jx.paged_decode_ref(**x, window=window))
    pallas = f32(jx.paged_decode(**x, window=window, interpret=True))
    # the idle row admits no key: zeros here and in the Pallas kernel, the
    # mean of V in the JAX oracle
    live = IDLE_ROW != np.arange(len(got))
    assert_close(got[live], oracle[live], dtype, "vs JAX oracle")
    assert_close(got, pallas, dtype, "vs Pallas (interpret)")
    assert (got[IDLE_ROW] == 0).all() and (pallas[IDLE_ROW] == 0).all()


def test_paged_gather_matches_jax(jx):
    rng = np.random.default_rng(3)
    tab, n = _tables(rng, 2, 5, holes=[(0, 3), (1, 0)])
    ks = rng.standard_normal((n, 2, 4, 8)).astype(np.float32)
    vs = rng.standard_normal((n, 2, 4, 8)).astype(np.float32)
    got = paged_gather(torch.from_numpy(ks), torch.from_numpy(vs),
                       torch.from_numpy(tab))
    want = jx.paged_gather(jx.jnp.asarray(ks), jx.jnp.asarray(vs),
                           jx.jnp.asarray(tab))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [1, 96, 512, 513, 1000, 2048, 4097])
def test_padded_cache_len_matches_jax(jx, n):
    assert padded_cache_len(n) == jx.padded_cache_len(n)


# ------------------------------------------------------------- dispatch
def test_cpu_tensors_run_the_plain_version_without_a_launch():
    case = to_torch(segment_case(np.random.default_rng(0), h=4, kv=2),
                    "float32")
    before = paged_segment_attention.launches
    got = paged_segment_attention_op(**case)
    assert paged_segment_attention.launches == before
    torch.testing.assert_close(got, paged_segment_attention_ref(**case),
                               atol=0, rtol=0)
    flat = to_torch(flat_case(np.random.default_rng(0), h=4, kv=2),
                    "float32")
    before = segment_attention.launches
    torch.testing.assert_close(segment_attention_op(**flat),
                               segment_attention_ref(**flat), atol=0, rtol=0)
    assert segment_attention.launches == before
    dec = to_torch(decode_case(np.random.default_rng(0), h=4, kv=2),
                   "float32")
    before = paged_decode_attention.launches
    torch.testing.assert_close(paged_decode_attention_op(**dec),
                               paged_decode_attention_ref(**dec),
                               atol=0, rtol=0)
    assert paged_decode_attention.launches == before


@pytest.mark.parametrize("op,make,field", [
    (paged_segment_attention_op, segment_case, "block_tables"),
    (paged_segment_attention_op, segment_case, "q_seg"),
    (paged_decode_attention_op, decode_case, "block_tables")])
def test_plain_versions_refuse_stale_indices(op, make, field):
    """A table entry past the store, or a segment past the table, raises
    (the kernels fail there too) instead of reading a clamped block."""
    case = make(np.random.default_rng(0), h=4, kv=2)
    if field == "block_tables":
        case[field][0, 0] = len(case["k_store"])
    else:
        case[field][0] = len(case["block_tables"])
    with pytest.raises(IndexError):
        op(**to_torch(case, "float32"))


@pytest.mark.parametrize("wrapper,make", [
    (paged_segment_attention, segment_case),
    (paged_decode_attention, decode_case),
    (segment_attention, flat_case)])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper, make):
    """A wrapper never runs the plain version: a CPU tensor is an error."""
    case = to_torch(make(np.random.default_rng(0), h=4, kv=2), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(**case)


def test_use_plain_by_device_alone():
    cpu = torch.zeros(2)
    assert use_plain(cpu, cpu)
    with pytest.raises(ValueError, match="several devices"):
        use_plain(cpu, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        use_plain(torch.zeros(2, device="meta"))


@pytest.mark.parametrize("m,groups,sms", [
    (128, 32, 132), (1, 8, 132), (4, 8, 132), (64, 32, 132), (64, 8, 132),
    (256, 4, 132), (128, 512, 132), (100, 3, 7), (7, 300, 132)])
def test_split_blocks_cover_the_table(m, groups, sms):
    """Every split is a non-empty run of consecutive entries, and the runs
    cover all m entries of a row's table exactly once."""
    per, n = split_blocks(m, groups, sms)
    assert per >= 1 and n >= 1
    runs = [range(s * per, min(m, (s + 1) * per)) for s in range(n)]
    assert all(len(r) for r in runs)
    assert [j for r in runs for j in r] == list(range(m))


def test_split_blocks_take_shapes_alone():
    """The split comes from ints only, never from q_pos or the tables, so
    choosing it reads nothing back from the device."""
    params = inspect.signature(split_blocks).parameters
    assert list(params) == ["m", "groups", "sms"]
    assert all(p.annotation in (int, "int") for p in params.values())


def test_split_blocks_fill_the_card_at_yi6b():
    """yi-6b's decode tick: 8 rows x 4 KV heads over a 128-entry table on
    132 SMs gives about two CTAs per SM."""
    per, n = split_blocks(128, 8 * 4, 132)
    assert (per, n) == (15, 9)
    assert 1.75 <= n * 8 * 4 / 132 <= 2.5


@pytest.mark.parametrize("tensor,kw,err", [
    (torch.zeros(4, 4), dict(dtype=torch.bfloat16, ndim=2), TypeError),
    (torch.zeros(4, 4), dict(dtype=torch.float32, ndim=3), ValueError),
    (torch.zeros(4, 4).T, dict(dtype=torch.float32, ndim=2), ValueError),
    (torch.zeros(9)[1:], dict(dtype=torch.float32, ndim=1), ValueError),
])
def test_check_operand_refuses(tensor, kw, err):
    with pytest.raises(err):
        check_operand("x", tensor, device=torch.device("cpu"), **kw)


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("h,kv", HEADS + [(32, 4)])
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_segment_kernel_matches_plain_on_card(cuda, h, kv, window, dtype, d):
    case = segment_case(np.random.default_rng(d + h), h=h, kv=kv, d=d, t=16)
    x = to_torch(case, dtype, cuda)
    before = paged_segment_attention.launches
    got = f32(paged_segment_attention(**x, window=window))
    assert paged_segment_attention.launches == before + 1
    want = paged_segment_attention_ref(
        **{k: (v.float() if v.is_floating_point() else v)
           for k, v in x.items()}, window=window)
    want = f32(want.to(TORCH_DT[dtype]))
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert np.allclose(got, want, atol=tol, rtol=tol)
    assert (got[case["q_seg"] < 0] == 0).all()
    assert (got[case["q_seg"] == 2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv", HEADS + [(16, 1)])
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("p", [32, 77])
def test_flat_segment_kernel_matches_plain_on_card(cuda, h, kv, window, dtype,
                                                   d, p):
    """Against the plain version on the same CUDA tensors; 77 queries and
    125 keys leave ragged q and key tiles."""
    case = flat_case(np.random.default_rng(d + h + p), h=h, kv=kv, d=d,
                     ring=31, p=p)
    x = to_torch(case, dtype, cuda)
    before = segment_attention.launches
    got = f32(segment_attention(**x, window=window))
    assert segment_attention.launches == before + 1
    want = segment_attention_ref(
        **{k: (v.float() if v.is_floating_point() else v)
           for k, v in x.items()}, window=window)
    want = f32(want.to(TORCH_DT[dtype]))
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert np.allclose(got, want, atol=tol, rtol=tol)
    assert (got[case["q_seg"] < 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv", HEADS + [(32, 4)])
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_decode_kernel_matches_plain_on_card(cuda, h, kv, window, dtype, d):
    case = decode_case(np.random.default_rng(d + h), h=h, kv=kv, d=d, t=16)
    x = to_torch(case, dtype, cuda)
    before = paged_decode_attention.launches
    got = f32(paged_decode_attention(**x, window=window))
    assert paged_decode_attention.launches == before + 1
    want = paged_decode_attention_ref(
        **{k: (v.float() if v.is_floating_point() else v)
           for k, v in x.items()}, window=window)
    want = f32(want.to(TORCH_DT[dtype]))
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert np.allclose(got, want, atol=tol, rtol=tol)
    assert (got[IDLE_ROW] == 0).all() and (want[IDLE_ROW] == 0).all()


def split_case(rng, *, h, kv, d, t=16, m=64):
    """Rows at positions whose live blocks span many splits, cross a split
    edge, or sit in the first split (at the card's split of 8 rows over a
    64-entry table), each with its own block allocated and interior -1
    holes elsewhere; then two idle rows (position 0, table row all -1)."""
    q_pos = np.array([1000, 100, 130, 520, 20, 127, 0, 0], np.int32)
    b = len(q_pos)
    tab, n = _tables(rng, b, m, holes=[(0, 5), (0, 40), (0, 61), (2, 3),
                                       (3, 20), (3, 31), (5, 2)])
    tab[6:] = -1
    own = q_pos[:6] // t
    assert all(tab[r, j] >= 0 for r, j in enumerate(own))
    return dict(q=rng.standard_normal((b, h, d)).astype(np.float32),
                k_store=rng.standard_normal((n, kv, t, d)).astype(np.float32),
                v_store=rng.standard_normal((n, kv, t, d)).astype(np.float32),
                block_tables=tab, q_pos=q_pos)


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv", [(32, 4), (8, 1), (4, 4)])
@pytest.mark.parametrize("window", [0, 37, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_decode_kernel_across_splits_on_card(cuda, h, kv, window, dtype, d):
    """Against the plain version where each row's live blocks span several
    splits, cross a split edge or sit in one split, with holes, windows
    that start inside a block, and idle rows (exact zeros)."""
    case = split_case(np.random.default_rng(d + h + window), h=h, kv=kv, d=d)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    per, _ = split_blocks(64, len(case["q_pos"]) * kv, sms)
    last = case["q_pos"][:6] // 16 // per   # each row's last live split
    assert last.max() > 0 and last.min() == 0
    x = to_torch(case, dtype, cuda)
    before = paged_decode_attention.launches
    got = f32(paged_decode_attention(**x, window=window))
    assert paged_decode_attention.launches == before + 1
    want = paged_decode_attention_ref(
        **{k: (v.float() if v.is_floating_point() else v)
           for k, v in x.items()}, window=window)
    want = f32(want.to(TORCH_DT[dtype]))
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert np.allclose(got, want, atol=tol, rtol=tol)
    assert (got[6:] == 0).all() and (want[6:] == 0).all()


STALE = """
import sys, numpy as np, torch
sys.path[:0] = ["src", "tests"]
from test_torch_kernels import {make}, to_torch
from repro_torch.kernels.{family} import {wrapper}
case = {make}(np.random.default_rng(0), h=4, kv=2)
case["{field}"]{at} = {value}
{wrapper}(**to_torch(case, "float32", "cuda"))
torch.cuda.synchronize()
"""


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper,field", [
    ("paged_segment_attention", "block_tables"),
    ("paged_segment_attention", "q_seg"),
    ("paged_decode_attention", "block_tables")])
def test_kernels_fail_on_stale_indices(cuda, wrapper, field):
    """Where the plain version raises IndexError, the kernel stops on a
    device-side assert (in a child process: the assert ends its context)."""
    import subprocess
    import sys
    seg = wrapper == "paged_segment_attention"
    make = "segment_case" if seg else "decode_case"
    value = ('len(case["block_tables"])' if field == "q_seg"
             else 'len(case["k_store"])')
    src = STALE.format(
        make=make, wrapper=wrapper, field=field, value=value,
        family="segment_attention" if seg else "paged_attention",
        at="[0]" if field == "q_seg" else "[0, 0]")
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", src], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode != 0
    assert "device-side assert" in run.stdout + run.stderr, run.stderr[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_one_stage_ring_on_card(cuda, dtype):
    """64-token blocks at D 256: two ring stages of K and V tiles would not
    fit two CTAs on an SM (nor, in f32, one), so the kernel loads each
    tile after the last one is read."""
    case = decode_case(np.random.default_rng(64), h=8, kv=2, d=256, t=64)
    x = to_torch(case, dtype, cuda)
    got = f32(paged_decode_attention(**x, window=100))
    want = paged_decode_attention_ref(
        **{k: (v.float() if v.is_floating_point() else v)
           for k, v in x.items()}, window=100)
    want = f32(want.to(TORCH_DT[dtype]))
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert np.allclose(got, want, atol=tol, rtol=tol)
    assert (got[IDLE_ROW] == 0).all()


@pytest.mark.cuda
def test_decode_kernel_fails_on_a_stale_entry_in_a_later_split(cuda):
    """A stale entry in the last live block of a long row, which a later
    split's CTA reads, stops the kernel on a device-side assert too."""
    import subprocess
    import sys
    src = STALE.replace("h=4, kv=2", "h=8, kv=2, d=64").format(
        make="split_case", wrapper="paged_decode_attention",
        field="block_tables", value='len(case["k_store"])',
        family="paged_attention", at="[0, 1000 // 16]")
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", src], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode != 0
    assert "device-side assert" in run.stdout + run.stderr, run.stderr[-2000:]


@pytest.mark.cuda
def test_ops_launch_the_kernel_on_card(cuda):
    """A CUDA tensor reaches the kernel through the op, never the plain
    version."""
    seg = to_torch(segment_case(np.random.default_rng(0), h=4, kv=2),
                   "float32", cuda)
    dec = to_torch(decode_case(np.random.default_rng(0), h=4, kv=2),
                   "float32", cuda)
    flat = to_torch(flat_case(np.random.default_rng(0), h=4, kv=2),
                    "float32", cuda)
    s0, d0 = paged_segment_attention.launches, paged_decode_attention.launches
    f0 = segment_attention.launches
    paged_segment_attention_op(**seg)
    paged_decode_attention_op(**dec)
    segment_attention_op(**flat)
    torch.cuda.synchronize()
    assert paged_segment_attention.launches == s0 + 1
    assert paged_decode_attention.launches == d0 + 1
    assert segment_attention.launches == f0 + 1


def _shard(x, dim, r, model):
    n = x.shape[dim] // model
    return x.narrow(dim, r * n, n).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,model", [(32, 4, 4), (32, 4, 2), (8, 2, 2)])
def test_paged_decode_shards_split_as_one_device_on_card(cuda, h, kv, model,
                                                          dtype):
    """A tensor-parallel shard (head chunk r of M, its KV heads' slice of
    the store) launched with ``split_groups`` the global ``B * Kv`` equals
    the full launch's slice of those heads bit for bit; ``split_groups``
    at its default value changes nothing."""
    x = to_torch(split_case(np.random.default_rng(h + model), h=h, kv=kv,
                            d=128), dtype, cuda)
    full = paged_decode_attention(**x)
    b = x["q"].shape[0]
    same = paged_decode_attention(**x, split_groups=b * kv)
    assert torch.equal(same, full)
    for r in range(model):
        part = paged_decode_attention(
            _shard(x["q"], 1, r, model), _shard(x["k_store"], 1, r, model),
            _shard(x["v_store"], 1, r, model), x["block_tables"],
            x["q_pos"], split_groups=b * kv)
        assert torch.equal(part, _shard(full, 1, r, model))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,model", [(32, 4, 4), (32, 4, 2), (8, 2, 2)])
def test_dense_decode_shards_split_as_one_device_on_card(cuda, h, kv, model,
                                                          dtype):
    """The same for dense decode on rings read in place through ``[B, Kv,
    S, D]`` views: a shard's rings are the Kv chunk of the full ring, its
    split planned for the global ``B * Kv``."""
    rng = np.random.default_rng(h + model)
    b, s, d = 4, 1100, 128
    ring = torch.from_numpy(rng.standard_normal((2, b, s, kv, d),
                                                np.float32)).to(
        cuda, TORCH_DT[dtype])
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32)).to(
        cuda, TORCH_DT[dtype])
    k_pos = torch.arange(s, dtype=torch.int32, device=cuda).repeat(b, 1)
    q_pos = torch.tensor([1099, 700, 64, 1000], dtype=torch.int32,
                         device=cuda)
    full = decode_attention(q, ring[0].transpose(1, 2),
                            ring[1].transpose(1, 2), k_pos, q_pos)
    same = decode_attention(q, ring[0].transpose(1, 2),
                            ring[1].transpose(1, 2), k_pos, q_pos,
                            split_groups=b * kv)
    assert torch.equal(same, full)
    for r in range(model):
        kl, vl = (_shard(ring[i], 2, r, model).transpose(1, 2)
                  for i in (0, 1))
        part = decode_attention(_shard(q, 1, r, model), kl, vl, k_pos, q_pos,
                                split_groups=b * kv)
        assert torch.equal(part, _shard(full, 1, r, model))


# keys of another length than the queries: (Sq, Sk, H, Kv, D) -- whisper's
# cross-attention (6 heads of 64 against its 1500 frames), single rows,
# q and key tiles ragged on either side, GQA and MQA, every route
CROSS_CARD_CASES = [(77, 1500, 6, 6, 64), (448, 1500, 6, 6, 64),
                    (1, 65, 4, 2, 64), (130, 63, 8, 2, 64),
                    (65, 200, 4, 1, 16), (33, 257, 4, 2, 128),
                    (100, 70, 2, 1, 256), (64, 129, 4, 2, 120)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CROSS_CARD_CASES,
                         ids=lambda c: f"Sq{c[0]}-Sk{c[1]}-H{c[2]}kv{c[3]}"
                                       f"-D{c[4]}")
def test_flash_kernels_take_cross_lengths_on_card(cuda, case, dtype):
    sq, sk, h, kv, d = case
    rng = np.random.default_rng(9)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                * 0.7).to(cuda, TORCH_DT[dtype])
    q, k, v, do = rand(2, h, sq, d), rand(2, kv, sk, d), rand(2, kv, sk, d), \
        rand(2, h, sq, d)
    routes = dict(flash_attention.route_launches)
    o_only = flash_attention(q, k, v, causal=False)
    o, lse = flash_attention_fwd_lse(q, k, v, causal=False)
    dsum = (do.float() * o.float()).sum(-1)
    dq = flash_attention_dq(q, k, v, do, lse, dsum, causal=False)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, dsum, causal=False)
    torch.cuda.synchronize()
    route = fwd_route(q.dtype, d)
    assert flash_attention.route_launches[route] == routes[route] + 1
    f32 = [t.float() for t in (q, k, v, o, do)]
    want_o, want_lse = attention_lse_ref(*f32[:3], causal=False)
    want = attention_bwd_ref(*f32[:4], lse, f32[4], causal=False)
    tol = TOL[dtype] if dtype == "bfloat16" else 1e-4
    assert o.shape == q.shape and dk.shape == k.shape
    assert torch.equal(o, o_only)
    torch.testing.assert_close(o.float(), want_o.to(o.dtype).float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        torch.testing.assert_close(got.float(), w.to(got.dtype).float(),
                                   atol=tol, rtol=tol, msg=name)


# the bf16 D 256 backward on the tensor cores: (H, Kv, S, window), MQA as
# recurrentgemma-9b's 16/1 and GQA as gemma3-4b's 8/4, S off the 64-row
# tiles, causal with and without gemma3's local window
D256_BWD_CASES = [(h, kv, s, w) for h, kv in ((16, 1), (8, 4))
                  for s in (130, 1100) for w in (0, 1024)]


def _bwd256(cuda, h, kv, s, window, b=1, seed=11):
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                * 0.7).to(cuda, torch.bfloat16)
    q, k, v, do = rand(b, h, s, 256), rand(b, kv, s, 256), \
        rand(b, kv, s, 256), rand(b, h, s, 256)
    mask = dict(causal=True, window=window)
    o, lse = attention_lse_ref(q.float(), k.float(), v.float(), **mask)
    dsum = (do.float() * o).sum(-1)
    return (q, k, v, do, lse, dsum), o, mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", D256_BWD_CASES,
                         ids=lambda c: f"H{c[0]}kv{c[1]}-S{c[2]}-w{c[3]}")
def test_flash_backward_d256_on_tensor_cores_on_card(cuda, case):
    """dQ and the two-warpgroup dK/dV at bf16 D 256 against the plain
    backward in f32, within the bf16 tolerance the D 128 kernels meet;
    both launches counted on the tensor-core route."""
    h, kv, s, window = case
    args, o, mask = _bwd256(cuda, h, kv, s, window)
    before = [dict(f.route_launches)
              for f in (flash_attention_dq, flash_attention_dkv)]
    dq = flash_attention_dq(*args, **mask)
    dk, dv = flash_attention_dkv(*args, **mask)
    torch.cuda.synchronize()
    for f, was in zip((flash_attention_dq, flash_attention_dkv), before):
        assert f.route_launches["tensor_core"] == was["tensor_core"] + 1
    q, k, v, do, lse, _ = args
    want = attention_bwd_ref(q.float(), k.float(), v.float(), o, lse,
                             do.float(), **mask)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        torch.testing.assert_close(got.float(), w.to(got.dtype).float(),
                                   atol=TOL["bfloat16"],
                                   rtol=TOL["bfloat16"], msg=name)


@pytest.mark.cuda
def test_flash_dkv_d256_split_is_deterministic_on_card(cuda):
    """The largest split these cases give (MQA 16/1 at S 130: three key
    tiles, so each of 16 CTAs a key tile takes one query head): two
    launches give the same bits, and so does a tensor-parallel rank's
    launch on half the heads (GQA 8/4), its split the whole launch's."""
    args, _, mask = _bwd256(cuda, 16, 1, 130, 0)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert dkv_split(1, 130, 16, sms) == 16
    first = flash_attention_dkv(*args, **mask)
    second = flash_attention_dkv(*args, **mask)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    args, _, mask = _bwd256(cuda, 8, 4, 1100, 1024)
    full = flash_attention_dkv(*args, **mask)
    part = flash_attention_dkv(*(_shard(t, 1, 1, 2) for t in args), **mask)
    torch.cuda.synchronize()
    for a, b in zip(part, full):
        assert torch.equal(a, _shard(b, 1, 1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 16)])
def test_flash_kernels_refuse_masked_cross_lengths_on_card(cuda, causal,
                                                           window):
    q = torch.zeros(1, 2, 5, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 9, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="only without a mask"):
        flash_attention(q, k, k, causal=causal, window=window)


# the frontends' decode shapes: (B, H, Kv, S, D, cross) -- whisper's cross
# decode (every frame at position 0), internvl2's self-attention rings
# (14 query heads on 2 KV heads) with prompts of several lengths, and G 7
# at D 16 off the key tile
FRONTEND_DECODE_CASES = [(8, 6, 6, 1500, 64, True), (3, 14, 2, 520, 64, False),
                         (8, 14, 2, 2048, 64, False), (2, 7, 1, 97, 16, False),
                         (4, 14, 2, 1500, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FRONTEND_DECODE_CASES,
                         ids=lambda c: f"B{c[0]}-H{c[1]}kv{c[2]}-S{c[3]}-"
                                       f"D{c[4]}-{'cross' if c[5] else 'self'}")
def test_dense_decode_at_frontend_shapes_on_card(cuda, case, dtype):
    b, h, kv, s, d, cross = case
    rng = np.random.default_rng(10)
    dt = TORCH_DT[dtype]
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32)).to(
        cuda, dt)
    # the model's [B, S, Kv, D] layout read as [B, Kv, S, D] views
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kv, d), np.float32))
            .to(cuda, dt).transpose(1, 2) for _ in range(2))
    if cross:
        k_pos = torch.zeros((b, s), dtype=torch.int32, device=cuda)
        q_pos = torch.zeros(b, dtype=torch.int32, device=cuda)
    else:
        lens = rng.integers(1, s + 1, b)
        ar = np.arange(s)[None, :]
        k_pos = torch.from_numpy(np.where(ar < lens[:, None], ar, -1)
                                 .astype(np.int32)).to(cuda)
        q_pos = torch.from_numpy((lens - 1).astype(np.int32)).to(cuda)
    n0 = decode_attention.launches
    got = decode_attention(q, k, v, k_pos, q_pos)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    want = decode_attention_plain(q.float(), k.float(), v.float(), k_pos,
                                  q_pos)
    tol = TOL[dtype] if dtype == "bfloat16" else 1e-4
    torch.testing.assert_close(got.float(), want.to(dt).float(), atol=tol,
                               rtol=tol)
