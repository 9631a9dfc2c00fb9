"""The port's dense decode attention against the JAX package.

The plain version (what a CPU tensor runs, and what the CUDA kernel is
held to) against the JAX Pallas kernel in interpret mode on every row,
and against the JAX oracle on every row that admits a key (on a row that
admits none the oracle gives the mean of V, the Pallas kernel and the
port exact zeros), on the same inputs made from a numpy seed: the
reference's own cases (``tests/test_kernels.py``: ragged ``k_pos`` with
unwritten and future entries, windows 0 and 256, MHA/GQA/MQA), rows that
admit no key, an all-empty cache, and a strided ring view (the model's
``[B, S, Kv, D]`` ring read as ``[B, Kv, S, D]``).

Tolerances: f32 ``atol=rtol=2e-5`` (the oracle and the Pallas kernel
tile and sum in other orders: a few f32 ulps); bf16 ``atol=rtol=2e-2``
(all sides accumulate in f32 from the same bf16 inputs and round once to
bf16: an ulp or two of the output).

Tests marked ``cuda`` hold the CUDA kernel against the plain version on
the card; they skip where there is no card.  The machine with the card has
no JAX, so this file imports the JAX package only inside the ``jx``
fixture, and runs there without the repository's conftest:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_decode_attention.py
"""

import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import check_operand
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_op,
                                                  decode_attention_plain,
                                                  decode_mask)
from repro_torch.kernels import HEAD_DIMS
from repro_torch.kernels.decode_attention.decode_attention import (
    HEAD_CHUNK, KEY_TILE, KEY_TILES, MAX_SMEM, MAX_SPLIT, TWO_PER_SM,
    ctas_per_sm, key_parts, launch_plan, row_bytes, smem_bytes, split_len,
    tile_keys)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the reference's sweep: (b, h, kv, s, d, window)
SWEEP = [(2, 8, 2, 512, 64, 0), (1, 4, 1, 1024, 128, 256),
         (2, 4, 4, 384, 64, 0)]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def jx():
    """The JAX package's Pallas kernel (interpret mode) and oracle."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.decode_attention import (decode_attention,
                                                decode_attention_ref)
    dts = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

    def run(fn, case, dtype, **kw):
        args = [jnp.asarray(case[n], dts[dtype]) for n in ("q", "k", "v")]
        args += [jnp.asarray(case[n]) for n in ("k_pos", "q_pos")]
        return np.asarray(fn(*args, **kw), np.float32)

    return types.SimpleNamespace(
        pallas=lambda case, dtype, window: run(
            decode_attention, case, dtype, window=window, block_kv=128,
            interpret=True),
        oracle=lambda case, dtype, window: run(
            decode_attention_ref, case, dtype, window=window))


def sweep_case(rng, b, h, kv, s, d):
    """The reference's inputs: N(0, 1) q, k, v; k_pos uniform in
    [-1, 600) (unwritten and future entries); every row at position 599."""
    return dict(q=rng.standard_normal((b, h, d)).astype(np.float32),
                k=rng.standard_normal((b, kv, s, d)).astype(np.float32),
                v=rng.standard_normal((b, kv, s, d)).astype(np.float32),
                k_pos=rng.integers(-1, 600, (b, s)).astype(np.int32),
                q_pos=np.full(b, 599, np.int32))


def dead_rows_case(rng, *, h=4, kv=2, s=70, d=16):
    """Four rows: a ragged live row, an idle row (every slot unwritten, at
    position 0, as the engine passes its idle slots), a row whose keys all
    lie in its future, and a live row at a wrapped ring's positions."""
    k_pos = rng.integers(-1, 40, (4, s)).astype(np.int32)
    k_pos[1] = -1
    k_pos[2] = rng.integers(5, 40, s)
    k_pos[3] = (np.arange(s) + 110) % s + 60          # a wrapped ring
    return dict(q=rng.standard_normal((4, h, d)).astype(np.float32),
                k=rng.standard_normal((4, kv, s, d)).astype(np.float32),
                v=rng.standard_normal((4, kv, s, d)).astype(np.float32),
                k_pos=k_pos, q_pos=np.array([30, 0, 4, 131], np.int32))


def to_torch(case, dtype, device="cpu"):
    return {n: (torch.from_numpy(a).to(device, TORCH_DT[dtype])
                if a.dtype == np.float32 else torch.from_numpy(a).to(device))
            for n, a in case.items()}


def plain(case, dtype, window):
    return decode_attention_plain(**to_torch(case, dtype),
                                  window=window).float().numpy()


def live_rows(case, window):
    return decode_mask(torch.from_numpy(case["k_pos"]),
                       torch.from_numpy(case["q_pos"]), window).any(1).numpy()


def _close(got, want, dtype):
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


# ------------------------------------------------ plain version against JAX
@pytest.mark.parametrize("b,h,kv,s,d,w", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_oracle(jx, b, h, kv, s, d, w, dtype):
    case = sweep_case(np.random.default_rng(0), b, h, kv, s, d)
    got = plain(case, dtype, w)
    _close(got, jx.pallas(case, dtype, w), dtype)
    live = live_rows(case, w)
    assert live.all()
    _close(got[live], jx.oracle(case, dtype, w)[live], dtype)


@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_no_key_admits_are_exact_zeros(jx, window, dtype):
    """The idle and all-future rows give exact zeros, as the Pallas kernel
    gives; the live rows match the oracle."""
    case = dead_rows_case(np.random.default_rng(1))
    got = plain(case, dtype, window)
    _close(got, jx.pallas(case, dtype, window), dtype)
    live = live_rows(case, window)
    assert live.tolist() == [True, False, False, True]
    assert (got[~live] == 0).all()
    _close(got[live], jx.oracle(case, dtype, window)[live], dtype)


def test_empty_cache_gives_zeros(jx):
    """The reference's empty-cache case: every slot unwritten."""
    rng = np.random.default_rng(2)
    case = dict(q=rng.standard_normal((1, 4, 64)).astype(np.float32),
                k=np.zeros((1, 2, 128, 64), np.float32),
                v=np.zeros((1, 2, 128, 64), np.float32),
                k_pos=np.full((1, 128), -1, np.int32),
                q_pos=np.array([5], np.int32))
    got = plain(case, "float32", 0)
    assert (got == 0).all()
    np.testing.assert_array_equal(got, jx.pallas(case, "float32", 0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strided_ring_view(jx, dtype):
    """The model's ring ``[B, S, Kv, D]`` read through a transposed view
    gives what its contiguous copy gives, and what the Pallas kernel gives
    on the transposed array."""
    rng = np.random.default_rng(3)
    b, s, kv, h, d = 3, 48, 2, 8, 64
    ring_k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    ring_v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    pos = (np.arange(s)[None, :] + rng.integers(0, s, (b, 1))) % 61
    case = dict(q=rng.standard_normal((b, h, d)).astype(np.float32),
                k=ring_k.transpose(0, 2, 1, 3).copy(),
                v=ring_v.transpose(0, 2, 1, 3).copy(),
                k_pos=pos.astype(np.int32),
                q_pos=np.array([60, 30, 45], np.int32))
    x = to_torch(case, dtype)
    k_view = torch.from_numpy(ring_k).to(TORCH_DT[dtype]).transpose(1, 2)
    v_view = torch.from_numpy(ring_v).to(TORCH_DT[dtype]).transpose(1, 2)
    assert not k_view.is_contiguous()
    check_operand("k", k_view, dtype=TORCH_DT[dtype], ndim=4,
                  device=torch.device("cpu"), contiguous=False)
    got = decode_attention_plain(x["q"], k_view, v_view, x["k_pos"],
                                 x["q_pos"], window=16)
    want = decode_attention_plain(**x, window=16)
    assert torch.equal(got, want)
    _close(got.float().numpy(), jx.pallas(case, dtype, 16), dtype)


# ---------------------------------------------------- dispatch, operands
def test_op_runs_the_plain_version_on_the_cpu():
    case = dead_rows_case(np.random.default_rng(4))
    x = to_torch(case, "float32")
    before = decode_attention.launches
    got = decode_attention_op(**x, window=9)
    assert torch.equal(got, decode_attention_plain(**x, window=9))
    assert decode_attention.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    x = to_torch(dead_rows_case(np.random.default_rng(5)), "float32")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        decode_attention(**x)


@pytest.mark.parametrize("tensor", [
    torch.zeros(2, 3, 4, 16).transpose(2, 3),         # D not contiguous
    torch.zeros(2, 3, 5, 17)[..., :16]])              # rows not aligned
def test_strided_check_refuses(tensor):
    with pytest.raises(ValueError, match="strides"):
        check_operand("k", tensor, dtype=torch.float32, ndim=4,
                      device=torch.device("cpu"), contiguous=False)


@pytest.mark.parametrize("s,groups,tile,per_sm,want_len", [
    (2048, 32, 64, 2, 256),   # yi-6b's legacy decode: 8 rows x 4 KV heads
    (2048, 8, 64, 2, 64),     # 8 rows x 1 KV head at two CTAs an SM
    (9, 32, 64, 2, KEY_TILE),  # shorter than one tile
    (100_000, 1, 64, 2, 384),
    (2048, 8, 64, 1, 128),    # recurrentgemma's swa rings: one CTA an SM
    (2048, 32, 32, 1, 512),   # four splits a (row, KV head), one CTA an SM
    (20_000, 1, 64, 2, 128),  # one wave's splits
    (100_000, 600, 64, 2, 512),  # more groups than a wave: MAX_SPLIT rules
    (97, 24, 16, 2, 16)])
def test_split_gives_the_card_a_wave(s, groups, tile, per_sm, want_len):
    """Splits are whole tiles that cover S, none longer than MAX_SPLIT;
    at the main path's S the splits fit one wave of ``per_sm`` CTAs on
    each SM of a 132-SM card, and splits one tile shorter would not."""
    n = split_len(s, groups, 132, tile, per_sm)
    assert n == want_len and n % tile == 0 and n <= max(tile, MAX_SPLIT)
    n_split = -(-s // n)
    assert (n_split - 1) * n < s <= n_split * n
    if s == 2048:
        assert groups * n_split <= per_sm * 132
        assert n == tile or groups * -(-s // (n - tile)) > per_sm * 132


@settings(max_examples=200, deadline=None)
@given(s=st.integers(1, 70_000), groups=st.integers(1, 2000),
       sms=st.integers(1, 200), tile=st.sampled_from(KEY_TILES),
       per_sm=st.sampled_from([1, 2]))
def test_every_key_lies_in_exactly_one_split(s, groups, sms, tile, per_sm):
    """The splits [i n, (i + 1) n) for i < n_split partition [0, s): each
    key slot has one split, and every split holds at least one slot."""
    n = split_len(s, groups, sms, tile, per_sm)
    n_split = -(-s // n)
    owner = np.arange(s) // n
    assert owner.max() == n_split - 1
    assert np.bincount(owner, minlength=n_split).min() >= 1
    assert n % tile == 0 and n <= max(tile, MAX_SPLIT)
    # never more CTAs than one wave holds, unless MAX_SPLIT forces them
    if n_split > 1 and n_split * groups > per_sm * sms:
        assert n_split == -(-s // MAX_SPLIT) or n == tile


@pytest.mark.parametrize("esz,d,g,want", [
    # (bytes a K/V element, head dim, query heads a KV head) -> (keys a
    # tile, CTAs an SM)
    (2, 128, 8, (64, 2)),     # yi-6b, bf16
    (2, 256, 16, (64, 1)),    # recurrentgemma-9b's swa layers, bf16
    (2, 120, 4, (64, 2)),     # h2o-danube-3-4b, bf16
    (4, 128, 8, (64, 1)),
    (4, 256, 16, (32, 1)),    # f32 at D 256: three 64-key stages do not fit
    (4, 256, 1, (32, 1)),
    (2, 16, 1, (64, 2)),
    (2, 128, 16, (64, 2)),
    (2, 128, 64, (64, 2))])   # four head chunks of 16
def test_tile_and_ctas_per_sm(esz, d, g, want):
    assert (tile_keys(esz, d, g), ctas_per_sm(esz, d, g)) == want


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 12, 16, 17, 64, 80])
def test_every_shape_fits_a_cta(esz, d, g):
    """Every head dim, dtype and group size plans a CTA within MAX_SMEM
    (TWO_PER_SM where two are planned), whose warps' key parts hold at
    most 32 keys (one a lane), with the ring large enough to hold the key
    parts' partials for their merge."""
    tile = tile_keys(esz, d, g)
    per = tile // key_parts(g)
    assert tile % key_parts(g) == 0 and 1 <= per <= 32
    need = smem_bytes(esz, d, g, tile, MAX_SPLIT)
    assert need <= (TWO_PER_SM if ctas_per_sm(esz, d, g) == 2 else MAX_SMEM)
    rb = row_bytes(esz, d)
    assert rb & (rb - 1) == 0 and d * esz <= rb < 2 * max(16, d * esz)
    heads = min(g, HEAD_CHUNK)
    assert 4 * key_parts(g) * heads * (d + 4) <= need


@pytest.mark.parametrize("name,shape,want", [
    ("yi-6b legacy decode", (8, 32, 4, 2048, 128, 2),
     dict(tile=64, per_sm=2, head_chunks=1, split=256, n_split=8,
          ctas=256, smem=105_520)),
    ("recurrentgemma-9b swa rings", (8, 16, 1, 2048, 256, 2),
     dict(tile=64, per_sm=1, head_chunks=1, split=128, n_split=16,
          ctas=128, smem=217_632)),
    ("G 64, four head chunks", (2, 64, 1, 2049, 128, 2),
     dict(tile=64, per_sm=2, head_chunks=4, split=64, n_split=33,
          ctas=264, smem=110_872))])
def test_launch_plan_at_the_main_shapes(name, shape, want):
    plan = launch_plan(*shape, 132)
    assert {k: plan[k] for k in want} == want, name
    assert plan["stages"] == 3 and plan["smem"] <= MAX_SMEM


# ------------------------------------------------------------ on the card
def ring_case(rng, *, q_pos, h, kv, s, d, idle=0):
    """Rings ``[B, Kv, S, D]`` as the model fills them: each row holds its
    last ``min(q_pos + 1, s)`` positions at slot ``p % s`` (wrapped once
    ``q_pos >= s``), the rest unwritten; then ``idle`` rows at position 0
    with nothing written, as the engine passes its idle slots."""
    b = len(q_pos) + idle
    k_pos = np.full((b, s), -1, np.int32)
    for r, qp in enumerate(q_pos):
        p = np.arange(max(0, qp - s + 1), qp + 1)
        k_pos[r, p % s] = p
    return dict(q=rng.standard_normal((b, h, d)).astype(np.float32),
                k=rng.standard_normal((b, kv, s, d)).astype(np.float32),
                v=rng.standard_normal((b, kv, s, d)).astype(np.float32),
                k_pos=k_pos,
                q_pos=np.array(list(q_pos) + [0] * idle, np.int32))


def _edge_cases():
    """Every head dim at G 1, 8 and 16 and S off a 64-key tile (97, 2047,
    2049: a ring short of its window, one slot short of yi-6b's and one
    past it), over wrapped and partly filled rings with an idle row; then
    G 3 (idle warps), G 20 (a second head chunk of 4) and the largest G
    tested, 64 (four chunks), and windows that cut a tile."""
    cases = {}
    for i, d in enumerate(HEAD_DIMS):
        for j, (h, kv) in enumerate(((4, 4), (16, 2), (16, 1))):
            s = (97, 2047, 2049)[(i + j) % 3]
            cases[f"edge-D{d}-G{h // kv}-S{s}"] = (
                lambda rng, h=h, kv=kv, s=s, d=d: ring_case(
                    rng, q_pos=[s + 300, s // 2, 3 * s - 1], h=h, kv=kv,
                    s=s, d=d, idle=1), 0)
    for h, kv, d, s in ((6, 2, 64, 2047), (40, 2, 128, 2049),
                        (64, 1, 128, 2049), (64, 1, 256, 97)):
        cases[f"heads-G{h // kv}-D{d}-S{s}"] = (
            lambda rng, h=h, kv=kv, s=s, d=d: ring_case(
                rng, q_pos=[s - 1, s + 40, 5], h=h, kv=kv, s=s, d=d,
                idle=1), 0)
    for w in (100, 1000):      # a window that ends inside a 64-key tile
        cases[f"window-{w}-S2047"] = (
            lambda rng: ring_case(rng, q_pos=[2046, 5000, 70, 2047], h=32,
                                  kv=4, s=2047, d=128, idle=1), w)
    return cases


CARD_CASES = {
    # the reference's sweep, at its shapes
    **{f"sweep-{b}x{h}/{kv}-S{s}-D{d}-w{w}": (
        lambda rng, b=b, h=h, kv=kv, s=s, d=d: sweep_case(rng, b, h, kv, s, d),
        w) for b, h, kv, s, d, w in SWEEP},
    "dead-rows": (lambda rng: dead_rows_case(rng), 9),
    **{f"d{d}-{h}/{kv}-S{s}": (
        lambda rng, h=h, kv=kv, s=s, d=d: sweep_case(rng, 3, h, kv, s, d), 0)
        for d in (16, 64, 128, 256)
        for h, kv, s in ((4, 4, 31), (8, 2, 300), (16, 1, 2049))},
    **_edge_cases(),
    # every row wrapped many times over: its whole ring admitted
    "wrapped-rg": (lambda rng: ring_case(
        rng, q_pos=[2047 + 911 * r for r in range(8)], h=16, kv=1, s=2048,
        d=256), 2048),
    # idle rows only, and rows whose keys all lie in their future
    "no-key-admits": (lambda rng: dict(
        ring_case(rng, q_pos=[], h=8, kv=2, s=130, d=64, idle=3),
        k_pos=rng.integers(10, 40, (3, 130)).astype(np.int32),
        q_pos=np.array([0, 9, -1], np.int32)), 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(cuda, name, dtype):
    make, window = CARD_CASES[name]
    case = make(np.random.default_rng(7))
    x = to_torch(case, dtype, cuda)
    before = decode_attention.launches
    got = decode_attention(**x, window=window).float().cpu().numpy()
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_plain(
        **{n: (t.float() if t.is_floating_point() else t)
           for n, t in x.items()}, window=window)
    want = want.to(TORCH_DT[dtype]).float().cpu().numpy()
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    live = live_rows(case, window)
    assert (got[~live] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("s,window", [(2048, 0), (2047, 0), (2049, 300)])
def test_kernel_reads_a_strided_ring_on_card(cuda, s, window):
    """The model's ``[B, S, Kv, D]`` ring read in place through its
    ``[B, Kv, S, D]`` view gives its contiguous copy's output bit for bit,
    and the plain version's within the bf16 tolerance."""
    rng = np.random.default_rng(8)
    b, kv, h, d = 4, 4, 32, 128
    ring_k = torch.randn(b, s, kv, d, device=cuda, dtype=torch.bfloat16)
    ring_v = torch.randn(b, s, kv, d, device=cuda, dtype=torch.bfloat16)
    q = torch.randn(b, h, d, device=cuda, dtype=torch.bfloat16)
    k_pos = torch.from_numpy(rng.integers(-1, 1500, (b, s)).astype(np.int32))
    q_pos = torch.tensor([1400, 20, 0, 1499], dtype=torch.int32)
    k_pos, q_pos = k_pos.to(cuda), q_pos.to(cuda)
    got = decode_attention(q, ring_k.transpose(1, 2), ring_v.transpose(1, 2),
                           k_pos, q_pos, window=window)
    want = decode_attention(q, ring_k.transpose(1, 2).contiguous(),
                            ring_v.transpose(1, 2).contiguous(), k_pos, q_pos,
                            window=window)
    plain = decode_attention_plain(
        q.float(), ring_k.transpose(1, 2).float(),
        ring_v.transpose(1, 2).float(), k_pos, q_pos, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(got.float(), plain.bfloat16().float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_op_launches_the_kernel_on_card(cuda):
    x = to_torch(dead_rows_case(np.random.default_rng(9)), "float32", cuda)
    before = decode_attention.launches
    decode_attention_op(**x)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
