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

from repro_torch.kernels import check_operand
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_op,
                                                  decode_attention_plain,
                                                  decode_mask)
from repro_torch.kernels.decode_attention.decode_attention import (
    KEY_TILE, split_len)

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


@pytest.mark.parametrize("s,groups,want_len", [
    (2048, 32, 256),     # yi-6b's legacy decode: 8 rows x 4 KV heads
    (2048, 8, 64),       # recurrentgemma's swa rings: 8 rows x 1 KV head
    (9, 32, KEY_TILE),   # shorter than one tile
    (100_000, 1, 384)])
def test_split_gives_the_card_a_wave(s, groups, want_len):
    """Splits are whole tiles that cover S; the two main-path shapes get
    at least one CTA per SM of a 132-SM card."""
    n = split_len(s, groups, 132)
    assert n == want_len and n % KEY_TILE == 0
    n_split = -(-s // n)
    assert (n_split - 1) * n < s <= n_split * n
    if s == 2048:
        assert groups * n_split >= 132


# ------------------------------------------------------------ on the card
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
def test_kernel_reads_a_strided_ring_on_card(cuda):
    rng = np.random.default_rng(8)
    b, s, kv, h, d = 4, 2048, 4, 32, 128
    ring_k = torch.randn(b, s, kv, d, device=cuda, dtype=torch.bfloat16)
    ring_v = torch.randn(b, s, kv, d, device=cuda, dtype=torch.bfloat16)
    q = torch.randn(b, h, d, device=cuda, dtype=torch.bfloat16)
    k_pos = torch.from_numpy(rng.integers(-1, 1500, (b, s)).astype(np.int32))
    q_pos = torch.tensor([1400, 20, 0, 1499], dtype=torch.int32)
    k_pos, q_pos = k_pos.to(cuda), q_pos.to(cuda)
    got = decode_attention(q, ring_k.transpose(1, 2), ring_v.transpose(1, 2),
                           k_pos, q_pos)
    want = decode_attention(q, ring_k.transpose(1, 2).contiguous(),
                            ring_v.transpose(1, 2).contiguous(), k_pos, q_pos)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_op_launches_the_kernel_on_card(cuda):
    x = to_torch(dead_rows_case(np.random.default_rng(9)), "float32", cuda)
    before = decode_attention.launches
    decode_attention_op(**x)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
