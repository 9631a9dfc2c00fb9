"""The mesh collectives' device transport (``distributed/ipc.py``) and the
dispatch by the payload's device (``distributed/collectives.py``).

On the CPU:

* the rank-order fold equals a numpy left fold bit for bit (f32, bf16
  rounded after every add as torch rounds it, int32; SUM and MAX; 2 and 4
  parts; odd element counts), and any other op raises;
* the rank-order concatenation of byte rows equals ``torch.cat`` along
  dims 0 and 1;
* the chunk plan of payloads of 0, 1, ``SLOT_BYTES`` and ``SLOT_BYTES +
  1`` bytes, the slot alternating from the arena's next use;
* the arena's chunk loops (all-reduce in place and not, the byte-row
  gather, and the all-gather concatenated from its rows) over ranks held
  in one process, their slot sequence alternating call after call;
* a CPU mesh's collectives run on gloo and build no arena (a ``2x2``
  ``MeshPool``, the count returned by each rank), their results against
  numpy;
* the gloo path raises on a tensor that is not on the CPU (``meta``).

On the card (``cuda``-marked, skipped here): the transport check of
``chip_smoke.py`` on ``1x2`` and ``2x2`` pools, every collective bit for
bit; and a rank that raises between two collectives fails the run, and
the pool's fresh ranks then sum right.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ipc_ranks as ranks
from repro_torch.distributed import collectives, ipc
from repro_torch.launch.mesh import MeshPool

OPS = {"sum": ipc.SUM, "max": ipc.MAX}


def bf16_round(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (to nearest, ties to even), as f32."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16
    return u.astype(np.uint32).view(np.float32)


def numpy_fold(parts: list[np.ndarray], op: str, dtype: str) -> np.ndarray:
    """The left fold ``((p0 . p1) . p2) ...`` in numpy; bf16 as f32
    rounded to bf16 after every step."""
    out = parts[0].copy()
    for p in parts[1:]:
        out = out + p if op == "sum" else np.maximum(out, p)
        if dtype == "bfloat16":
            out = bf16_round(out)
    return out


def draw(rng, dtype: str, n: int) -> np.ndarray:
    if dtype == "int32":
        return rng.integers(-2**20, 2**20, n).astype(np.int32)
    x = rng.standard_normal(n).astype(np.float32) * 100
    return bf16_round(x) if dtype == "bfloat16" else x


def as_torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(x).to(getattr(torch, dtype))


def bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(-1).view(torch.uint8).numpy()


@pytest.mark.parametrize("count", [1, 37, 1001])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", list(OPS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_fold_is_a_left_fold_in_rank_order(dtype, op, n, count):
    rng = np.random.default_rng(count + n)
    parts = [draw(rng, dtype, count) for _ in range(n)]
    got = ipc.fold([as_torch(p, dtype) for p in parts], OPS[op])
    want = as_torch(numpy_fold(parts, op, dtype), dtype)
    assert got.dtype == getattr(torch, dtype)
    assert (bits(got) == bits(want)).all()
    # into a given output, the inputs untouched
    out = torch.empty_like(got)
    ts = [as_torch(p, dtype) for p in parts]
    assert ipc.fold(ts, OPS[op], out=out) is out
    assert (bits(out) == bits(want)).all()
    assert (bits(ts[0]) == bits(as_torch(parts[0], dtype))).all()


def test_fold_order_is_the_ranks():
    """Four f32 parts whose sum depends on the order: rank order's."""
    parts = [np.array([v], np.float32) for v in (1e8, 1.0, -1e8, 1.0)]
    got = ipc.fold([torch.from_numpy(p) for p in parts], ipc.SUM)
    assert float(got[0]) == 1.0          # (1e8 + 1) rounds to 1e8
    assert float(ipc.fold([torch.from_numpy(p) for p in parts[::-1]],
                          ipc.SUM)[0]) == 0.0


def test_fold_refuses_other_ops():
    with pytest.raises(ValueError, match="SUM and MAX"):
        ipc.fold([torch.ones(3), torch.ones(3)], dist.ReduceOp.PRODUCT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("n", [2, 4])
def test_concat_gathers_in_rank_order(n, dim, dtype):
    rng = np.random.default_rng(n + dim)
    shape = (3, 5, 7)
    xs = [as_torch(draw(rng, dtype, 105).reshape(shape), dtype)
          for _ in range(n)]
    rows = torch.stack([x.reshape(-1).view(torch.uint8) for x in xs])
    got = ipc.concat(rows, xs[0].dtype, shape, dim)
    assert (bits(got) == bits(torch.cat(xs, dim))).all()
    assert got.shape == torch.cat(xs, dim).shape


@pytest.mark.parametrize("first", [0, 1, 6])
@pytest.mark.parametrize("nbytes", [0, 1, ipc.SLOT_BYTES,
                                    ipc.SLOT_BYTES + 1])
def test_chunk_plan(nbytes, first):
    got = ipc.plan(nbytes, ipc.SLOT_BYTES, first)
    want = {0: [], 1: [(0, 1)], ipc.SLOT_BYTES: [(0, ipc.SLOT_BYTES)],
            ipc.SLOT_BYTES + 1: [(0, ipc.SLOT_BYTES),
                                 (ipc.SLOT_BYTES, ipc.SLOT_BYTES + 1)]}
    assert [(lo, hi) for lo, hi, _ in got] == want[nbytes]
    assert [s for _, _, s in got] == [(first + i) % 2
                                      for i in range(len(got))]
    # the chunks tile the payload, each within a slot
    assert sum(hi - lo for lo, hi, _ in got) == nbytes
    assert all(0 < hi - lo <= ipc.SLOT_BYTES for lo, hi, _ in got)


def test_chunk_plan_in_elements():
    """A slot of 10 bytes holds 2 f32: 5 elements in 3 chunks."""
    assert ipc.plan(5, 10 // 4) == [(0, 2, 0), (2, 4, 1), (4, 5, 0)]
    with pytest.raises(ValueError):
        ipc.plan(5, 0)


class LocalArena(ipc.Arena):
    """An arena whose ``n`` ranks' payloads lie in this process: rank 0's
    chunk loops run as on the card, each chunk's exchange handing back
    every rank's same span (``inputs``: each rank's tensor, in the order
    the calls come) and recording its slot."""

    def __init__(self, inputs: list[list[torch.Tensor]], slot_bytes: int):
        self.n, self.rank, self.slot_bytes, self.uses = (len(inputs[0]), 0,
                                                         slot_bytes, 0)
        self.calls = iter(inputs)
        self.slots_seen: list[int] = []
        self.released: list[int] = []

    def _chunks(self, count, esize):
        self.current = [x.contiguous().view(-1) for x in next(self.calls)]
        return super()._chunks(count, esize)

    def _share(self, chunk, s):
        self.slots_seen.append(s)
        lo = chunk.storage_offset()     # a gather's in bytes
        return [x.view(chunk.dtype)[lo:lo + chunk.numel()]
                for x in self.current]

    def _release(self, s, device):
        self.released.append(s)


def test_arena_chunk_loops_on_the_cpu():
    rng = np.random.default_rng(7)
    n, count = 3, 1001
    xs = [torch.from_numpy(draw(rng, "float32", count)) for _ in range(n)]
    ys = [x.clone() for x in xs]
    g = [torch.from_numpy(draw(rng, "float32", 3 * 7 * 5)).view(3, 7, 5)
         for _ in range(n)]
    arena = LocalArena([xs, xs, ys, g, g, g], slot_bytes=4 * 300)
    # all-reduce: 1001 f32 through slots of 300, four chunks
    got = arena.all_reduce(xs[0], ipc.SUM)
    assert (bits(got) == bits(ipc.fold(xs, ipc.SUM))).all()
    got = arena.all_reduce(xs[0], ipc.MAX)
    assert (bits(got) == bits(ipc.fold(xs, ipc.MAX))).all()
    # in place: the input is the output
    want = ipc.fold(ys, ipc.SUM)
    assert arena.all_reduce(ys[0], ipc.SUM, out=ys[0]) is not None
    assert (bits(ys[0]) == bits(want)).all()
    assert arena.slots_seen == [0, 1, 0, 1] * 3
    # a gather of 420 bytes through slots of 1200: one chunk; rows
    # 16-byte aligned, concatenated as collectives.all_gather does
    for dim in (0, 1):
        got = ipc.concat(arena.gather_rows(g[0]), g[0].dtype, g[0].shape,
                         dim)
        assert (bits(got) == bits(torch.cat(g, dim))).all()
    rows = arena.gather_rows(g[0])
    assert rows.shape == (n, 420) and rows.stride(0) % 16 == 0
    for r in range(n):
        assert (rows[r].numpy() == bits(g[r])).all()
    assert arena.slots_seen[12:] == [0, 1, 0]
    assert arena.released == arena.slots_seen
    assert arena.uses == 15


def test_cpu_mesh_runs_on_gloo_and_builds_no_arena():
    seed = 11
    with MeshPool(2, 2, device="cpu", timeout_s=60.0, threads=1) as pool:
        got = pool.run(ranks.cpu_collectives, seed)
    assert [r["arenas"] for r in got] == [0, 0, 0, 0]
    x = [r["x"] for r in got]
    full = ranks.full_tree(seed)
    for r in got:
        d, m = divmod(r["rank"], 2)
        row = [x[2 * d], x[2 * d + 1]]
        col = [x[m], x[2 + m]]
        np.testing.assert_array_equal(r["sum_model"], row[0] + row[1])
        np.testing.assert_array_equal(r["max_all"],
                                      np.maximum.reduce(x))
        np.testing.assert_array_equal(r["gather_data"],
                                      np.concatenate(col, 1))
        leaves = [got[m]["leaves"], got[2 + m]["leaves"]]
        for i, b in enumerate(r["buckets"]):
            np.testing.assert_array_equal(b, leaves[0][i] + leaves[1][i])
        for k, v in full.items():
            np.testing.assert_array_equal(r["gathered"][k], v)


class StubMesh:
    """A mesh of two ranks on every axis, with no process group."""

    def axis_size(self, axes) -> int:
        return 2

    def group(self, axes):
        return None


def test_gloo_path_raises_on_a_device_tensor():
    x = torch.empty(3, 4, device="meta")
    with pytest.raises(ValueError, match="gloo carries CPU tensors"):
        collectives.all_reduce(x, StubMesh(), "model")
    with pytest.raises(ValueError, match="gloo carries CPU tensors"):
        collectives.all_gather(x, StubMesh(), "model", 1)
    with pytest.raises(ValueError, match="gloo carries CPU tensors"):
        collectives._gather_rows(x.reshape(-1), None, 2)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the arenas live on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_transport_check_on_card(cuda, mesh, monkeypatch):
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    with MeshPool(*mesh, device="cuda", timeout_s=120.0) as pool:
        got = pool.run(chip_smoke.ipc_rank, *mesh, "cuda")
    assert all(not r["faults"] and r["checks"] for r in got)
    assert all(r["arenas"] >= 1 for r in got)


@pytest.mark.cuda
def test_a_rank_failing_between_collectives_on_card(cuda):
    """Rank 1 raises between two all-reduces over ``model`` while rank 0
    waits in the second one's barrier: the run fails, the pool stops its
    ranks (their arenas' teardown on a group of its own), and the ranks
    it starts anew sum on the card right."""
    with MeshPool(1, 2, device="cuda", timeout_s=15.0) as pool:
        with pytest.raises(RuntimeError, match="fails between"):
            pool.run(ranks.fail_between_collectives, "cuda")
        got = pool.run(ranks.card_sum, "cuda")
    assert got == [[3.0, 3.0], [3.0, 3.0]]
