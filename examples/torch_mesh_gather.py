"""Time a mesh's all-gather of CUDA tensors, its ranks sharing one card.

Three readings a call, each the median of ROUNDS blocks of ITERS calls
on every rank at once (the blocks interleaved A B C C B A ...):

* ``rows`` — ``collectives.all_gather``: the ranks' bytes copied out of
  the arena's slots into rows (``Arena.gather_rows``), then concatenated;
* ``slots`` — the same call concatenating straight from the slots (one
  chunk), which the port does not keep: it saves one copy;
* ``barrier`` — the gloo barrier over the group alone, which every
  chunk of a collective pays.

Payloads: yi-6b's head-parallel attention outputs on a ``1x4`` mesh,
``[tokens, 8, 128]`` bf16 (32 heads over 4 ranks) for 4 decode tokens
and for 2435 prefill tokens, gathered along the head axis.  Needs a
card; run from the repository root::

    PYTHONPATH=src python examples/torch_mesh_gather.py [--model 4]
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives, ipc
from repro_torch.launch.mesh import MeshPool, make_host_mesh

ROUNDS, ITERS = 6, 200
TOKENS = (4, 2435)


def _slots(x: torch.Tensor, arena: ipc.Arena, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated straight from the slots (one
    chunk)."""
    src = x.contiguous().view(-1).view(torch.uint8)
    (_, _, s), = arena._chunks(src.numel(), 1)
    out = ipc.concat(arena._share(src, s), x.dtype, x.shape, dim)
    arena._release(s, x.device)
    return out


def rank(model: int) -> dict:
    """One rank: the ms a call of each reading, by payload tokens."""
    mesh = make_host_mesh(data=1, model=model)
    dev = torch.device("cuda", 0)
    group = mesh.group("model")
    gen = torch.Generator(device=dev).manual_seed(mesh.rank)
    out = {}
    for tokens in TOKENS:
        x = torch.randn((tokens, 32 // model, 128), generator=gen,
                        device=dev).to(torch.bfloat16)
        arena = ipc.arena(group, dev)
        runs = {
            "rows": lambda: collectives.all_gather(x, mesh, "model", 1),
            "slots": lambda: _slots(x, arena, 1),
            "barrier": lambda: dist.barrier(group=group)}
        a = collectives.all_gather(x, mesh, "model", 1)
        if not torch.equal(a, _slots(x, arena, 1)):
            raise AssertionError("the two routes disagree")
        times: dict[str, list[float]] = {k: [] for k in runs}
        order = list(runs)
        for r in range(ROUNDS):
            for name in (order if r % 2 == 0 else order[::-1]):
                torch.cuda.synchronize(dev)
                dist.barrier(group=group)
                t0 = time.perf_counter()
                for _ in range(ITERS):
                    runs[name]()
                torch.cuda.synchronize(dev)
                times[name].append((time.perf_counter() - t0) / ITERS * 1e3)
        out[tokens] = {k: statistics.median(v) for k, v in times.items()}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", type=int, default=4)
    args = ap.parse_args()
    with MeshPool(1, args.model, device="cuda") as pool:
        got = pool.run(rank, args.model)
    card = torch.cuda.get_device_name(0)
    for tokens in TOKENS:
        for name in ("rows", "slots", "barrier"):
            ms = ", ".join(f"{r[tokens][name]:.4f}" for r in got)
            print(f"[gather] 1x{args.model} on {card}: {tokens} tokens x "
                  f"{32 // args.model} heads x 128 bf16, {name}: {ms} ms "
                  f"a call by rank")


if __name__ == "__main__":
    main()
