"""Device collectives for the ranks of a mesh that share one card.

NCCL refuses two ranks on one GPU, and gloo takes CPU tensors only, so
the ranks of :mod:`repro_torch.launch.mesh` (every one on card 0) sum
and gather device buffers through CUDA IPC instead: each rank copies its
payload into a buffer of its own that every peer has mapped, and each
rank reduces or gathers all of them on the card, in rank order.  Gloo
carries only a barrier (a few bytes) a chunk.

The arena
---------
Per process group that a CUDA collective uses, each rank holds an
:class:`Arena`: two slots of ``slot_bytes`` (:data:`SLOT_BYTES`) each,
one plain allocation a slot, a ``ready`` and a ``done`` interprocess
event a slot, and every peer's slots and events, opened once.  The arena
is built at the group's first CUDA collective (:func:`arena`): the
handles are exchanged with a gloo ``all_gather_object``, which every rank
of the group makes at the same point.  One arena a group, not one a rank:
a rank may still read a peer's slot for a call over ``data`` while that
peer already writes one over ``model``.  A group whose ranks sit on
different cards is refused.

A payload passes in chunks of at most ``slot_bytes`` (:func:`plan`), each
through one slot, the slot alternating chunk by chunk (``s``), in the
same order on every rank.  On the current stream (autograd's backward
runs on its own thread: the stream is read at each call):

1. wait for every rank's ``done[s]``, then copy the chunk into own slot
   ``s``;
2. record ``ready[s]``;
3. a gloo barrier on the group;
4. wait for every peer's ``ready[s]``;
5. fold (:func:`fold`) or concatenate the ranks' slots in rank order
   0..n-1 into the output;
6. record ``done[s]``.

Why this is sound.  A stream waits on the *last record issued* of an
event.  A peer records ``ready[s]`` before it enters the barrier of the
chunk, and cannot record it again before this rank has passed that
barrier and entered the next one, after step 4: so step 4 waits on this
chunk's record.  A peer records ``done[s]`` of chunk ``k`` before it
enters the barrier of chunk ``k + 1``; this rank rewrites slot ``s`` at
chunk ``k + 2``, after passing that barrier, so step 1 waits on the
record of chunk ``k`` at least.  A later one cannot have been issued:
the peer records ``done[s]`` of chunk ``k + 2`` only after the barrier of
``k + 2``, which this rank enters after step 1.  Own ``done[s]`` is
waited on too, for a call on another stream than the last.

Every rank folds the same bytes in the same order, so the ranks agree
bit for bit, as gloo's do.  :func:`close_arenas` closes the peers'
handles on every rank before any owner frees its slots.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["SLOT_BYTES", "Arena", "plan", "fold", "concat", "arena",
           "arena_count", "close_arenas"]

# the bytes of one slot: a chunk's bound
SLOT_BYTES = 64 * 2**20
SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX

# this process's arenas by process group, built in first-use order
_ARENAS: dict = {}


def plan(count: int, per: int, first: int = 0) -> list[tuple[int, int,
                                                             int]]:
    """The chunks of a payload of ``count`` elements through slots of
    ``per`` elements: ``(start, stop, slot)`` each, the slot alternating
    from the arena's ``first`` use on.  An empty payload has none."""
    if per < 1:
        raise ValueError(f"a slot of {per} elements holds nothing")
    return [(lo, min(lo + per, count), (first + i) % 2)
            for i, lo in enumerate(range(0, count, per))]


def fold(parts, op, out: torch.Tensor | None = None) -> torch.Tensor:
    """``parts`` reduced by ``op`` in rank order, a left fold in their
    dtype: ``parts[0] + parts[1] + ...`` for SUM, ``torch.maximum`` for
    MAX; into ``out`` when given, else a new tensor."""
    if op not in (SUM, MAX):
        raise ValueError(f"no device fold for {op}: SUM and MAX only")
    out = parts[0].clone() if out is None else out.copy_(parts[0])
    for p in parts[1:]:
        if op == SUM:
            out.add_(p)
        else:
            torch.maximum(out, p, out=out)
    return out


def concat(rows, dtype: torch.dtype, shape, dim: int) -> torch.Tensor:
    """The ranks' tensors of ``shape`` and ``dtype``, each a row of bytes
    in ``rows`` (``[n, nbytes]`` uint8), concatenated along ``dim`` in
    rank order."""
    return torch.cat([r.view(dtype).view(shape) for r in rows], dim)


class Arena:
    """This rank's two slots and events for ``group``, and its peers',
    on ``device`` (see the module docstring).  Every rank of ``group``
    builds it at the same point; it exchanges the handles over gloo."""

    def __init__(self, group, device, slot_bytes: int = SLOT_BYTES) -> None:
        from torch.multiprocessing.reductions import (rebuild_cuda_tensor,
                                                      reduce_tensor)
        if slot_bytes < 1:
            raise ValueError(f"slot_bytes {slot_bytes}")
        dev = torch.device(device)
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.slot_bytes = slot_bytes
        self.uses = 0
        self.slots = [torch.empty(slot_bytes, dtype=torch.uint8, device=dev)
                      for _ in range(2)]
        self.ready = [torch.cuda.Event(interprocess=True) for _ in range(2)]
        self.done = [torch.cuda.Event(interprocess=True) for _ in range(2)]
        # a share a peer: torch counts one release a share (the peer's,
        # when it drops the slot) before the owner may free it
        mine = dict(card=str(torch.cuda.get_device_properties(dev).uuid),
                    slots={r: [reduce_tensor(s)[1] for s in self.slots]
                           for r in range(self.n) if r != self.rank},
                    ready=[e.ipc_handle() for e in self.ready],
                    done=[e.ipc_handle() for e in self.done])
        everyone: list = [None] * self.n
        dist.all_gather_object(everyone, mine, group=group)
        cards = [e["card"] for e in everyone]
        if len(set(cards)) != 1:
            raise RuntimeError(f"the ranks of a group sit on cards {cards}:"
                               " CUDA IPC collectives need one card")

        def opened(r: int, own, handles, how):
            # a process cannot open its own handle: own objects directly
            return own if r == self.rank else [how(h) for h in handles]
        self.slots_of = [opened(r, self.slots, everyone[r]["slots"].get(
            self.rank), lambda a: rebuild_cuda_tensor(*a))
            for r in range(self.n)]
        self.ready_of = [opened(r, self.ready, everyone[r]["ready"],
                                lambda h: torch.cuda.Event.from_ipc_handle(
                                    dev, h)) for r in range(self.n)]
        self.done_of = [opened(r, self.done, everyone[r]["done"],
                               lambda h: torch.cuda.Event.from_ipc_handle(
                                   dev, h)) for r in range(self.n)]

    def _chunks(self, count: int, esize: int) -> list:
        chunks = plan(count, self.slot_bytes // esize, self.uses)
        self.uses += len(chunks)
        return chunks

    def _share(self, chunk: torch.Tensor, s: int) -> list[torch.Tensor]:
        """Steps 1-4 for ``chunk`` (1-D, contiguous) through slot ``s``:
        every rank's chunk in rank order, views of the slots."""
        stream = torch.cuda.current_stream(chunk.device)
        for done in self.done_of:
            stream.wait_event(done[s])
        nbytes = chunk.numel() * chunk.element_size()
        self.slots[s][:nbytes].view(chunk.dtype).copy_(chunk)
        self.ready[s].record(stream)
        dist.barrier(group=self.group)
        for r, ready in enumerate(self.ready_of):
            if r != self.rank:
                stream.wait_event(ready[s])
        return [slots[s][:nbytes].view(chunk.dtype)
                for slots in self.slots_of]

    def _release(self, s: int, device) -> None:
        """Step 6: this rank is done reading slot ``s`` of every rank."""
        self.done[s].record(torch.cuda.current_stream(device))

    def all_reduce(self, x: torch.Tensor, op=SUM,
                   out: torch.Tensor | None = None) -> torch.Tensor:
        """``x`` reduced by ``op`` (SUM or MAX) over the group, folded in
        rank order in x's dtype: a new tensor of x's shape, or ``out``
        (contiguous, x's shape; ``x`` itself may be it)."""
        if op not in (SUM, MAX):
            raise ValueError(f"no device fold for {op}: SUM and MAX only")
        src = x.contiguous().view(-1)
        dst = torch.empty_like(src) if out is None else out.view(-1)
        for lo, hi, s in self._chunks(src.numel(), src.element_size()):
            fold(self._share(src[lo:hi], s), op, out=dst[lo:hi])
            self._release(s, x.device)
        return dst.view(x.shape)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` as bytes, ``[n, x's bytes]`` uint8, row ``r``
        rank ``r``'s (each row 16-byte aligned, so a slice of it views as
        any dtype where it would in a tensor of its own)."""
        src = x.contiguous().view(-1).view(torch.uint8)
        width = -(-src.numel() // 16) * 16
        rows = torch.empty((self.n, width), dtype=torch.uint8,
                           device=x.device)[:, :src.numel()]
        for lo, hi, s in self._chunks(src.numel(), 1):
            for r, part in enumerate(self._share(src[lo:hi], s)):
                rows[r, lo:hi].copy_(part)
            self._release(s, x.device)
        return rows

    def _drop_peers(self) -> None:
        self.slots_of = self.ready_of = self.done_of = None

    def _drop_own(self) -> None:
        self.slots = self.ready = self.done = None

    def close(self) -> None:
        """Close the peers' handles, wait for the group, free the slots
        (every rank of the group calls it at the same point)."""
        self._drop_peers()
        torch.cuda.synchronize()
        dist.barrier(group=self.group)
        self._drop_own()


def arena(group, device) -> Arena:
    """``group``'s arena in this process, built at its first call (every
    rank of ``group`` must make that call at the same point)."""
    got = _ARENAS.get(group)
    if got is None:
        got = _ARENAS[group] = Arena(group, device)
    return got


def arena_count() -> int:
    """The arenas this process holds."""
    return len(_ARENAS)


def close_arenas(group) -> None:
    """Close every arena of this process: the peers' handles first, then,
    once this rank's reads are done, a barrier over ``group``, then the
    own slots.  Every rank calls it, with arenas or without; ``group``
    holds every rank and is used by no arena, so the barrier cannot meet
    a chunk's barrier a peer still waits in after a failed call."""
    arenas = list(_ARENAS.values())
    _ARENAS.clear()
    for a in arenas:
        a._drop_peers()
    torch.cuda.synchronize()
    dist.barrier(group=group)
    for a in arenas:
        a._drop_own()
