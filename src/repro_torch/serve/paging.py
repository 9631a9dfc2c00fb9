"""Physical block-table allocator behind the paged KV cache.

Where :class:`~repro_torch.serve.kv_cache.KVBlockPool` is a purely logical byte
ledger over a dense ``[max_batch, cache_len]`` cache, this allocator manages
a *real* resource: the identifier space of a physical block store
(``[capacity, kv_heads, block_tokens, head_dim]`` device arrays per
attention layer, owned by the engine).  ``serve.kv_block_budget`` therefore
actuates HBM, not a number.

The allocation surface is the :class:`KVLease` handle API:

  * :meth:`PagedKVAllocator.lease` reserves a per-sequence **block table**
    (physical block ids, drawn LIFO from a free list) covering the
    sequence's full extent — no cache-tree copy, no movement of other
    sequences' blocks (copy-free admission);
  * blocks are **refcounted**: a lease may adopt already-live blocks
    (``shared=``, the prefix cache's sharing path) or :meth:`KVLease.fork`
    an existing lease wholesale — either way the physical block is stored
    once and counted once;
  * the first write into a shared block must go through
    :meth:`KVLease.writable`, which resolves **copy-on-write**: every
    shared block overlapping the write span is re-homed to a fresh block
    and the ``(src, dst)`` pairs are returned for the engine to apply as a
    device-side block copy (``models/transformer.copy_paged_blocks``);
  * :meth:`KVLease.release` decrements; a block returns to the free list
    only when its last reference drops — which is what makes preemption
    COW-safe (a preempted borrower cannot free prefix blocks the cache
    still holds);
  * :meth:`KVLease.trim_front` drops a lease's leading blocks (interior
    ``-1`` table entries are masked by every paged kernel), the block-level
    sliding-window eviction path for all-window archs;
  * :meth:`KVLease.truncate` drops trailing blocks beyond a token extent —
    the speculative-decode finish path, which cuts rejected-draft K/V out
    of the lease before the prefix cache may adopt its blocks;
  * shrinking the budget below occupancy reports ``over_budget`` — the
    engine evicts cold cache prefixes, preempts lowest-priority sequences
    (paper §4.2 temporary-inconsistency semantics), then physically resizes
    the store via :meth:`compact` / :meth:`grow`.  ``remap_hook`` lets a
    block-id holder outside the lease registry (the prefix cache) follow a
    compaction's renumbering.

The accountant entry ``kv_cache`` tracks the *store capacity* — the bytes
the block store actually pins in HBM — so budget cuts move ``hbm_bytes``
itself, not just a ledger.  All bookkeeping is O(blocks touched); a failed
:meth:`lease` / :meth:`KVLease.extend` changes neither tables nor ledger.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sensors import HBMAccountant
from .kv_cache import kv_bytes_per_token

__all__ = ["KVLease", "PagedKVAllocator"]


class KVLease:
    """A refcounted claim on an ordered list of physical KV blocks.

    ``blocks[i]`` holds the lease's logical tokens ``[i*T, (i+1)*T)``; a
    ``-1`` entry marks a position whose block was trimmed
    (:meth:`trim_front`) — every paged kernel masks it.  The lease owns one
    reference per live block; sharing (``fork`` / the allocator's
    ``shared=`` adoption) adds references, never copies.  All mutation goes
    through the owning allocator so refcounts, the free list, and the HBM
    ledger can never disagree with the tables.
    """

    __slots__ = ("_alloc", "lease_id", "blocks", "tokens", "released")

    def __init__(self, alloc: "PagedKVAllocator", lease_id: int,
                 blocks: list[int], tokens: int) -> None:
        self._alloc = alloc
        self.lease_id = lease_id
        self.blocks = blocks          # -1 = trimmed front position
        self.tokens = tokens          # logical token extent covered
        self.released = False

    # ------------------------------------------------------------- queries
    @property
    def live_blocks(self) -> int:
        return sum(1 for b in self.blocks if b >= 0)

    def table_row(self) -> np.ndarray:
        """[max_blocks_per_seq] int32 physical ids, -1-padded — one row of
        the device block-table operand (trimmed positions stay -1)."""
        row = np.full((self._alloc.max_blocks_per_seq,), -1, np.int32)
        if self.blocks:
            row[:len(self.blocks)] = self.blocks
        return row

    def refcount(self, i: int) -> int:
        """Reference count of the block at table position ``i`` (0 for a
        trimmed position) — test/diagnostic surface."""
        b = self.blocks[i]
        return 0 if b < 0 else self._alloc._refs[b]

    # ------------------------------------------------------------ mutation
    def extend(self, tokens: int) -> bool:
        """Grow to cover ``tokens`` logical tokens (fresh blocks appended);
        False — with no state change — if the budget or free list blocks
        it."""
        return self._alloc._extend(self, tokens)

    def fork(self) -> "KVLease":
        """A new lease sharing every live block (one new reference each).
        Writers must go through :meth:`writable` before touching a shared
        block."""
        return self._alloc._fork(self)

    def writable(self, lo_tok: int, hi_tok: int) -> list[tuple[int, int]]:
        """Make the token span ``[lo_tok, hi_tok)`` safe to write: every
        shared block (refcount > 1) overlapping it is re-homed to a fresh
        private block.  Returns the ``(src, dst)`` physical-id pairs the
        caller must apply as a device block copy *before* writing, or
        ``None`` if the free list cannot supply the copies (no state
        change)."""
        return self._alloc._writable(self, lo_tok, hi_tok)

    def trim_front(self, first_keep_block: int) -> int:
        """Release blocks at table positions ``< first_keep_block``
        (sliding-window eviction); their entries become ``-1``.  Returns
        the number of references dropped."""
        return self._alloc._trim_front(self, first_keep_block)

    def truncate(self, tokens: int) -> int:
        """Shrink the lease to cover at most ``tokens`` logical tokens,
        releasing whole trailing blocks past that extent (the
        speculative-decode finish path: rejected-draft K/V lives past the
        last emitted token and must not survive into the prefix cache).
        Returns the number of references dropped."""
        return self._alloc._truncate(self, tokens)

    def release(self) -> None:
        """Drop the lease's references; idempotent.  Blocks whose count
        hits zero return to the free list (LIFO)."""
        self._alloc._release(self)


class PagedKVAllocator:
    """Refcounting free-list allocator over ``capacity`` physical KV blocks.

    Exposes the budget/occupancy surface the engine's SmartConf wiring
    consumes (``set_budget`` / ``used_blocks`` / ``alloc_failures`` /
    ``over_budget`` / ``frag_tokens``), the :class:`KVLease` handle API
    (``lease`` / ``incref_blocks`` / ``decref_blocks``), and the
    physical-side API (``compact`` / ``grow`` + ``remap_hook``).  The
    :class:`KVLease` handle API is the only allocation surface — the
    seed's seq_id-keyed ``ensure`` / ``free`` / ``table_row`` shim is gone.
    """

    def __init__(self, cfg: ArchConfig, *, block_tokens: int,
                 max_blocks_per_seq: int, capacity_blocks: int,
                 budget_blocks: int | None = None,
                 accountant: HBMAccountant | None = None) -> None:
        self.cfg = cfg
        self.block_tokens = block_tokens
        self.block_bytes = kv_bytes_per_token(cfg) * block_tokens
        self.max_blocks_per_seq = max_blocks_per_seq
        self.accountant = accountant
        self.capacity = int(capacity_blocks)
        # SmartConf budget (logical threshold; capacity tracks it physically)
        self.max_blocks = int(budget_blocks if budget_blocks is not None
                              else capacity_blocks)
        self._free: list[int] = list(range(self.capacity - 1, -1, -1))
        self._refs: list[int] = [0] * self.capacity
        self._leases: dict[int, KVLease] = {}
        self._next_lease = 0
        # blocks referenced from outside the lease registry (the prefix
        # cache) follow a compaction's renumbering through this hook
        self.remap_hook: Callable[[dict[int, int]], None] | None = None
        self.alloc_failures = 0
        self._charge_capacity()

    # ----------------------------------------------------------- accounting
    def _charge_capacity(self) -> None:
        if self.accountant is not None:
            self.accountant.set("kv_cache", self.capacity * self.block_bytes)

    @property
    def used_blocks(self) -> int:
        """Physical blocks holding live data.  A block shared by N leases
        (or N-1 leases + the prefix cache) counts ONCE — sharing is the
        capacity multiplier."""
        return self.capacity - len(self._free)

    @property
    def used_bytes(self) -> int:
        return self.used_blocks * self.block_bytes

    @property
    def live_seqs(self) -> int:
        return len(self._leases)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def over_budget(self) -> bool:
        """Occupancy above the SmartConf budget (tolerated, §4.2) — the
        engine's eviction/preemption trigger."""
        return self.used_blocks > self.max_blocks

    @property
    def frag_tokens(self) -> int:
        """Allocated-but-unused tail tokens across live leases (internal
        fragmentation of the last block plus up-front reservation).
        Trimmed positions carry no allocation, so they contribute none."""
        t = self.block_tokens
        total = 0
        for ls in self._leases.values():
            trimmed = len(ls.blocks) - ls.live_blocks
            total += max(0, ls.live_blocks * t - (ls.tokens - trimmed * t))
        return total

    # --------------------------------------------------------------- budget
    def set_budget(self, max_blocks: int) -> None:
        """Threshold update only; physical enforcement (cache eviction,
        preemption, store resize) is the engine's job because it owns
        slots, the cache tree, and the device arrays."""
        self.max_blocks = max(1, int(max_blocks))

    # ------------------------------------------------------------ refcounts
    def incref_blocks(self, blocks: Sequence[int]) -> None:
        """Add one reference per block id (the prefix cache's adoption
        path; ids must already be live)."""
        for b in blocks:
            if self._refs[b] <= 0:
                raise ValueError(f"incref of dead block {b}")
            self._refs[b] += 1

    def decref_blocks(self, blocks: Sequence[int]) -> int:
        """Drop one reference per block id; blocks hitting zero return to
        the free list.  Returns how many became free."""
        freed = 0
        for b in reversed(list(blocks)):   # LIFO: keep low ids warm
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)
                freed += 1
            elif self._refs[b] < 0:
                raise ValueError(f"refcount underflow on block {b}")
        return freed

    # ------------------------------------------------------------ lease API
    def lease(self, tokens: int,
              shared: Sequence[int] | None = None) -> KVLease | None:
        """A new lease covering ``tokens`` logical tokens.  ``shared``
        (optional) is an ordered prefix of already-live block ids to adopt
        — they are incref'd, not copied, and do not consume budget again.
        Returns ``None`` (with no state change, counted in
        ``alloc_failures``) if the budget or free list cannot supply the
        non-shared remainder."""
        tokens = min(tokens, self.max_blocks_per_seq * self.block_tokens)
        need = (tokens + self.block_tokens - 1) // self.block_tokens
        adopt = list(shared) if shared else []
        if len(adopt) > need:
            adopt = adopt[:need]
        fresh = need - len(adopt)
        if (self.used_blocks + fresh > self.max_blocks
                or fresh > len(self._free)):
            self.alloc_failures += 1
            return None
        self.incref_blocks(adopt)
        blocks = adopt + [self._alloc_block() for _ in range(fresh)]
        ls = KVLease(self, self._next_lease, blocks, tokens)
        self._next_lease += 1
        self._leases[ls.lease_id] = ls
        return ls

    def _alloc_block(self) -> int:
        b = self._free.pop()
        self._refs[b] = 1
        return b

    def _extend(self, ls: KVLease, tokens: int) -> bool:
        if ls.released:
            raise ValueError("extend on released lease")
        tokens = min(tokens, self.max_blocks_per_seq * self.block_tokens)
        need = (tokens + self.block_tokens - 1) // self.block_tokens
        delta = need - len(ls.blocks)
        if delta <= 0:
            ls.tokens = max(ls.tokens, tokens)
            return True
        if (self.used_blocks + delta > self.max_blocks
                or delta > len(self._free)):
            self.alloc_failures += 1
            return False
        ls.blocks.extend(self._alloc_block() for _ in range(delta))
        ls.tokens = max(ls.tokens, tokens)
        return True

    def _fork(self, ls: KVLease) -> KVLease:
        if ls.released:
            raise ValueError("fork of released lease")
        self.incref_blocks([b for b in ls.blocks if b >= 0])
        child = KVLease(self, self._next_lease, list(ls.blocks), ls.tokens)
        self._next_lease += 1
        self._leases[child.lease_id] = child
        return child

    def _writable(self, ls: KVLease, lo_tok: int,
                  hi_tok: int) -> list[tuple[int, int]] | None:
        if ls.released:
            raise ValueError("writable on released lease")
        t = self.block_tokens
        lo = max(0, lo_tok) // t
        hi = min(len(ls.blocks), (max(lo_tok, hi_tok) + t - 1) // t)
        cow = [i for i in range(lo, hi)
               if ls.blocks[i] >= 0 and self._refs[ls.blocks[i]] > 1]
        if not cow:
            return []
        if len(cow) > len(self._free):
            self.alloc_failures += 1
            return None
        pairs = []
        for i in cow:
            src = ls.blocks[i]
            dst = self._alloc_block()
            self._refs[src] -= 1          # shared: never hits zero here
            ls.blocks[i] = dst
            pairs.append((src, dst))
        return pairs

    def _trim_front(self, ls: KVLease, first_keep_block: int) -> int:
        if ls.released:
            raise ValueError("trim_front on released lease")
        drop = [b for b in ls.blocks[:first_keep_block] if b >= 0]
        if not drop:
            return 0
        for i in range(min(first_keep_block, len(ls.blocks))):
            ls.blocks[i] = -1
        self.decref_blocks(drop)
        return len(drop)

    def _truncate(self, ls: KVLease, tokens: int) -> int:
        if ls.released:
            raise ValueError("truncate on released lease")
        tokens = max(0, int(tokens))
        keep = (tokens + self.block_tokens - 1) // self.block_tokens
        drop = [b for b in ls.blocks[keep:] if b >= 0]
        del ls.blocks[keep:]
        ls.tokens = min(ls.tokens, tokens)
        if drop:
            self.decref_blocks(drop)
        return len(drop)

    def _release(self, ls: KVLease) -> None:
        if ls.released:
            return
        ls.released = True
        self._leases.pop(ls.lease_id, None)
        self.decref_blocks([b for b in ls.blocks if b >= 0])

    # ------------------------------------------------------ physical resize
    def compact(self, new_capacity: int) -> np.ndarray:
        """Shrink to ``new_capacity`` blocks.  Live blocks are renumbered
        densely into ``[0, used_blocks)`` — each block once, however many
        references it holds (lease tables updated in place; external
        holders via ``remap_hook``); returns ``keep`` — old physical ids,
        one per new slot — for the engine to gather the store arrays with
        (``new_store = old_store[keep]``)."""
        if not self.used_blocks <= new_capacity <= self.capacity:
            raise ValueError(
                f"compact({new_capacity}) with used={self.used_blocks} "
                f"capacity={self.capacity}")
        keep = np.zeros((new_capacity,), np.int32)   # unused slots -> old 0
        mapping: dict[int, int] = {}
        nxt = 0
        refs = [0] * int(new_capacity)

        def renumber(old: int) -> int:
            nonlocal nxt
            new = mapping.get(old)
            if new is None:
                new = mapping[old] = nxt
                keep[new] = old
                nxt += 1
            return new

        for lease_id in sorted(self._leases):
            ls = self._leases[lease_id]
            for j, old in enumerate(ls.blocks):
                if old >= 0:
                    ls.blocks[j] = renumber(old)
        # blocks held only outside the lease registry (the prefix cache)
        for old, r in enumerate(self._refs):
            if r > 0 and old not in mapping:
                renumber(old)
        if self.remap_hook is not None:
            self.remap_hook(dict(mapping))
        for old, new in mapping.items():
            refs[new] = self._refs[old]
        self.capacity = int(new_capacity)
        self._refs = refs
        self._free = list(range(new_capacity - 1, nxt - 1, -1))
        self._charge_capacity()
        return keep

    def grow(self, new_capacity: int) -> int:
        """Extend the id space; returns the number of blocks added.  The
        engine zero-pads the store arrays to match."""
        if new_capacity < self.capacity:
            raise ValueError(f"grow({new_capacity}) below {self.capacity}")
        added = int(new_capacity) - self.capacity
        self._free[:0] = range(int(new_capacity) - 1, self.capacity - 1, -1)
        self._refs.extend([0] * added)
        self.capacity = int(new_capacity)
        self._charge_capacity()
        return added
