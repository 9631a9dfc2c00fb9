"""Radix (prefix-trie) cache over refcounted paged KV blocks.

Thousands of concurrent requests share system prompts and few-shot
preambles; this tree remembers the KV blocks of recently-served prompt
prefixes so a new request whose prompt shares a cached prefix is admitted
with those tokens already "prefilled" — the engine skips straight to the
uncovered suffix.  The cache's share of the block budget is exactly the
kind of workload-dependent knob the paper's control loop exists for
(``serve.kv_cache_share``).

Structure and invariants:

  * Every tree node's **edge is block-aligned**: its token length is a
    multiple of ``block_tokens`` (T) and it owns exactly ``len(edge)//T``
    block ids, one tree-held reference each
    (``PagedKVAllocator.incref_blocks``).  Insertion only ever adds the
    *full-block* prefix of a finished prompt (``floor(len)/T*T`` tokens),
    so a tree-held block is never written again by the request that
    inserted it (decode and partial-tail writes land strictly beyond it).
  * **Lookup is token-granular**: a prompt may match mid-edge (and
    therefore mid-block).  The match is capped at ``len(prompt) - 1`` so
    the engine always prefills at least one token (it needs logits to
    sample from).  A mid-block match means the borrower shares the
    boundary block and must copy-on-write it before writing its own
    suffix (``KVLease.writable``) — sub-block sharing stays exact because
    paged attention is write-then-gather and causal masking hides the
    donor's bytes past the matched point until they are overwritten.
  * Divergence **splits round down** to a block boundary, so two sibling
    edges may share a token prefix shorter than T; lookup compares against
    every child and takes the longest match.
  * Eviction is **LRU leaf drop**: the coldest leaf's references are
    released; a block returns to the allocator's free list only when no
    lease still uses it.  ``enforce(budget)`` keeps the tree's held blocks
    inside the SmartConf-actuated cache share.
  * ``remap`` follows a store compaction's renumbering (installed as the
    allocator's ``remap_hook`` by the engine).

The port's copy of the reference's module: numpy only, on the port's
``paging.py``.
"""

from __future__ import annotations

import numpy as np

from .paging import PagedKVAllocator

__all__ = ["PrefixCache"]


def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = a[:n] != b[:n]
    return int(np.argmax(neq)) if neq.any() else n


class _Node:
    __slots__ = ("edge", "blocks", "children", "parent", "last_used")

    def __init__(self, edge: np.ndarray, blocks: list[int],
                 parent: "_Node | None") -> None:
        self.edge = edge
        self.blocks = blocks
        self.children: list[_Node] = []
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    def __init__(self, alloc: PagedKVAllocator) -> None:
        self.alloc = alloc
        self.block_tokens = alloc.block_tokens
        self.root = _Node(np.zeros((0,), np.int32), [], None)
        self.blocks_held = 0      # tree-held references (each block once)
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.evicted_blocks = 0

    # -------------------------------------------------------------- lookup
    def lookup(self, prompt: np.ndarray,
               now: int) -> tuple[int, list[int]]:
        """Longest cached prefix of ``prompt``: returns ``(match_tokens,
        blocks)`` where ``blocks`` are the ``ceil(match/T)`` physical ids
        covering it (the last one possibly partial — COW boundary).  The
        match is capped at ``len(prompt) - 1``.  Touches the path's LRU
        stamps; does NOT take references — the caller adopts the blocks
        into a lease (``PagedKVAllocator.lease(shared=...)``) in the same
        scheduling step."""
        self.lookups += 1
        t = self.block_tokens
        node, off = self.root, 0
        blocks: list[int] = []
        node.last_used = now
        while off < len(prompt):
            best, best_c = None, 0
            for ch in node.children:
                c = _common_prefix(prompt[off:], ch.edge)
                if c > best_c:
                    best, best_c = ch, c
            if best is None or best_c == 0:
                break
            best.last_used = now
            if best_c < len(best.edge):
                blocks.extend(best.blocks[:(best_c + t - 1) // t])
                off += best_c
                break
            blocks.extend(best.blocks)
            off += best_c
            node = best
        match = min(off, len(prompt) - 1)
        blocks = blocks[:(match + t - 1) // t]
        if match > 0:
            self.hits += 1
            self.hit_tokens += match
        return match, blocks

    def probe(self, prompt: np.ndarray) -> int:
        """Advisory match length only: how many of ``prompt``'s tokens a
        ``lookup`` *right now* would cover.  Mutates nothing (no LRU touch,
        no stats) — used by ``ServeEngine.submit`` to report the prospective
        hit in the :class:`Admission` receipt without perturbing eviction
        order; the authoritative (counted) lookup happens at scheduling."""
        node, off = self.root, 0
        while off < len(prompt):
            best, best_c = None, 0
            for ch in node.children:
                c = _common_prefix(prompt[off:], ch.edge)
                if c > best_c:
                    best, best_c = ch, c
            if best is None or best_c == 0:
                break
            off += best_c
            if best_c < len(best.edge):
                break
            node = best
        return min(off, len(prompt) - 1) if len(prompt) else 0

    # -------------------------------------------------------------- insert
    def insert(self, prompt: np.ndarray, lease_blocks: list[int],
               now: int) -> int:
        """Insert the full-block prefix of ``prompt`` (its KV lives in
        ``lease_blocks``, positionally).  Regions the tree already covers
        are left alone (the existing copies stay canonical); only the
        uncovered block-aligned suffix is adopted (one tree reference per
        block).  Returns the number of blocks newly held."""
        t = self.block_tokens
        n = (len(prompt) // t) * t
        node, off = self.root, 0
        node.last_used = now
        while off < n:
            best, best_c = None, 0
            for ch in node.children:
                c = _common_prefix(prompt[off:n], ch.edge)
                if c > best_c:
                    best, best_c = ch, c
            if best is None or best_c == 0:
                return self._add_child(node, prompt[off:n],
                                       lease_blocks[off // t: n // t], now)
            split = (best_c // t) * t
            if best_c == len(best.edge):
                best.last_used = now
                node, off = best, off + best_c
                continue
            if split == 0:
                # diverges inside the child's first block: a sibling that
                # shares < T leading tokens (lookup takes the longest match)
                return self._add_child(node, prompt[off:n],
                                       lease_blocks[off // t: n // t], now)
            # split the child at the block boundary below the divergence
            upper = _Node(best.edge[:split], best.blocks[:split // t], node)
            upper.last_used = now
            lower = best
            lower.edge = lower.edge[split:]
            lower.blocks = lower.blocks[split // t:]
            lower.parent = upper
            upper.children.append(lower)
            node.children[node.children.index(best)] = upper
            node, off = upper, off + split
        return 0

    def _add_child(self, node: _Node, edge: np.ndarray,
                   blocks: list[int], now: int) -> int:
        if len(edge) == 0:
            return 0
        assert len(edge) % self.block_tokens == 0
        assert len(blocks) == len(edge) // self.block_tokens
        self.alloc.incref_blocks(blocks)
        child = _Node(np.asarray(edge, np.int32).copy(), list(blocks), node)
        child.last_used = now
        node.children.append(child)
        self.blocks_held += len(blocks)
        return len(blocks)

    # ------------------------------------------------------------ eviction
    def _leaves(self) -> list[_Node]:
        out, stack = [], list(self.root.children)
        while stack:
            nd = stack.pop()
            if nd.children:
                stack.extend(nd.children)
            else:
                out.append(nd)
        return out

    def evict_lru_leaf(self) -> int:
        """Drop the coldest leaf; returns the tree references released
        (0 when the tree is empty)."""
        leaves = self._leaves()
        if not leaves:
            return 0
        victim = min(leaves, key=lambda nd: nd.last_used)
        victim.parent.children.remove(victim)
        self.alloc.decref_blocks(victim.blocks)
        n = len(victim.blocks)
        self.blocks_held -= n
        self.evicted_blocks += n
        return n

    def enforce(self, budget_blocks: int) -> int:
        """LRU-evict leaves until the tree holds at most
        ``budget_blocks``; returns references released."""
        released = 0
        while self.blocks_held > max(0, int(budget_blocks)):
            n = self.evict_lru_leaf()
            if n == 0:
                break
            released += n
        return released

    def clear(self) -> int:
        return self.enforce(0)

    # ----------------------------------------------------------- remapping
    def remap(self, mapping: dict[int, int]) -> None:
        """Follow a store compaction's renumbering (the allocator's
        ``remap_hook``)."""
        stack = [self.root]
        while stack:
            nd = stack.pop()
            nd.blocks = [mapping[b] for b in nd.blocks]
            stack.extend(nd.children)

    # --------------------------------------------------------------- stats
    @property
    def hit_rate(self) -> float:
        """Lifetime fraction of lookups that matched a cached prefix
        (diagnostic; the controller reads the engine's windowed
        token-weighted sensor)."""
        return 0.0 if self.lookups == 0 else self.hits / self.lookups
