"""KV byte accounting, and the dense-mode KV ledger.

``kv_bytes_per_token`` sizes one token of context across all attention
layers; ``QUEUE_TOKEN_BYTES`` is what one queued prompt token holds.  Both
feed the SmartConf ``hbm_bytes`` controllers' gains, so the deputy metric
and the controller model can never drift apart.

:class:`KVBlockPool` is the ledger behind ``serve.kv_block_budget`` when
the engine keeps dense per-slot KV rings (hybrid archs, or
``kv_mode="dense"``): the rings are allocated once at engine batch
capacity, and the pool tracks logical occupancy in blocks of fixed token
granularity, charging and crediting the accountant's ``kv_cache`` entry.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sensors import HBMAccountant

__all__ = ["DenseKVLease", "KVBlockPool", "kv_bytes_per_token",
           "QUEUE_TOKEN_BYTES"]

# Host+device bytes one *queued* prompt token holds (int32 token + int32
# label/scratch view).  Both the admission-queue deputy accounting in
# ``ServeEngine.submit`` and the ``serve.max_queue_tokens`` controller gain
# (alpha = bytes released per queued token shed) derive from this constant.
QUEUE_TOKEN_BYTES = 8


def kv_bytes_per_token(cfg: ArchConfig) -> int:
    """HBM bytes one token of context occupies across all layers."""
    dt = 2 if cfg.dtype == "bfloat16" else 4
    hd = cfg.resolved_head_dim
    per_layer_attn = 2 * cfg.num_kv_heads * hd * dt
    total = 0
    pattern = cfg.block_pattern
    for i in range(cfg.num_layers):
        base = pattern[i % len(pattern)].split("+")[0]
        if base in ("rwkv6", "rglru"):
            continue  # O(1) state, not per-token
        total += per_layer_attn
    return total


@dataclasses.dataclass
class _Seq:
    blocks: int
    tokens: int = 0     # logical tokens covered (for fragmentation stats)


class DenseKVLease:
    """Dense-mode twin of :class:`~repro_torch.serve.paging.KVLease`: the
    same ``extend`` / ``release`` handle surface over the ledger, so the
    engine's scheduling path does not depend on the KV mode.  Dense rings
    are per slot: nothing is shared, so there is no fork or copy-on-write."""

    __slots__ = ("_pool", "_key", "released")

    def __init__(self, pool: "KVBlockPool", key: int) -> None:
        self._pool = pool
        self._key = key
        self.released = False

    def extend(self, tokens: int) -> bool:
        if self.released:
            raise ValueError("extend on released lease")
        return self._pool.ensure(self._key, tokens)

    def release(self) -> None:
        if self.released:
            return
        self.released = True
        self._pool.free(self._key)


class KVBlockPool:
    """Logical block ledger under a SmartConf-actuated budget."""

    def __init__(self, cfg: ArchConfig, *, block_tokens: int = 64,
                 max_blocks: int = 4096,
                 accountant: HBMAccountant | None = None) -> None:
        self.cfg = cfg
        self.block_tokens = block_tokens
        self.block_bytes = kv_bytes_per_token(cfg) * block_tokens
        self.max_blocks = max_blocks
        self.accountant = accountant
        self._seqs: dict[int, _Seq] = {}
        self.used_blocks = 0
        self.alloc_failures = 0
        self._next_lease = 0

    def lease(self, tokens: int) -> DenseKVLease | None:
        """A handle covering ``tokens``, or None if the budget blocks it."""
        key = self._next_lease
        self._next_lease += 1
        if not self.ensure(key, tokens):
            return None
        return DenseKVLease(self, key)

    def set_budget(self, max_blocks: int) -> None:
        """Threshold update (the deputy is ``used_blocks``); sequences above
        a new, lower budget are tolerated until they free (paper §4.2
        temporary inconsistency)."""
        self.max_blocks = max(1, int(max_blocks))

    def ensure(self, seq_id: int, tokens: int) -> bool:
        """Grow a sequence to cover ``tokens``; False if the budget blocks
        it."""
        need = -(-tokens // self.block_tokens)
        seq = self._seqs.get(seq_id)
        delta = need - (seq.blocks if seq else 0)
        if delta <= 0:
            if seq is not None:
                seq.tokens = max(seq.tokens, tokens)
            return True
        if self.used_blocks + delta > self.max_blocks:
            self.alloc_failures += 1
            return False
        if seq is None:
            seq = self._seqs[seq_id] = _Seq(0)
        seq.blocks += delta
        seq.tokens = max(seq.tokens, tokens)
        self.used_blocks += delta
        if self.accountant is not None:
            self.accountant.charge("kv_cache", delta * self.block_bytes)
        return True

    def free(self, seq_id: int) -> None:
        seq = self._seqs.pop(seq_id, None)
        if seq is None:
            return
        self.used_blocks -= seq.blocks
        if self.accountant is not None:
            self.accountant.credit("kv_cache", seq.blocks * self.block_bytes)

    @property
    def used_bytes(self) -> int:
        return self.used_blocks * self.block_bytes

    @property
    def live_seqs(self) -> int:
        return len(self._seqs)

    @property
    def over_budget(self) -> bool:
        """Occupancy above the budget: §4.2 temporary inconsistency while
        live sequences drain."""
        return self.used_blocks > self.max_blocks

    @property
    def frag_tokens(self) -> int:
        """Allocated-but-unused tail tokens across live sequences."""
        return sum(s.blocks * self.block_tokens - s.tokens
                   for s in self._seqs.values())
