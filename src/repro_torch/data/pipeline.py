"""Synthetic LM data pipeline with SmartConf-controlled prefetch (a copy of
``src/repro/data/pipeline.py``: pure numpy, its batches bit for bit).

Deterministic PRNG token stream, host-sharded; a background producer thread
fills a bounded prefetch queue.  The queue depth (``data.prefetch_depth``) is
an *indirect, hard* PerfConf (deputy = buffered batches; metric = host RSS
bytes), the CA6059 analogue in this framework: deeper prefetch absorbs
producer jitter (straggling input shards) at the cost of host memory.

Straggler mitigation: a per-batch production deadline; if the producer
misses it, a synthetic *backup batch* is substituted (duplicate-of-last
semantics, standard backup-task trick) and the event is counted.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from repro_torch.core.sensors import HBMAccountant, QueueGauge

__all__ = ["SyntheticTokens", "PrefetchPipeline"]


class SyntheticTokens:
    """Deterministic, restartable token source (host-sharded)."""

    def __init__(self, vocab_size: int, batch_size: int, seq_len: int, *,
                 host_id: int = 0, num_hosts: int = 1, seed: int = 0) -> None:
        assert batch_size % num_hosts == 0
        self.vocab_size = vocab_size
        self.batch_size = batch_size
        self.local_batch = batch_size // num_hosts
        self.seq_len = seq_len
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.seed = seed
        self.step = 0

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])

    def next_batch(self) -> dict:
        # per-(step, host) independent stream => restart-exact and elastic
        rng = np.random.default_rng(
            (self.seed, self.step, self.host_id))
        tokens = rng.integers(0, self.vocab_size,
                              (self.local_batch, self.seq_len + 1),
                              dtype=np.int32)
        self.step += 1
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def batch_nbytes(self) -> int:
        return self.local_batch * (self.seq_len + 1) * 4 * 2


class PrefetchPipeline:
    """Bounded background prefetch over any ``next_batch`` source."""

    def __init__(self, source, *, depth: int = 2,
                 accountant: HBMAccountant | None = None,
                 produce_deadline_s: float | None = None,
                 delay_fn=None) -> None:
        self.source = source
        self._depth = max(1, int(depth))
        self._queue: queue.Queue = queue.Queue(maxsize=self._depth)
        self.gauge = QueueGauge()
        self.accountant = accountant
        self.produce_deadline_s = produce_deadline_s
        self.delay_fn = delay_fn          # test hook: simulate slow shards
        self.backup_batches = 0           # straggler substitutions
        self._last = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- SmartConf actuation -------------------------------------------------
    def set_depth(self, depth: int) -> None:
        """Adjust the prefetch bound at runtime.  Shrinking does not drop
        already-buffered batches (temporary deputy>conf inconsistency is
        tolerated, exactly the paper's §4.2 guidance)."""
        self._depth = max(1, int(depth))

    @property
    def depth(self) -> int:
        return self._depth

    def buffered(self) -> int:
        return self.gauge.items

    def buffered_bytes(self) -> int:
        return self.gauge.nbytes

    # -- producer ------------------------------------------------------------
    def _producer(self) -> None:
        while not self._stop.is_set():
            if self.gauge.items >= self._depth:
                time.sleep(0.001)
                continue
            t0 = time.monotonic()
            if self.delay_fn is not None:
                time.sleep(self.delay_fn())
            batch = self.source.next_batch()
            took = time.monotonic() - t0
            if (self.produce_deadline_s is not None
                    and took > self.produce_deadline_s
                    and self._last is not None):
                # straggling shard: ship the backup batch instead
                batch = self._last
                self.backup_batches += 1
            self._last = batch
            nbytes = sum(a.nbytes for a in batch.values())
            self.gauge.add(nbytes)
            if self.accountant is not None:
                self.accountant.charge("prefetch", nbytes)
            self._queue.put(batch)

    def get(self, timeout: float = 30.0) -> dict:
        batch = self._queue.get(timeout=timeout)
        nbytes = sum(a.nbytes for a in batch.values())
        self.gauge.remove(nbytes)
        if self.accountant is not None:
            self.accountant.credit("prefetch", nbytes)
        return batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
