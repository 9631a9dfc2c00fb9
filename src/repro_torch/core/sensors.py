"""Performance sensors (paper §4.1.1: "developers must provide a sensor").

The framework ships the sensors its own PerfConfs need; applications may add
their own.  All sensors are cheap, thread-safe, and side-effect free so they
can be polled at every control interval.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
from typing import Deque

import torch

__all__ = [
    "HBMAccountant",
    "LatencySensor",
    "QueueGauge",
    "StepTimer",
    "ThroughputSensor",
    "device_live_bytes",
]


def device_live_bytes(device: torch.device | str = "cuda") -> int:
    """Live bytes on ``device``: the caching allocator's
    ``memory_allocated`` on a CUDA device, else the sum of every live CPU
    tensor's storage (one count per storage, so views are not counted
    twice).  This is the deployment-grade sensor behind ``hbm_bytes``."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.memory_allocated(device))
    seen: dict[int, int] = {}
    for obj in gc.get_objects():
        if isinstance(obj, torch.Tensor) and obj.device.type == "cpu":
            st = obj.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


class HBMAccountant:
    """Named byte-ledger for device memory (weights, optimizer, KV blocks,
    activations, queued requests).  The serve engine charges/credits it as it
    admits requests and allocates KV blocks; the SmartConf ``hbm_bytes``
    controllers read :meth:`total`.

    On the card :func:`device_live_bytes` cross-checks the ledger; on the
    CPU host the ledger *is* the measurement."""

    def __init__(self, budget_bytes: int | None = None) -> None:
        self._ledger: dict[str, int] = {}
        self._lock = threading.Lock()
        self.budget_bytes = budget_bytes
        self.peak_bytes = 0
        self.violations = 0

    def charge(self, name: str, nbytes: int) -> None:
        with self._lock:
            self._ledger[name] = self._ledger.get(name, 0) + int(nbytes)
            tot = sum(self._ledger.values())
            self.peak_bytes = max(self.peak_bytes, tot)
            if self.budget_bytes is not None and tot > self.budget_bytes:
                self.violations += 1

    def credit(self, name: str, nbytes: int) -> None:
        self.charge(name, -int(nbytes))

    def set(self, name: str, nbytes: int) -> None:
        with self._lock:
            self._ledger[name] = int(nbytes)
            tot = sum(self._ledger.values())
            self.peak_bytes = max(self.peak_bytes, tot)
            if self.budget_bytes is not None and tot > self.budget_bytes:
                self.violations += 1

    def total(self) -> int:
        with self._lock:
            return sum(self._ledger.values())

    def breakdown(self) -> dict[str, int]:
        with self._lock:
            return dict(self._ledger)

    def headroom(self) -> int | None:
        if self.budget_bytes is None:
            return None
        return self.budget_bytes - self.total()


class LatencySensor:
    """Sliding-window latency sensor with mean / p50 / p99.

    ``clock`` is injectable (like :class:`ThroughputSensor`) so latency
    tests drive a fake clock deterministically instead of sleeping; it is
    consulted by :meth:`measure`, the span-timing helper."""

    def __init__(self, window: int = 512, clock=time.monotonic) -> None:
        self._buf: Deque[float] = collections.deque(maxlen=window)
        self._clock = clock
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._buf.append(float(seconds))

    @contextlib.contextmanager
    def measure(self):
        """Context manager recording the span's duration via the clock."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.record(self._clock() - t0)

    def _snapshot(self) -> list[float]:
        with self._lock:
            return sorted(self._buf)

    def count(self) -> int:
        """Samples currently retained in the window."""
        with self._lock:
            return len(self._buf)

    def mean(self) -> float:
        xs = self._snapshot()
        return sum(xs) / len(xs) if xs else 0.0

    def quantile(self, q: float) -> float:
        xs = self._snapshot()
        if not xs:
            return 0.0
        idx = min(int(q * len(xs)), len(xs) - 1)
        return xs[idx]

    def p99(self) -> float:
        return self.quantile(0.99)

    def max(self) -> float:
        xs = self._snapshot()
        return xs[-1] if xs else 0.0


class ThroughputSensor:
    """Events/sec over a sliding time window."""

    def __init__(self, window_seconds: float = 10.0, clock=time.monotonic) -> None:
        self._events: Deque[tuple[float, int]] = collections.deque()
        self.window_seconds = window_seconds
        self._clock = clock
        self._lock = threading.Lock()
        self.total = 0

    def record(self, n: int = 1) -> None:
        now = self._clock()
        with self._lock:
            self._events.append((now, n))
            self.total += n
            self._trim(now)

    def _trim(self, now: float) -> None:
        while self._events and self._events[0][0] < now - self.window_seconds:
            self._events.popleft()

    def rate(self) -> float:
        """Events/sec over the retained window.

        Dividing by the full ``window_seconds`` before the window has
        filled under-reports the rate (bench warm-up, short smoke runs):
        the honest denominator is the elapsed time since the first
        *retained* event, clamped to the window.  A window whose events
        all share one instant has no measurable span; fall back to the
        full window (the conservative old behavior) instead of dividing
        by zero."""
        now = self._clock()
        with self._lock:
            self._trim(now)
            if not self._events:
                return 0.0
            n = sum(c for _, c in self._events)
            span = now - self._events[0][0]
        span = min(self.window_seconds, span)
        if span <= 0.0:
            span = self.window_seconds
        return n / span


class QueueGauge:
    """Instantaneous occupancy gauge for a queue (items and bytes) — the
    deputy-variable sensor for indirect PerfConfs (paper §5.3)."""

    def __init__(self) -> None:
        self.items = 0
        self.nbytes = 0
        self._lock = threading.Lock()

    def add(self, nbytes: int = 0) -> None:
        with self._lock:
            self.items += 1
            self.nbytes += int(nbytes)

    def remove(self, nbytes: int = 0) -> None:
        with self._lock:
            self.items -= 1
            self.nbytes -= int(nbytes)


class StepTimer:
    """Per-step wall-clock timer for the trainer (drives the checkpoint
    overhead controller).  It times what runs inside the ``with`` block;
    the trainer ends that block only once the step is complete on the
    device.  On a mesh ``clock`` is the agreed clock, so every rank
    reads the same step times."""

    def __init__(self, window: int = 128, clock=time.monotonic) -> None:
        self.latency = LatencySensor(window)
        self.clock = clock
        self._start: float | None = None

    def __enter__(self) -> "StepTimer":
        self._start = self.clock()
        return self

    def __exit__(self, *exc) -> None:
        if self._start is not None:
            self.latency.record(self.clock() - self._start)
            self._start = None

    def mean(self) -> float:
        return self.latency.mean()
