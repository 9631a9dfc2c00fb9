"""Fault-tolerance runtime: heartbeats, straggler detection, preemption
checkpointing: a copy of ``src/repro/distributed/fault_tolerance.py``.

The failure model: (a) node loss, detected by missed heartbeats
(:class:`HeartbeatMonitor`), then a restart from the latest atomic
checkpoint on a possibly smaller mesh (the checkpoints are elastic:
``checkpoint.restore(..., placement=)``); (b) slow nodes, detected by
step-time outliers (:class:`StragglerDetector`); (c) a preemption signal
(:class:`PreemptionHandler`): SIGTERM sets a flag, the training loop
writes a checkpoint and stops, the serve engine drains (requeues its
in-flight requests and refuses new ones until the flag clears).
"""

from __future__ import annotations

import signal
import threading
import time

__all__ = ["HeartbeatMonitor", "StragglerDetector", "PreemptionHandler"]


class HeartbeatMonitor:
    """Tracks per-worker liveness; a worker is dead after ``timeout_s``
    without a beat.  ``on_failure(worker)`` fires once per transition."""

    def __init__(self, workers, *, timeout_s: float = 10.0,
                 on_failure=None, clock=time.monotonic) -> None:
        self._clock = clock
        self.timeout_s = timeout_s
        self.on_failure = on_failure
        self._last = {w: clock() for w in workers}
        self._dead: set = set()
        self._lock = threading.Lock()

    def beat(self, worker) -> None:
        with self._lock:
            self._last[worker] = self._clock()
            if worker in self._dead:
                self._dead.discard(worker)   # node rejoined (elastic up)

    def check(self) -> list:
        """Returns newly-dead workers."""
        now = self._clock()
        newly = []
        with self._lock:
            for w, t in self._last.items():
                if w not in self._dead and now - t > self.timeout_s:
                    self._dead.add(w)
                    newly.append(w)
        for w in newly:
            if self.on_failure:
                self.on_failure(w)
        return newly

    @property
    def alive(self) -> list:
        with self._lock:
            return [w for w in self._last if w not in self._dead]


class StragglerDetector:
    """Flags workers whose step time exceeds ``factor`` x the fleet
    median."""

    def __init__(self, *, factor: float = 2.0, window: int = 16) -> None:
        self.factor = factor
        self.window = window
        self._times: dict = {}

    def record(self, worker, seconds: float) -> None:
        buf = self._times.setdefault(worker, [])
        buf.append(seconds)
        if len(buf) > self.window:
            buf.pop(0)

    def stragglers(self) -> list:
        if not self._times:
            return []
        meds = {w: sorted(v)[len(v) // 2] for w, v in self._times.items()
                if v}
        fleet = sorted(meds.values())[len(meds) // 2]
        return [w for w, m in meds.items() if m > self.factor * fleet]


class PreemptionHandler:
    """SIGTERM -> set flag; the training loop checkpoints and exits cleanly,
    the serve engine drains.
    ``install()`` is idempotent; in tests, call :meth:`trigger` directly."""

    def __init__(self) -> None:
        self._flag = threading.Event()
        self._installed = False

    def install(self) -> None:
        if self._installed:
            return
        try:
            signal.signal(signal.SIGTERM, lambda *_: self._flag.set())
            self._installed = True
        except ValueError:
            pass  # non-main thread (tests)

    def trigger(self) -> None:
        self._flag.set()

    def reset(self) -> None:
        """Clear the flag after the preemption was handled."""
        self._flag.clear()

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()
