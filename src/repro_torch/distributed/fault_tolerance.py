"""Preemption handling for the trainer: SIGTERM sets a flag, the training
loop writes a checkpoint and stops.  A copy of ``PreemptionHandler`` from
``src/repro/distributed/fault_tolerance.py``; its heartbeat monitor and
straggler detector wait for ROADMAP Queue 1 item 11."""

from __future__ import annotations

import signal
import threading

__all__ = ["PreemptionHandler"]


class PreemptionHandler:
    """SIGTERM -> set flag; the training loop checkpoints and exits cleanly.
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
