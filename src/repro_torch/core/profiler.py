"""Profiling support (paper §5.5).

While profiling is enabled, every ``SmartConf.set_perf`` call records the
(configuration-or-deputy value, measured performance) pair into a buffer that
is periodically flushed to ``<ConfName>.smartconf.sys``.  When profiling is
complete, :func:`synthesize` groups the samples by configuration value, fits
the Eq.-1 model, and writes the synthesized controller parameters (alpha,
Delta, lambda) back into the same system file, from which the ``SmartConf``
constructor initializes its controller.

The larger the range of profiled workloads, the more robust the resulting
controller (paper: "enough samples are needed for the central limit theorem
to apply") — :func:`synthesize` refuses to fit from fewer than
``min_samples_per_point`` observations per sampled configuration value.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
from typing import Iterable, Mapping

from .controller import ControllerModel, fit_model

__all__ = ["ProfileBuffer", "synthesize", "read_sysfile", "write_sysfile"]

_SCHEMA = 1


def _sysfile_path(sys_dir: str, conf_name: str) -> str:
    return os.path.join(sys_dir, f"{conf_name}.smartconf.sys")


def read_sysfile(sys_dir: str, conf_name: str) -> dict:
    path = _sysfile_path(sys_dir, conf_name)
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def write_sysfile(sys_dir: str, conf_name: str, payload: Mapping) -> str:
    """Atomic write (the trainer may be checkpointing concurrently).

    Exception-safe on every path: if ``os.fdopen`` raises, the raw fd is
    closed directly (an fd wrapped by a failed fdopen is otherwise
    leaked); if serialization or ``os.replace`` fails, the tmp file is
    unlinked without a TOCTOU exists-check (``os.replace`` may have
    already consumed it — a racing second writer could re-create the
    name between ``exists`` and ``unlink``)."""
    os.makedirs(sys_dir, exist_ok=True)
    path = _sysfile_path(sys_dir, conf_name)
    payload = dict(payload)
    payload["schema"] = _SCHEMA
    fd, tmp = tempfile.mkstemp(dir=sys_dir, prefix=f".{conf_name}.")
    try:
        fh = os.fdopen(fd, "w", encoding="utf-8")
    except Exception:
        os.close(fd)
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    try:
        with fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    return path


class ProfileBuffer:
    """In-memory (conf value, perf) sample buffer with periodic flush.

    When a ``core.telemetry.MetricsRegistry`` is attached (``metrics=``),
    every flush also emits into it — ``profiler.<conf>.samples`` counts
    samples persisted, ``profiler.<conf>.flushes`` counts write-outs — so
    a profiling run's progress is visible in the same metrics.json as the
    serving telemetry."""

    def __init__(self, sys_dir: str, conf_name: str, flush_every: int = 64,
                 metrics=None) -> None:
        self.sys_dir = sys_dir
        self.conf_name = conf_name
        self.flush_every = flush_every
        self.metrics = metrics
        self._samples: list[tuple[float, float]] = []
        self._flushed: list[tuple[float, float]] = []
        existing = read_sysfile(sys_dir, conf_name)
        if "profile_samples" in existing:
            self._flushed = [tuple(x) for x in existing["profile_samples"]]

    def record(self, conf_value: float, perf: float) -> None:
        self._samples.append((float(conf_value), float(perf)))
        if len(self._samples) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if not self._samples:
            return
        n = len(self._samples)
        self._flushed.extend(self._samples)
        self._samples.clear()
        payload = read_sysfile(self.sys_dir, self.conf_name)
        payload["profile_samples"] = [list(x) for x in self._flushed]
        write_sysfile(self.sys_dir, self.conf_name, payload)
        if self.metrics is not None:
            self.metrics.counter(f"profiler.{self.conf_name}.samples").inc(n)
            self.metrics.counter(f"profiler.{self.conf_name}.flushes").inc()

    @property
    def samples(self) -> list[tuple[float, float]]:
        return self._flushed + self._samples


def synthesize(
    sys_dir: str,
    conf_name: str,
    *,
    samples: Iterable[tuple[float, float]] | None = None,
    conf_min: float = 0.0,
    conf_max: float = float("inf"),
    integer: bool = True,
    min_samples_per_point: int = 2,
) -> ControllerModel:
    """Group profiled samples by configuration value, fit Eq. 1, persist."""
    if samples is None:
        payload = read_sysfile(sys_dir, conf_name)
        samples = [tuple(x) for x in payload.get("profile_samples", [])]
    samples = list(samples)
    if not samples:
        raise ValueError(f"no profiling samples for {conf_name!r}")
    grouped: dict[float, list[float]] = collections.defaultdict(list)
    for conf_value, perf in samples:
        grouped[float(conf_value)].append(float(perf))
    # Indirect configs profile against a *continuous* deputy (queue occupancy,
    # memtable bytes ...): bin into at most 16 operating points so the
    # per-point sigma/mean statistics behind Delta and lambda are meaningful.
    if len(grouped) > 24:
        lo = min(grouped)
        hi = max(grouped)
        width = (hi - lo) / 16 or 1.0
        binned: dict[float, list[float]] = collections.defaultdict(list)
        for conf_value, values in grouped.items():
            center = lo + (int((conf_value - lo) / width) + 0.5) * width
            binned[center].extend(values)
        grouped = binned
    points = {c: v for c, v in grouped.items() if len(v) >= min_samples_per_point}
    if not points:
        # Fall back to whatever we have rather than refusing outright; the
        # pole/virtual-goal machinery absorbs the extra uncertainty.
        points = grouped
    conf_values = sorted(points)
    model = fit_model(
        conf_values,
        [points[c] for c in conf_values],
        conf_min=conf_min,
        conf_max=conf_max,
        integer=integer,
    )
    payload = read_sysfile(sys_dir, conf_name)
    payload["model"] = json.loads(model.to_json())
    payload["profile_samples"] = [list(x) for x in samples]
    write_sysfile(sys_dir, conf_name, payload)
    return model
