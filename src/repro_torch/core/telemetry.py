"""Flight recorder for the control loop: metrics, traces, decision audit.

A copy of the reference's ``core/telemetry.py`` (pure Python, no device
code), kept in the port so that it imports nothing of the JAX package.

Zero-dependency observability for the SmartConf serving stack.  Four
cooperating pieces, bundled behind one :class:`Telemetry` hub:

- :class:`MetricsRegistry` — counters, gauges, and fixed-bucket
  histograms with p50/p90/p99 readout.  Histograms bucket at record
  time, so readout is O(buckets) and the registry never holds raw
  samples.
- :class:`Tracer` — span tracer emitting Chrome trace-event JSON
  (``trace.json``), loadable in Perfetto / ``chrome://tracing``.  The
  serve engine stamps one span per tick with nested phase spans
  (control → admit → schedule → pack → dispatch → sample → finish),
  chaos events and preemptions as instant markers, and request
  lifetimes as async begin/end pairs.
- :class:`FlightRecorder` — bounded ring of the last N ticks of raw
  sensor readings (pre- and post-``sensor_tap``), dumped automatically
  on guardrail faults, rejection storms, or chaos triggers.
- :class:`DecisionLog` — structured :class:`Decision` record per
  controller actuation: sensor value in, guardrail verdict, error
  term, raw vs. slew-clamped output, fallback-engaged flag.  Queryable,
  so tests assert "the NaN window engaged last-known-good on tick 41"
  instead of grepping stdout.

Design constraints, both load-bearing:

- **Off by default, free when off.**  Consumers hold ``None`` instead
  of a disabled hub (see ``ServeEngine.__init__``), so the disabled
  path is the pre-telemetry code path: no allocation, no virtual
  dispatch.  Telemetry never switches a path: with it on, the engine
  runs the same kernels on the same inputs.
- **Deterministic under ``VirtualClock``.**  Timestamps come from the
  injected clock, dict key order is insertion order, and JSON encoding
  sanitizes non-finite floats — same seed + same trace means
  byte-identical ``audit.jsonl`` and span ordering.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Callable, Iterable

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Tracer", "FlightRecorder", "Decision", "DecisionLog", "Telemetry",
    "DEFAULT_LATENCY_BUCKETS",
]

# Latency buckets in seconds: 100us .. ~100s, roughly x2 per step.  Wide
# enough for virtual-time tick costs (0.02-0.2s) and real wall ticks.
DEFAULT_LATENCY_BUCKETS: tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
)


def _finite(v: Any) -> Any:
    """JSON-safe scalar: strict JSON has no NaN/Infinity literals."""
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)  # "nan", "inf", "-inf"
    return v


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram with quantile readout.

    Values are bucketed at record time against sorted upper-bound
    ``buckets`` (plus an implicit +inf overflow bucket).  Quantiles are
    read back as the upper bound of the bucket holding that rank —
    coarse but allocation-free and deterministic.
    """

    __slots__ = ("name", "buckets", "counts", "count", "total", "_min", "_max")

    def __init__(self, name: str,
                 buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.buckets) + 1)  # +1: overflow
        self.count = 0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf

    def record(self, v: float) -> None:
        if not math.isfinite(v):
            return  # chaos can corrupt sensor values; never poison stats
        # linear scan: bucket lists are ~20 long and most latencies land
        # in the first third, beating bisect's constant factor here
        i = 0
        bs = self.buckets
        n = len(bs)
        while i < n and v > bs[i]:
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.total += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket containing rank q*count (0 if empty)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return self.buckets[i] if i < len(self.buckets) else self._max
        return self._max

    def p50(self) -> float:
        return self.quantile(0.50)

    def p90(self) -> float:
        return self.quantile(0.90)

    def p99(self) -> float:
        return self.quantile(0.99)

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict[str, Any]:
        return {
            "count": self.count,
            "mean": self.mean(),
            "min": self._min if self.count else 0.0,
            "max": self._max if self.count else 0.0,
            "p50": self.p50(),
            "p90": self.p90(),
            "p99": self.p99(),
            "buckets": list(self.buckets),
            "counts": list(self.counts),
        }


class MetricsRegistry:
    """Named counters/gauges/histograms; get-or-create by name."""

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
                  ) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, buckets)
        return h

    def snapshot(self) -> dict[str, Any]:
        return {
            "counters": {n: c.value for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.snapshot()
                           for n, h in sorted(self._histograms.items())},
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=False)
            f.write("\n")


class Tracer:
    """Chrome trace-event tracer; timestamps from an injected clock.

    Events follow the trace-event format's required fields
    (``name/ph/ts/pid/tid``, ``dur`` for complete events): ``ph="X"``
    complete spans, ``ph="i"`` instants, ``ph="b"/"e"`` async pairs for
    request lifetimes.  ``ts`` is microseconds; with a ``VirtualClock``
    the timeline is virtual time and fully deterministic.

    Track (tid) convention: 0 = engine ticks, 1 = driver/arrivals,
    2 = chaos.  The ring is bounded by ``max_events``; overflow is
    counted, never silently resized.
    """

    PID = 1
    TID_ENGINE = 0
    TID_DRIVER = 1
    TID_CHAOS = 2

    def __init__(self, clock: Callable[[], float] | None = None,
                 max_events: int = 200_000):
        self._now = clock if clock is not None else time.monotonic
        self.max_events = max_events
        self.events: list[dict[str, Any]] = []
        self.dropped = 0
        for tid, label in ((self.TID_ENGINE, "engine"),
                           (self.TID_DRIVER, "driver"),
                           (self.TID_CHAOS, "chaos")):
            self.events.append({
                "name": "thread_name", "ph": "M", "pid": self.PID,
                "tid": tid, "args": {"name": label}})

    def now_us(self) -> int:
        return int(self._now() * 1e6)

    def _emit(self, ev: dict[str, Any]) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def complete(self, name: str, ts_us: int, dur_us: int, *,
                 tid: int = TID_ENGINE,
                 args: dict[str, Any] | None = None) -> None:
        ev: dict[str, Any] = {"name": name, "ph": "X", "ts": ts_us,
                              "dur": dur_us, "pid": self.PID, "tid": tid}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, *, tid: int = TID_ENGINE,
                ts_us: int | None = None,
                args: dict[str, Any] | None = None) -> None:
        ev: dict[str, Any] = {
            "name": name, "ph": "i",
            "ts": self.now_us() if ts_us is None else ts_us,
            "pid": self.PID, "tid": tid, "s": "t"}
        if args:
            ev["args"] = args
        self._emit(ev)

    def async_begin(self, name: str, event_id: int, *,
                    cat: str = "request", tid: int = TID_DRIVER,
                    args: dict[str, Any] | None = None) -> None:
        ev: dict[str, Any] = {"name": name, "ph": "b", "cat": cat,
                              "id": event_id, "ts": self.now_us(),
                              "pid": self.PID, "tid": tid}
        if args:
            ev["args"] = args
        self._emit(ev)

    def async_end(self, name: str, event_id: int, *,
                  cat: str = "request", tid: int = TID_DRIVER,
                  args: dict[str, Any] | None = None) -> None:
        ev: dict[str, Any] = {"name": name, "ph": "e", "cat": cat,
                              "id": event_id, "ts": self.now_us(),
                              "pid": self.PID, "tid": tid}
        if args:
            ev["args"] = args
        self._emit(ev)

    # --- tick-structured spans -------------------------------------------
    # The engine brackets each tick with begin_tick()/end_tick() and calls
    # phase() at each internal stage boundary.  Under a frozen-per-tick
    # VirtualClock every phase would collapse to zero duration, so phases
    # are synthesized as equal slices of the tick span: the *ordering*
    # admit -> pack -> dispatch -> ... is the ground truth being traced,
    # not wall sub-timings.

    def begin_tick(self, tick: int) -> None:
        self._tick_no = tick
        self._tick_ts = self.now_us()
        self._phases: list[str] = []

    def phase(self, name: str) -> None:
        self._phases.append(name)

    def end_tick(self, args: dict[str, Any] | None = None) -> None:
        ts0 = self._tick_ts
        end = self.now_us()
        dur = max(end - ts0, len(self._phases) or 1)
        self.complete(f"tick {self._tick_no}", ts0, dur,
                      tid=self.TID_ENGINE, args=args)
        if self._phases:
            slice_us = dur // len(self._phases)
            rem = dur - slice_us * len(self._phases)
            t = ts0
            for i, name in enumerate(self._phases):
                d = slice_us + (rem if i == len(self._phases) - 1 else 0)
                self.complete(name, t, d, tid=self.TID_ENGINE,
                              args={"tick": self._tick_no})
                t += d

    def to_json(self) -> dict[str, Any]:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=None, separators=(",", ":"))
            f.write("\n")


class FlightRecorder:
    """Ring buffer of the last ``window`` ticks of raw sensor readings.

    ``record()`` every tick with the tick's ``{sensor: (raw, tapped)}``
    map; ``dump(reason)`` snapshots the ring.  Dumps are deduplicated:
    a reason already dumped within the last ``window`` ticks is dropped
    (a 10-tick NaN window should produce one dump, not ten), and the
    dump list itself is bounded by ``max_dumps``.
    """

    def __init__(self, window: int = 64, max_dumps: int = 32):
        self.window = window
        self.max_dumps = max_dumps
        self._ring: list[dict[str, Any]] = []
        self.dumps: list[dict[str, Any]] = []
        self.dropped_dumps = 0
        self._last_dump_tick: dict[str, int] = {}

    def record(self, tick: int, readings: dict[str, Any]) -> None:
        self._ring.append({"tick": tick, **readings})
        if len(self._ring) > self.window:
            del self._ring[0]

    def dump(self, reason: str, tick: int) -> bool:
        """Snapshot the ring; returns True if a dump was taken."""
        last = self._last_dump_tick.get(reason)
        if last is not None and tick - last < self.window:
            return False
        if len(self.dumps) >= self.max_dumps:
            self.dropped_dumps += 1
            return False
        self._last_dump_tick[reason] = tick
        self.dumps.append({"reason": reason, "tick": tick,
                           "ring": [dict(r) for r in self._ring]})
        return True

    def snapshot(self) -> dict[str, Any]:
        def san(d: dict[str, Any]) -> dict[str, Any]:
            return {k: ([_finite(x) for x in v]
                        if isinstance(v, (list, tuple)) else _finite(v))
                    for k, v in d.items()}
        return {
            "window": self.window,
            "dropped_dumps": self.dropped_dumps,
            "dumps": [{"reason": d["reason"], "tick": d["tick"],
                       "ring": [san(r) for r in d["ring"]]}
                      for d in self.dumps],
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
            f.write("\n")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One controller actuation, end to end.

    Captured across a ``set_perf`` (sensor in, guardrail verdict) and
    the ``get_conf`` that actuates on it (error term, raw controller
    output vs. the slew-clamped value actually applied, whether the
    last-known-good fallback is pinned).
    """

    tick: int               # engine tick (DecisionLog.tick at append time)
    conf: str               # PerfConf name, e.g. "serve.admit_tier_max"
    metric: str             # sensor metric name, e.g. "ttft_p99_s"
    goal: float             # controller virtual goal
    sensor: float           # reading offered to set_perf (post-tap)
    deputy: float | None    # deputy metric value (indirect confs), else None
    sane: bool              # guardrail verdict on the reading
    error: float            # goal - last admitted perf
    raw: float              # controller/transducer output before guards
    applied: float          # value actually returned by get_conf
    clamped: bool           # slew clamp engaged this actuation
    fallback: bool          # pinned to last-known-good (sensor failed)

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: _finite(v) for k, v in d.items()}


class DecisionLog:
    """Append-only, queryable audit log of controller Decisions.

    ``tick`` is stamped by the engine at the top of each tick so
    controllers don't need to know engine internals.  Bounded: beyond
    ``max_records`` the oldest records are discarded (counted).
    """

    def __init__(self, max_records: int = 100_000):
        self.max_records = max_records
        self.records: list[Decision] = []
        self.dropped = 0
        self.tick = 0

    def append(self, d: Decision) -> None:
        if len(self.records) >= self.max_records:
            del self.records[0]
            self.dropped += 1
        self.records.append(d)

    def query(self, **eq: Any) -> list[Decision]:
        """Records where every given field equals the given value."""
        out = self.records
        for k, v in eq.items():
            out = [d for d in out if getattr(d, k) == v]
        return list(out)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for d in self.records:
                json.dump(d.to_dict(), f, separators=(",", ":"))
                f.write("\n")


class Telemetry:
    """The hub every instrumented component holds (or ``None``).

    ``enabled=False`` builds a stub whose consumers are expected to
    drop it (the serve engine stores ``None`` in that case) — the
    disabled fast path is the *absence* of telemetry, not a null
    object absorbing calls.
    """

    def __init__(self, enabled: bool = True, *,
                 clock: Callable[[], float] | None = None,
                 flight_window: int = 64,
                 max_trace_events: int = 200_000,
                 max_audit_records: int = 100_000):
        self.enabled = enabled
        self.clock = clock
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(clock=clock, max_events=max_trace_events)
        self.flight = FlightRecorder(window=flight_window)
        self.audit = DecisionLog(max_records=max_audit_records)

    @classmethod
    def disabled(cls) -> "Telemetry":
        return cls(enabled=False)

    def write(self, out_dir: str) -> dict[str, str]:
        """Write trace.json + metrics.json + audit.jsonl + flight.json."""
        os.makedirs(out_dir, exist_ok=True)
        paths = {
            "trace": os.path.join(out_dir, "trace.json"),
            "metrics": os.path.join(out_dir, "metrics.json"),
            "audit": os.path.join(out_dir, "audit.jsonl"),
            "flight": os.path.join(out_dir, "flight.json"),
        }
        self.tracer.write(paths["trace"])
        self.metrics.write(paths["metrics"])
        self.audit.write_jsonl(paths["audit"])
        self.flight.write(paths["flight"])
        return paths
