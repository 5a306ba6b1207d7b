"""Process-global metrics registry: counters, gauges, log-bucketed
histograms (port of ``repro.obs.metrics``).

* **Counter** — monotonic (kernel launches ``kernel.<name>.launches``,
  host syncs ``laf.cluster.host_syncs`` / ``sweep.host_syncs``, sweeps).
  ``inc()`` while metrics are disabled is one attribute load + one
  branch, so instrumentation stays inline in hot loops.
* **Gauge** — last-write-wins scalar (phase times, band fractions).
* **Histogram** — fixed log-spaced buckets (20 per decade: ~12%
  resolution) covering 1 µs .. 100 s.  Quantiles come from the
  cumulative bucket counts with geometric interpolation inside the
  landing bucket, so p50/p95/p99 are exact up to one bucket's width;
  min/max/sum are exact.  Recording is O(1) and stores no samples.

``snapshot()`` returns a plain ``{name: value}`` dict (histograms
expand to count/sum/min/max/p50/p95/p99); ``to_json()`` is its
serialized form.

A fresh registry starts **disabled**, as the reference's does:
instruments exist and are callable but record nothing until
:func:`enable` (or ``repro_torch.obs.enable`` / ``REPRO_OBS``).

:class:`PhaseClock` times an engine's phases on the device's own clock
and publishes them to ``<prefix>.<phase>_s`` gauges.
"""

from __future__ import annotations

import json
import math
import threading
import time
from bisect import bisect_right
from typing import Dict, Optional, Tuple

import torch

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "counter",
    "gauge",
    "histogram",
    "enable",
    "disable",
    "enabled",
    "snapshot",
    "to_json",
    "reset",
    "PhaseClock",
]

_lock = threading.Lock()
_instruments: Dict[str, object] = {}


class _State:
    on: bool = False


_state = _State()


class Counter:
    """Monotonic counter; ``inc`` is a no-op while metrics are off."""

    __slots__ = ("name", "help", "_v", "_lk")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._v = 0
        self._lk = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if not _state.on:
            return
        with self._lk:
            self._v += int(n)

    @property
    def value(self) -> int:
        return self._v

    def _reset(self) -> None:
        self._v = 0


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "help", "_v", "_set")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._v = 0.0
        self._set = False

    def set(self, v: float) -> None:
        if not _state.on:
            return
        self._v = float(v)
        self._set = True

    @property
    def value(self) -> float:
        return self._v

    def _reset(self) -> None:
        self._v, self._set = 0.0, False


def default_buckets(
    lo: float = 1e-6, hi: float = 100.0, per_decade: int = 20
) -> Tuple[float, ...]:
    """Log-spaced bucket upper bounds, ``per_decade`` per decade of
    [lo, hi] — at 20/decade adjacent bounds differ by ~12%, which is
    the histogram's quantile resolution."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * (hi / lo) ** (i / n) for i in range(n + 1))


class Histogram:
    """Fixed log-bucket histogram with interpolated quantiles.

    Values at or below the first bound (including the exact zeros a
    sub-resolution duration measures to) are clamped to the first bound
    and land in bucket 0, so they never drag the geometric interpolation
    below anything observed.  Values above the last bound land in the
    overflow bucket.  ``quantile`` interpolates geometrically inside the
    landing bucket, so against exact percentiles the error is bounded by
    one bucket ratio (~12% at the default layout).
    """

    __slots__ = ("name", "help", "bounds", "_counts", "_n", "_sum", "_min", "_max", "_lk")

    def __init__(self, name: str, help: str = "", bounds: Optional[Tuple[float, ...]] = None):
        self.name, self.help = name, help
        self.bounds: Tuple[float, ...] = tuple(bounds) if bounds else default_buckets()
        self._counts = [0] * (len(self.bounds) + 1)
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lk = threading.Lock()

    def observe(self, v: float) -> None:
        if not _state.on:
            return
        v = float(v)
        if v <= self.bounds[0]:
            v = self.bounds[0]
            i = 0
        else:
            i = bisect_right(self.bounds, v)
        with self._lk:
            self._counts[i] += 1
            self._n += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """q in [0, 1]; 0 with no observations."""
        if self._n == 0:
            return 0.0
        if q <= 0:
            return self._min
        if q >= 1:
            return self._max
        target = q * self._n
        acc = 0
        for i, c in enumerate(self._counts):
            if acc + c >= target:
                lo = self.bounds[i - 1] if i > 0 else min(self._min, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else self._max
                lo = max(lo, 1e-12)
                hi = max(hi, lo)
                frac = (target - acc) / c
                val = lo * (hi / lo) ** frac  # geometric inside the log bucket
                return float(min(max(val, self._min), self._max))
            acc += c
        return self._max

    def _reset(self) -> None:
        self._counts = [0] * (len(self.bounds) + 1)
        self._n, self._sum = 0, 0.0
        self._min, self._max = math.inf, -math.inf

    def summary(self) -> Dict[str, float]:
        if self._n == 0:
            return {"count": 0}
        return {
            "count": self._n,
            "sum": self._sum,
            "min": self._min,
            "max": self._max,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


def _get(name: str, cls, **kw):
    with _lock:
        inst = _instruments.get(name)
        if inst is None:
            inst = _instruments[name] = cls(name, **kw)
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as {type(inst).__name__}")
        return inst


def counter(name: str, help: str = "") -> Counter:
    """Get-or-create the named monotonic counter."""
    return _get(name, Counter, help=help)


def gauge(name: str, help: str = "") -> Gauge:
    return _get(name, Gauge, help=help)


def histogram(name: str, help: str = "", bounds=None) -> Histogram:
    return _get(name, Histogram, help=help, bounds=bounds)


def enable() -> None:
    _state.on = True


def disable() -> None:
    _state.on = False


def enabled() -> bool:
    return _state.on


def reset() -> None:
    """Zero every instrument (registrations are kept)."""
    with _lock:
        for inst in _instruments.values():
            inst._reset()


def snapshot(prefix: str = "") -> Dict[str, object]:
    """Plain-dict view of every instrument (histograms expand to their
    summary, unset gauges are left out), optionally filtered to names
    starting with ``prefix``."""
    with _lock:
        items = sorted(_instruments.items())
    out: Dict[str, object] = {}
    for name, inst in items:
        if prefix and not name.startswith(prefix):
            continue
        if isinstance(inst, Histogram):
            out[name] = inst.summary()
        elif isinstance(inst, Gauge):
            if inst._set:
                out[name] = inst.value
        else:
            out[name] = inst.value
    return out


def to_json(prefix: str = "", indent: int = 2) -> str:
    return json.dumps(snapshot(prefix), indent=indent, default=float)


class PhaseClock:
    """Phase boundaries on the device's own clock, read without a sync.

    On CUDA each ``mark`` records an event on the current stream, so
    timing a phase adds no host sync; ``publish`` reads the intervals
    after the caller's own final sync (it waits on the last event only,
    which has completed by then) and writes them to the
    ``<prefix>.<phase>_s`` gauges.  On the CPU the marks are host clock
    readings.
    """

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    @classmethod
    def for_engine(cls, backend, device) -> "PhaseClock":
        """A started clock on the device an engine runs on: a constructed
        backend's own, else ``device`` (``None`` = cuda, raising without
        a card, as the backend built from it would)."""
        from .. import resolve_device

        dev = getattr(backend, "device", None)
        clock = cls(dev if isinstance(dev, torch.device) else resolve_device(device))
        clock.mark("start")
        return clock

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def publish(self, prefix: str) -> Dict[str, float]:
        out = {}
        if self.cuda and self.marks:
            self.marks[-1][1].synchronize()
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            s = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            out[name] = s
            gauge(f"{prefix}.{name}_s").set(s)
        return out
