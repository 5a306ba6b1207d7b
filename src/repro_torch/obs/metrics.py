"""Minimal counter/gauge registry (the port's slice of ``repro.obs.metrics``).

Counters are plain host integers: kernel wrappers bump
``kernel.<name>.launches`` where they launch their CUDA kernel, the
device cluster pass bumps ``laf.cluster.host_syncs`` at its one
device-to-host copy, and the sweeps bump ``sweep.host_syncs``.  Gauges
hold the last value set (phase times of the last clustering).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

__all__ = ["counter", "gauge", "reset", "snapshot", "PhaseClock"]


class Counter:
    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, k: int = 1) -> None:
        self.value += int(k)


class Gauge:
    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


_COUNTERS: Dict[str, Counter] = {}
_GAUGES: Dict[str, Gauge] = {}


def counter(name: str) -> Counter:
    c = _COUNTERS.get(name)
    if c is None:
        c = _COUNTERS[name] = Counter(name)
    return c


def gauge(name: str) -> Gauge:
    g = _GAUGES.get(name)
    if g is None:
        g = _GAUGES[name] = Gauge(name)
    return g


def reset(prefix: str = "") -> None:
    """Set every counter whose name starts with ``prefix`` to 0 and
    clear every such gauge."""
    for name, c in _COUNTERS.items():
        if name.startswith(prefix):
            c.value = 0
    for name, g in _GAUGES.items():
        if name.startswith(prefix):
            g.value = None


def snapshot() -> dict:
    return {
        "counters": {k: c.value for k, c in sorted(_COUNTERS.items())},
        "gauges": {k: g.value for k, g in sorted(_GAUGES.items())},
    }


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
