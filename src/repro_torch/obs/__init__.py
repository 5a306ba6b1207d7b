"""``repro_torch.obs`` — observability for the port (port of
``repro.obs``): tracing spans, a metrics registry, device-resident
telemetry, SLO rules and structured logging.

Everything is off by default and costs one branch per instrumented
site.  Turn it on explicitly::

    from repro_torch import obs
    obs.enable()                                  # trace + metrics
    obs.enable(trace=True, metrics_on=True, telemetry=True)   # + device counters
    ... run ...
    obs.export_chrome_trace("laf_trace.json")     # open in Perfetto
    print(obs.metrics.to_json())

or through the environment: ``REPRO_OBS=1`` enables trace and metrics
at import time, ``trace`` / ``metrics`` one of them, ``device`` both
plus the device telemetry.

Recompile accounting (the counterpart of the reference's
``RecompileWatcher``, ``watch_recompiles`` and ``PAIRED_COUNTERS``): an
eager PyTorch program has no executable cache, so a watcher counts the
new operand signatures (shapes and dtypes) a watched launch function
sees, a bounded set per database capacity; the sweep engine's launches
feed ``sweep.recompiles``, which pairs 1:1 with
``index.capacity_doublings``.  Kernel builds are counted where they
happen, ``kernel.builds`` once per source hash
(``repro_torch.kernels._build``).  The reference's ``jax.monitoring``
listener has no counterpart.

``loop_scope(name)`` marks the host loops that enqueue device work (the
sweep's launches, the sharded fixpoint's rounds) so a dispatch trace
(``repro_torch.launch.trace_analysis``) can tell an op inside a loop
from one outside it; it records nothing itself.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Hashable, Optional, Tuple

from . import device as device_telemetry
from . import metrics, slo
from .device import device_enabled, disable_device, enable_device
from .log import configure as configure_logging
from .log import get_logger, log_event, rate_limited_warn
from .trace import SpanRecord, coverage, export_chrome_trace, span, spans
from .trace import _state as _trace_state
from .trace import clear as clear_trace

__all__ = [
    "enable",
    "disable",
    "trace_enabled",
    "metrics_enabled",
    "enable_from_env",
    "device_telemetry",
    "device_enabled",
    "enable_device",
    "disable_device",
    "span",
    "spans",
    "clear_trace",
    "coverage",
    "export_chrome_trace",
    "SpanRecord",
    "metrics",
    "slo",
    "get_logger",
    "log_event",
    "rate_limited_warn",
    "configure_logging",
    "RecompileWatcher",
    "watch_recompiles",
    "PAIRED_COUNTERS",
    "loop_scope",
    "current_loops",
]


def enable(
    trace: bool = True,
    metrics_on: Optional[bool] = None,
    *,
    profiler_annotations: bool = False,
    telemetry: Optional[bool] = None,
) -> None:
    """Turn observability on.

    ``trace`` — record spans and allow Chrome/Perfetto export;
    ``metrics_on`` (default True) — counters, gauges and histograms
    record; ``profiler_annotations`` — also wrap every span in
    ``torch.profiler.record_function`` so span names land inside
    ``torch.profiler`` captures; ``telemetry`` — the in-launch device
    counters (per-round cluster vectors, per-chunk sweep occupancy),
    read with each pass's existing host copy.  ``telemetry=None`` leaves
    the device switch as it is.
    """
    if metrics_on is None:
        metrics_on = True
    _trace_state.trace = bool(trace)
    _trace_state.profiler_annotations = bool(profiler_annotations)
    (metrics.enable if metrics_on else metrics.disable)()
    if telemetry is not None:
        (enable_device if telemetry else disable_device)()


def disable() -> None:
    _trace_state.trace = False
    _trace_state.profiler_annotations = False
    metrics.disable()
    disable_device()


def trace_enabled() -> bool:
    return _trace_state.trace


def metrics_enabled() -> bool:
    return metrics.enabled()


def enable_from_env(environ=None) -> bool:
    """Apply the ``REPRO_OBS`` knob; returns whether anything enabled.

    ``1``/``true``/``both`` — trace + metrics; ``trace`` / ``metrics`` —
    just that half; ``device`` — trace + metrics + device telemetry;
    unset/``0`` — leave everything off.
    """
    val = (environ if environ is not None else os.environ).get("REPRO_OBS", "")
    val = val.strip().lower()
    if val in ("1", "true", "yes", "on", "both", "all"):
        enable(trace=True, metrics_on=True)
    elif val == "trace":
        enable(trace=True, metrics_on=False)
    elif val == "metrics":
        enable(trace=False, metrics_on=True)
    elif val == "device":
        enable(trace=True, metrics_on=True, telemetry=True)
    else:
        return False
    return True


# counters that move in lockstep over a steady-query-shape workload:
# each new left-counter signature is explained by one right-counter event
# (the reference's "recompiles pair 1:1 with capacity doublings").
# laf-lint's LAF105 probe (repro_torch.analysis.probe_checks) runs it,
# and tests/test_torch_analysis.py runs that probe on the CPU.
PAIRED_COUNTERS = (
    ("sweep.recompiles", "index.capacity_doublings"),
)


class RecompileWatcher:
    """The operand signatures one launch function has seen in this
    process; ``observe(sig)`` adds one to ``counter`` the first time a
    signature appears and returns whether it was new.  A signature is any
    hashable (the sweep's: launch rows, chunk, chunks per launch, the
    database's capacity rows and words, mode and dtypes).  ``reset()``
    forgets them, so a probe starts from an empty lattice."""

    __slots__ = ("name", "counter_name", "_seen", "_lock")

    def __init__(self, name: str, counter_name: str):
        self.name, self.counter_name = name, counter_name
        self._seen: set = set()
        self._lock = threading.Lock()

    def observe(self, sig: Hashable) -> bool:
        with self._lock:
            if sig in self._seen:
                return False
            self._seen.add(sig)
        metrics.counter(self.counter_name).inc()
        return True

    @property
    def signatures(self) -> frozenset:
        return frozenset(self._seen)

    def reset(self) -> None:
        with self._lock:
            self._seen.clear()


_watchers: Dict[Tuple[str, str], RecompileWatcher] = {}


def watch_recompiles(name: str, counter_name: str) -> RecompileWatcher:
    """Get or create the watcher of launch function ``name`` feeding
    ``counter_name``: one per process, as the reference's jit caches are."""
    key = (name, counter_name)
    w = _watchers.get(key)
    if w is None:
        w = _watchers[key] = RecompileWatcher(name, counter_name)
    return w


_loops = threading.local()


@contextlib.contextmanager
def loop_scope(name: str):
    """Mark a host loop that enqueues device work (see module docstring)."""
    stack = getattr(_loops, "stack", None)
    if stack is None:
        stack = _loops.stack = []
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def current_loops() -> Tuple[str, ...]:
    """The loop scopes open on this thread, outermost first."""
    return tuple(getattr(_loops, "stack", ()))


enable_from_env()
