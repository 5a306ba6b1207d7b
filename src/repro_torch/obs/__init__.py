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

The reference's recompile accounting (``RecompileWatcher``,
``watch_recompiles``, ``PAIRED_COUNTERS``, the ``jax.monitoring``
listener) counts JAX executable-cache growth, which has no counterpart
in an eager PyTorch program; it is not ported.
"""

from __future__ import annotations

import os
from typing import Optional

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


enable_from_env()
