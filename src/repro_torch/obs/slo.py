"""Declarative SLO thresholds over the metrics registry (port of
``repro.obs.slo``).

An :class:`SLO` is one rule — ``metric op threshold`` — where
``metric`` names a registry instrument (``"x.latency_s:p99"`` selects a
histogram summary field, plain names read counters and gauges) or a
caller-supplied derived value (skip rate, ARI, host syncs per run).

Evaluation never raises on missing data: a metric with no observations
yields ``ok=None`` ("no data").  Violations are emitted as structured,
rate-limited log lines (``slo.violation name=... value=...
threshold=...``).  The default thresholds are loose sanity floors;
deployments replace them with :func:`set_slos`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from . import metrics as _metrics
from .log import get_logger, rate_limited_warn

__all__ = [
    "SLO",
    "SLOResult",
    "SERVE_SLOS",
    "INGEST_SLOS",
    "CLUSTER_SLOS",
    "DEGRADED_SLOS",
    "EVAL_EVERY_CALLS",
    "set_slos",
    "resolve_metric",
    "evaluate",
    "check_and_alert",
]

_log = get_logger("obs.slo")

_OPS = {
    "<=": lambda v, t: v <= t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    ">": lambda v, t: v > t,
    "==": lambda v, t: v == t,
}


@dataclass(frozen=True)
class SLO:
    """One declarative rule: ``metric op threshold``.

    ``metric`` is a registry name, optionally ``name:field`` to select
    one field of a histogram summary (p50/p95/p99/min/max/count/sum),
    or any key the caller passes via ``values=``.
    """

    name: str
    metric: str
    op: str
    threshold: float
    description: str = ""

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown SLO op {self.op!r} (use one of {sorted(_OPS)})")


@dataclass(frozen=True)
class SLOResult:
    slo: SLO
    value: Optional[float]
    ok: Optional[bool]  # None = no data (metric absent / no observations)

    @property
    def violated(self) -> bool:
        return self.ok is False


SERVE_SLOS: List[SLO] = [
    SLO("serve-assign-p99", "serve.assign.latency_s:p99", "<=", 0.5,
        "p99 assign() wall seconds per call"),
]
INGEST_SLOS: List[SLO] = [
    SLO("ingest-skip-floor", "ingest.skip_rate", ">=", 0.0,
        "estimator fast-path fraction of the batch (derived per batch)"),
]
CLUSTER_SLOS: List[SLO] = [
    SLO("cluster-one-device-get", "cluster.device_get_per_run", "==", 1.0,
        "host syncs per device-resident cluster pass (derived per run)"),
    SLO("cluster-ari", "cluster.ari", ">=", 0.99, "parity vs the host oracle"),
]
DEGRADED_SLOS: List[SLO] = [
    SLO("stream-degraded", "stream.degraded.events", "<=", 0.0,
        "device query paths degraded to the host oracle (fault fallback)"),
]

# rules a serving loop evaluates every N calls
EVAL_EVERY_CALLS = 64

_lock = threading.Lock()


def set_slos(kind: str, slos: Sequence[SLO]) -> None:
    """Replace a default rule set ("serve" | "ingest" | "cluster" |
    "degraded")."""
    target = {
        "serve": SERVE_SLOS,
        "ingest": INGEST_SLOS,
        "cluster": CLUSTER_SLOS,
        "degraded": DEGRADED_SLOS,
    }[kind]
    with _lock:
        target[:] = list(slos)


def resolve_metric(metric: str, values: Optional[Dict[str, float]] = None):
    """Current value of ``metric``: caller-supplied ``values`` win, then
    the registry (histograms via ``name:field``).  None = no data."""
    if values and metric in values:
        return float(values[metric])
    name, _, field = metric.partition(":")
    v = _metrics.snapshot(prefix=name).get(name)
    if v is None:
        return None
    if isinstance(v, dict):  # histogram summary
        if not v.get("count"):
            return None
        return float(v.get(field or "p99", 0.0))
    return float(v)


def evaluate(slos: Sequence[SLO], values: Optional[Dict[str, float]] = None) -> List[SLOResult]:
    """Evaluate rules against ``values`` + the live registry."""
    out = []
    for s in slos:
        v = resolve_metric(s.metric, values)
        ok = None if v is None else _OPS[s.op](v, s.threshold)
        out.append(SLOResult(s, v, ok))
    return out


def check_and_alert(
    slos: Sequence[SLO],
    values: Optional[Dict[str, float]] = None,
    *,
    interval_s: float = 60.0,
) -> List[SLOResult]:
    """Evaluate and emit one rate-limited structured warning per
    violated rule; every evaluation also bumps the ``slo.evaluations``
    and ``slo.violations`` counters."""
    results = evaluate(slos, values)
    _metrics.counter("slo.evaluations").inc(len(results))
    for r in results:
        if r.violated:
            _metrics.counter("slo.violations").inc()
            rate_limited_warn(
                _log, f"slo:{r.slo.name}", "slo.violation",
                interval_s=interval_s,
                name=r.slo.name, metric=r.slo.metric, value=r.value,
                op=r.slo.op, threshold=r.slo.threshold,
            )
    return results
