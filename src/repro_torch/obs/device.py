"""Device-resident telemetry: in-launch counters of the cluster fixpoint
and the count sweeps (port of ``repro.obs.device``).

The cluster pass is one host copy at its end, so the host-span layer
sees one opaque ``laf.label_prop`` interval where the per-round
dynamics live.  This module restores that visibility without adding a
host sync:

* the fixpoint's update kernel adds four per-round counts (frontier
  size, labels changed, pointer-jump hops, gather wins) into a small
  int32 ``(4, max_iters)`` device tensor, and the Hamming filter's
  stats bodies write per-chunk ``[accept, band, reject]`` occupancy
  into an int32 ``(n_chunks, 3)`` slab of the *count* sweeps;
* both ride the copy their pass already makes (``laf.cluster.host_syncs``
  and ``sweep.host_syncs`` stay 1 with telemetry on) and are folded into
  the metrics registry here;
* per-round values become **synthetic child spans** under the measured
  ``laf.label_prop`` interval, so a Chrome trace shows the rounds and
  ``coverage()`` of that interval stays attributable.

Off by default; ``obs.enable(telemetry=True)`` or ``REPRO_OBS=device``
turns it on.  With it off the kernels get a null telemetry pointer and
the results are bit-identical.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from . import metrics as _metrics
from . import trace as _trace

__all__ = [
    "enable_device",
    "disable_device",
    "device_enabled",
    "MAX_ROUNDS",
    "SWEEP_STAT_FIELDS",
    "CLUSTER_ROUND_FIELDS",
    "cluster_telemetry_init",
    "sweep_stats_tile_sum",
    "harvest_cluster_telemetry",
    "harvest_sweep_telemetry",
    "emit_round_spans",
    "last_sweep_stats",
    "defer_sweep_stats",
    "take_deferred_sweep_stats",
]

# default round budget of the cluster fixpoint (``max_iters=64`` of
# ``packed_cluster_fixpoint``): the per-round vectors are sized to it
MAX_ROUNDS = 64

SWEEP_STAT_FIELDS = ("accept", "band", "reject")
CLUSTER_ROUND_FIELDS = ("frontier", "changed", "hops", "shard_wins")


class _State:
    on: bool = False


_state = _State()
_lock = threading.Lock()
# last harvested per-chunk sweep occupancy (host ndarray (n_chunks, 3))
_last_sweep_stats = None
# a device occupancy slab waiting for its pass's host copy
_deferred_sweep_stats = None


def enable_device() -> None:
    _state.on = True


def disable_device() -> None:
    _state.on = False


def device_enabled() -> bool:
    return _state.on


def cluster_telemetry_init(max_iters: int = MAX_ROUNDS, device=None) -> torch.Tensor:
    """Zeroed per-round telemetry of one cluster fixpoint: an int32
    ``(4, max_iters)`` tensor on ``device`` (``None`` = cuda, raising
    without a card; a ``torch.device`` is taken as given: a tensor's),
    one row per field of ``CLUSTER_ROUND_FIELDS``, one column per round."""
    device = device if isinstance(device, torch.device) else resolve_device(device)
    return torch.zeros((len(CLUSTER_ROUND_FIELDS), max_iters), dtype=torch.int32, device=device)


def sweep_stats_tile_sum(stats: torch.Tensor) -> torch.Tensor:
    """Reduce a raw ``(..., 3)`` occupancy output to one ``(3,)`` int32
    triple."""
    return stats.reshape(-1, 3).sum(dim=0).to(torch.int32)


def harvest_cluster_telemetry(tele_host, rounds: int) -> Dict[str, List[int]]:
    """Fold fetched per-round vectors into the metrics registry.

    ``tele_host`` is the host copy of the fixpoint's telemetry (this
    function never syncs).  Returns ``{field: [per-round values]}``
    trimmed to the executed ``rounds``; counters ``laf.telemetry.<field>``
    accumulate the per-run totals.
    """
    rounds = int(rounds)
    out: Dict[str, List[int]] = {}
    for name, vec in zip(CLUSTER_ROUND_FIELDS, tele_host):
        vals = [int(v) for v in list(vec)[:rounds]]
        out[name] = vals
        _metrics.counter(f"laf.telemetry.{name}").inc(sum(vals))
    return out


def harvest_sweep_telemetry(stats_host) -> Optional[Dict[str, int]]:
    """Fold the fetched per-chunk ``(n_chunks, 3)`` occupancy slab into
    ``sweep.tele.{accept,band,reject}`` counters (kernel-grid values,
    pad tiles included, the reference's convention) and keep the slab
    for :func:`last_sweep_stats`.  Totals are summed in int64."""
    global _last_sweep_stats
    if stats_host is None:
        return None
    arr = np.asarray(stats_host)
    with _lock:
        _last_sweep_stats = arr
    totals = arr.astype(np.int64).sum(axis=0)
    out = {}
    for i, name in enumerate(SWEEP_STAT_FIELDS):
        out[name] = int(totals[i])
        _metrics.counter(f"sweep.tele.{name}").inc(int(totals[i]))
    return out


def last_sweep_stats():
    """Most recent harvested per-chunk occupancy slab (host ndarray
    ``(n_chunks, 3)``) or None."""
    with _lock:
        return _last_sweep_stats


def defer_sweep_stats(stats: torch.Tensor) -> None:
    """Leave a sweep's device ``(n_chunks, 3)`` occupancy slab for the
    pass that reads its results: the sharded plane's bitmap sweep has no
    host copy of its own, so its slab rides the cluster pass's."""
    global _deferred_sweep_stats
    with _lock:
        _deferred_sweep_stats = stats


def take_deferred_sweep_stats() -> Optional[torch.Tensor]:
    """The deferred slab (then cleared), or None."""
    global _deferred_sweep_stats
    with _lock:
        out, _deferred_sweep_stats = _deferred_sweep_stats, None
    return out


def emit_round_spans(
    parent: Optional["_trace.SpanRecord"],
    per_round: Dict[str, List[int]],
    name: str = "laf.cluster.round",
) -> List["_trace.SpanRecord"]:
    """Synthesize per-round child spans under a measured parent span.

    The rounds have no host-observable boundaries, so the parent
    interval (``laf.label_prop``, which closes after the pass's one host
    copy) is cut into ``rounds`` equal slices, each carrying that
    round's telemetry as attributes.
    """
    if parent is None or not _trace._state.trace:
        return []
    rounds = len(next(iter(per_round.values()), []))
    if rounds <= 0 or parent.dur <= 0:
        return []
    slice_dur = parent.dur / rounds
    recs = []
    for i in range(rounds):
        recs.append(_trace.SpanRecord(
            name,
            t0=parent.t0 + i * slice_dur,
            dur=slice_dur,
            span_id=next(_trace._ids),
            parent_id=parent.span_id,
            tid=parent.tid,
            attrs=dict({f: vals[i] for f, vals in per_round.items()}, round=i, synthetic=True),
        ))
    with _trace._lock:
        _trace._records.extend(recs)
    return recs
