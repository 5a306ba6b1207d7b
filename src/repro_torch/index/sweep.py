"""Sweep engine: a whole query sweep through the Hamming-filter kernel
with one host sync (port of ``repro.index.sweep``, single device).

The output slabs are allocated once per sweep; the query rows are cut
into ``plan.n_launches`` launches of ``chunk * chunks_per_launch`` rows,
each writing its rows of the slabs in place on the current stream, and
the host reads the results exactly once at the end (``sweep_counts``,
``sweep_bitmap``) or never (``sweep_bitmap_device``, whose slab feeds
the cluster pass).  ``db``/``db_sig`` may carry zero rows past the live
``n`` (capacity slack): their hits are subtracted with ``_pad_col_hits``
and their bits cleared with ``_tail_word_mask``, as in the reference.

With device telemetry on (``obs.enable(telemetry=True)``) the *count*
sweep runs the kernel's stats body: one ``(n_chunks, 3)`` int32 slab,
allocated once per sweep, takes every chunk's ``[accept, band, reject]``
occupancy on the reference's padded ``q_tile x db_tile`` grid, and
rides the counts' single host copy into ``sweep.tele.*`` and
``obs.device.last_sweep_stats()``.  The bitmap sweeps carry none, as in
the reference: they feed the cluster pass, which has its own per-round
counters.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.hamming_filter.ops import (
    DEFAULT_DB_TILE,
    DEFAULT_Q_TILE,
    _pad_col_hits,
    _tail_word_mask,
    hamming_filter_into,
    pad_grid_stats,
)
from ..obs import device as _obs_device
from ..obs import metrics as _metrics
from ..obs import span as _span

__all__ = [
    "SweepPlan",
    "plan_sweep",
    "sweep_counts",
    "sweep_bitmap",
    "sweep_bitmap_device",
    "DEFAULT_CHUNKS_PER_LAUNCH",
]

DEFAULT_CHUNKS_PER_LAUNCH = 8


@dataclass(frozen=True)
class SweepPlan:
    """Launch layout of one query sweep: ``n_launches`` launches of
    ``cpl`` chunks of ``chunk`` rows; slabs have ``nq_padded`` rows, and
    rows past ``nq`` stay zero."""

    nq: int
    chunk: int
    cpl: int
    n_launches: int

    @property
    def rows_per_launch(self) -> int:
        return self.chunk * self.cpl

    @property
    def nq_padded(self) -> int:
        return self.n_launches * self.rows_per_launch


def plan_sweep(
    nq: int,
    chunk: int,
    q_tile: int = DEFAULT_Q_TILE,
    chunks_per_launch: int = DEFAULT_CHUNKS_PER_LAUNCH,
) -> SweepPlan:
    chunk = -(-max(chunk, 1) // q_tile) * q_tile
    n_chunks = max(1, -(-nq // chunk))
    cpl = max(1, min(chunks_per_launch, n_chunks))
    n_launches = -(-n_chunks // cpl)
    return SweepPlan(nq, chunk, cpl, n_launches)


def _run(q, q_sig, db, db_sig, eps, t_lo, t_hi, plan, *, bitmap: bool, tele=None):
    """Allocate the slabs once and enqueue every launch; no sync.
    ``tele`` (the per-chunk occupancy slab) switches on the stats body."""
    dev = q.device
    counts = torch.zeros(plan.nq_padded, dtype=torch.int32, device=dev)
    slab = (
        torch.zeros((plan.nq_padded, -(-db.shape[0] // 32)), dtype=torch.int32, device=dev)
        if bitmap else None
    )
    step = plan.rows_per_launch
    _metrics.counter("sweep.sweeps").inc()
    _metrics.counter("sweep.launches").inc(plan.n_launches)
    _metrics.counter("sweep.slab_alloc").inc()
    for launch, s in enumerate(range(0, plan.nq, step)):
        e = min(plan.nq, s + step)
        stats = None
        if tele is not None:
            c0 = s // plan.chunk
            stats = tele[c0 : c0 + -(-(e - s) // plan.chunk)]
        # enqueue time only: the sweep's one sync is its host copy
        with _span("sweep.launch", L=launch, synced=False):
            hamming_filter_into(
                q[s:e], db, q_sig[s:e], db_sig, eps, t_lo, t_hi,
                counts[s:e], slab[s:e] if bitmap else None,
                stats=stats, chunk_rows=plan.chunk,
            )
    return counts, slab


def _operands(q, q_sig, db, db_sig):
    return (q.contiguous(), q_sig.contiguous(), db.contiguous(), db_sig.contiguous())


def _sweep_span(kind, nq, n, plan, **attrs):
    return _span("sweep.sweep", kind=kind, nq=nq, n=n, chunk=plan.chunk,
                 launches=plan.n_launches, chunks_per_launch=plan.cpl, **attrs)


def sweep_bitmap_device(q, q_sig, db, db_sig, n: int, eps, t_lo, t_hi, *,
                        chunk: int = 256, chunks_per_launch: int = DEFAULT_CHUNKS_PER_LAUNCH,
                        q_tile: int = DEFAULT_Q_TILE):
    """Packed adjacency of every query row against the first ``n`` db
    rows, left on the device: returns ``(slab, plan)`` with the slab
    ``(plan.nq_padded, ceil(len(db)/32))`` int32 and every bit for
    columns >= n clear."""
    q, q_sig, db, db_sig = _operands(q, q_sig, db, db_sig)
    plan = plan_sweep(q.shape[0], chunk, q_tile, chunks_per_launch)
    with _sweep_span("bitmap_device", q.shape[0], n, plan, synced=False):
        _, slab = _run(q, q_sig, db, db_sig, eps, t_lo, t_hi, plan, bitmap=True)
        if db.shape[0] > n:
            slab &= _tail_word_mask(slab.shape[1], n, slab.device)[None, :]
    return slab, plan


def sweep_bitmap(q, q_sig, db, db_sig, n: int, eps, t_lo, t_hi, *,
                 chunk: int = 256, chunks_per_launch: int = DEFAULT_CHUNKS_PER_LAUNCH,
                 q_tile: int = DEFAULT_Q_TILE):
    """(counts int64 ``(nq,)``, packed uint32 hits ``(nq, ceil(n/32))``)
    on the host, read in one copy."""
    q, q_sig, db, db_sig = _operands(q, q_sig, db, db_sig)
    nq = q.shape[0]
    plan = plan_sweep(nq, chunk, q_tile, chunks_per_launch)
    with _sweep_span("bitmap", nq, n, plan):
        counts, slab = _run(q, q_sig, db, db_sig, eps, t_lo, t_hi, plan, bitmap=True)
        words = -(-n // 32)
        counts, bm = counts[:nq], slab[:nq, :words]
        if db.shape[0] > n:
            counts = counts - _pad_col_hits(q_sig, eps, t_lo, t_hi, db.shape[0] - n)
            bm = bm & _tail_word_mask(words, n, bm.device)[None, :]
        host = torch.cat([counts[:, None], bm], dim=1).cpu().numpy()
        _metrics.counter("sweep.host_syncs").inc()
    return host[:, 0].astype(np.int64), np.ascontiguousarray(host[:, 1:]).view(np.uint32)


def sweep_counts(q, q_sig, db, db_sig, n: int, eps, t_lo, t_hi, *,
                 chunk: int = 256, chunks_per_launch: int = DEFAULT_CHUNKS_PER_LAUNCH,
                 q_tile: int = DEFAULT_Q_TILE, db_tile: int = DEFAULT_DB_TILE) -> np.ndarray:
    """Band-contract neighbor counts (int64 ``(nq,)``) of every query row
    against the first ``n`` db rows, through the count-only kernel.

    With device telemetry on, the per-chunk occupancy slab (``plan``'s
    ``n_launches * cpl`` chunks of ``plan.chunk`` rows against the db
    padded to ``db_tile``, as the reference's grid) is read in the same
    host copy as the counts and harvested into ``sweep.tele.*``."""
    q, q_sig, db, db_sig = _operands(q, q_sig, db, db_sig)
    nq = q.shape[0]
    plan = plan_sweep(nq, chunk, q_tile, chunks_per_launch)
    tele = None
    if _obs_device.device_enabled():
        tele = torch.zeros((plan.n_launches * plan.cpl, 3), dtype=torch.int32, device=q.device)
    with _sweep_span("count", nq, n, plan):
        counts, _ = _run(q, q_sig, db, db_sig, eps, t_lo, t_hi, plan, bitmap=False, tele=tele)
        counts = counts[:nq]
        if db.shape[0] > n:
            counts = counts - _pad_col_hits(q_sig, eps, t_lo, t_hi, db.shape[0] - n)
        parts = [counts]
        if tele is not None:
            tele += pad_grid_stats(q_sig, db_sig, int(t_lo), int(t_hi), chunk=plan.chunk,
                                   n_chunks=tele.shape[0], db_tile=db_tile)
            parts.append(tele.view(-1))
        host = torch.cat(parts).cpu().numpy()  # THE sweep's one host sync
        _metrics.counter("sweep.host_syncs").inc()
    if tele is not None:
        _obs_device.harvest_sweep_telemetry(host[nq:].reshape(-1, 3))
    return host[:nq].astype(np.int64)
