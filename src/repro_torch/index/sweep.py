"""Sweep engine: a whole query sweep through the Hamming-filter kernel
with one host sync (port of ``repro.index.sweep``).

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
``obs.device.last_sweep_stats()``.  The single-device bitmap sweeps
carry none, as in the reference: they feed the cluster pass, which has
its own per-round counters.

Under ``mesh=`` (the sharded index plane, ``distributed.index_plane``)
``db``/``db_sig`` are this rank's row blocks from ``shard_database`` and
``n`` the global live rows; each launch runs the rank's kernel and
submits its count all-reduce to the sweep's ``PlanePipeline`` (``depth``
2: waited on once the next launch is enqueued; 1: in line).  The plane
padding is corrected once a sweep.  ``sweep_bitmap`` gathers the words
once at the end; ``sweep_bitmap_device`` keeps them rank-local, (R,
W_local), and reduces no counts (nothing reads them): with device
telemetry on it runs the bitmap ``_stats`` body, sums the per-chunk
triples over the ranks and leaves them for the cluster pass's one host
copy (``obs.device.defer_sweep_stats``).

With metrics on, each sweep reports its launches' operand signature to
the ``sweep.launch`` watcher (``obs.watch_recompiles``, counter
``sweep.recompiles``): the rows a launch covers, its chunk and chunks,
the database's *capacity* (the rows of the buffer ``db`` is a view of:
a backend's append slack keeps it fixed between doublings), its width,
the signature words, the mode and the dtypes.  A steady query shape
therefore adds one signature per capacity doubling, as the reference's
jit cache adds one executable.  The host loop over the launches runs
inside ``obs.loop_scope("sweep.launches")``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..distributed.index_plane import PlanePipeline, local_tail_mask, plane_collective, sharded_sweep_launch
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
from ..obs import loop_scope as _loop_scope
from ..obs import span as _span
from ..obs import watch_recompiles

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


def capacity_rows(db: torch.Tensor) -> int:
    """Rows of the buffer ``db`` (rows of one width, row-major) is a view
    of: a backend's capacity, of which ``db`` holds the live rows."""
    row_bytes = db.element_size() * max(db.stride(0), 1)
    return max(db.shape[0], (db.untyped_storage().nbytes() - db.storage_offset() * db.element_size()) // row_bytes)


def launch_signature(q, q_sig, db, db_sig, plan, *, bitmap: bool, stats: bool, sharded: bool) -> tuple:
    """The operand signature of a sweep's launches (module docstring)."""
    return ("bitmap" if bitmap else "count", stats, sharded, plan.rows_per_launch, plan.chunk, plan.cpl,
            capacity_rows(db), db.shape[1], db_sig.shape[1], str(q.dtype), str(db.dtype), str(q_sig.dtype))


def _run(q, q_sig, db, db_sig, eps, t_lo, t_hi, plan, *, bitmap: bool, tele=None, pipe=None,
         db_tile: int = DEFAULT_DB_TILE, reduce_counts: bool = True):
    """Allocate the slabs once and enqueue every launch; no sync.
    ``tele`` (the per-chunk occupancy slab) switches on the stats body;
    ``pipe`` (a ``PlanePipeline``) runs each launch on the plane."""
    if _metrics.enabled():  # the counter's only readers run with metrics on
        watch_recompiles("sweep.launch", "sweep.recompiles").observe(launch_signature(
            q, q_sig, db, db_sig, plan, bitmap=bitmap, stats=tele is not None, sharded=pipe is not None))
    dev = q.device
    counts = torch.zeros(plan.nq_padded, dtype=torch.int32, device=dev)
    slab = (
        torch.zeros((plan.nq_padded, -(-db.shape[0] // 32)), dtype=torch.int32, device=dev)
        if bitmap else None
    )
    _metrics.counter("sweep.sweeps").inc()
    _metrics.counter("sweep.launches").inc(plan.n_launches)
    _metrics.counter("sweep.slab_alloc").inc()
    attrs = _sharded(pipe)
    step = plan.rows_per_launch
    with _loop_scope("sweep.launches"):
        for launch, s in enumerate(range(0, plan.nq, step)):
            e = min(plan.nq, s + step)
            # enqueue time only: the sweep's one sync is its host copy
            with _span("sweep.launch", L=launch, synced=False, **attrs):
                if pipe is not None:
                    sharded_sweep_launch(
                        q[s:e], q_sig[s:e], db, db_sig, eps, t_lo, t_hi, counts=counts[s:e],
                        bitmap=slab[s:e] if bitmap else None, pipe=pipe, chunk=plan.chunk, db_tile=db_tile,
                        stats=None if tele is None else tele[launch * plan.cpl : (launch + 1) * plan.cpl],
                        reduce_counts=reduce_counts,
                    )
                    continue
                stats = None
                if tele is not None:
                    c0 = s // plan.chunk
                    stats = tele[c0 : c0 + -(-(e - s) // plan.chunk)]
                hamming_filter_into(
                    q[s:e], db, q_sig[s:e], db_sig, eps, t_lo, t_hi,
                    counts[s:e], slab[s:e] if bitmap else None,
                    stats=stats, chunk_rows=plan.chunk,
                )
    if pipe is not None:
        pipe.wait()
    return counts, slab


def _pipe(mesh, axes, depth):
    """The sweep's ``PlanePipeline`` under ``mesh=``, else None."""
    if mesh is None:
        return None
    from ..distributed.sharding import plane_axes

    return PlanePipeline(plane_axes(mesh, axes), depth)


def _n_pad(db, n: int, pipe) -> int:
    """Zero rows past ``n``: capacity slack, or the plane's padding."""
    return db.shape[0] * (1 if pipe is None else pipe.ax.size) - n


def _sharded(pipe) -> dict:
    return {} if pipe is None else {"sharded": True, "pipelined": pipe.depth >= 2}


def _tele_slab(plan, dev):
    return torch.zeros((plan.n_launches * plan.cpl, 3), dtype=torch.int32, device=dev)


def _operands(q, q_sig, db, db_sig):
    return (q.contiguous(), q_sig.contiguous(), db.contiguous(), db_sig.contiguous())


def _sweep_span(kind, nq, n, plan, **attrs):
    return _span("sweep.sweep", kind=kind, nq=nq, n=n, chunk=plan.chunk,
                 launches=plan.n_launches, chunks_per_launch=plan.cpl, **attrs)


def sweep_bitmap_device(q, q_sig, db, db_sig, n: int, eps, t_lo, t_hi, *,
                        chunk: int = 256, chunks_per_launch: int = DEFAULT_CHUNKS_PER_LAUNCH,
                        q_tile: int = DEFAULT_Q_TILE, db_tile: int = DEFAULT_DB_TILE,
                        mesh=None, axes=None, depth: int = 2):
    """Packed adjacency of every query row against the first ``n`` db
    rows, left on the device: returns ``(slab, plan)`` with the slab
    ``(plan.nq_padded, ceil(len(db)/32))`` int32 and every bit for
    columns >= n clear (under ``mesh=``, this rank's words)."""
    q, q_sig, db, db_sig = _operands(q, q_sig, db, db_sig)
    plan = plan_sweep(q.shape[0], chunk, q_tile, chunks_per_launch)
    pipe = _pipe(mesh, axes, depth)
    tele = _tele_slab(plan, q.device) if pipe is not None and _obs_device.device_enabled() else None
    with _sweep_span("bitmap_device", q.shape[0], n, plan, synced=False, **_sharded(pipe)):
        _, slab = _run(q, q_sig, db, db_sig, eps, t_lo, t_hi, plan, bitmap=True, tele=tele, pipe=pipe,
                       db_tile=db_tile, reduce_counts=False)
        if _n_pad(db, n, pipe):
            mask = (_tail_word_mask(slab.shape[1], n, slab.device) if pipe is None
                    else local_tail_mask(slab.shape[1], n, pipe.ax, slab.device))
            slab &= mask[None, :]
        if tele is not None:
            _obs_device.defer_sweep_stats(tele)
    return slab, plan


def sweep_bitmap(q, q_sig, db, db_sig, n: int, eps, t_lo, t_hi, *,
                 chunk: int = 256, chunks_per_launch: int = DEFAULT_CHUNKS_PER_LAUNCH,
                 q_tile: int = DEFAULT_Q_TILE, mesh=None, axes=None, depth: int = 2):
    """(counts int64 ``(nq,)``, packed uint32 hits ``(nq, ceil(n/32))``)
    on the host, read in one copy (under ``mesh=``, after one gather of
    the ranks' words)."""
    q, q_sig, db, db_sig = _operands(q, q_sig, db, db_sig)
    nq = q.shape[0]
    plan = plan_sweep(nq, chunk, q_tile, chunks_per_launch)
    pipe = _pipe(mesh, axes, depth)
    with _sweep_span("bitmap", nq, n, plan, **_sharded(pipe)):
        counts, slab = _run(q, q_sig, db, db_sig, eps, t_lo, t_hi, plan, bitmap=True, pipe=pipe)
        if pipe is not None:
            slab = plane_collective("gather", slab[:nq], pipe.ax.group, order=pipe.ax.order)
        words = -(-n // 32)
        counts, bm = counts[:nq], slab[:nq, :words]
        n_pad = _n_pad(db, n, pipe)
        if n_pad:
            counts = counts - _pad_col_hits(q_sig, eps, t_lo, t_hi, n_pad)
            bm = bm & _tail_word_mask(words, n, bm.device)[None, :]
        host = torch.cat([counts[:, None], bm], dim=1).cpu().numpy()
        _metrics.counter("sweep.host_syncs").inc()
    return host[:, 0].astype(np.int64), np.ascontiguousarray(host[:, 1:]).view(np.uint32)


def sweep_counts(q, q_sig, db, db_sig, n: int, eps, t_lo, t_hi, *,
                 chunk: int = 256, chunks_per_launch: int = DEFAULT_CHUNKS_PER_LAUNCH,
                 q_tile: int = DEFAULT_Q_TILE, db_tile: int = DEFAULT_DB_TILE,
                 mesh=None, axes=None, depth: int = 2) -> np.ndarray:
    """Band-contract neighbor counts (int64 ``(nq,)``) of every query row
    against the first ``n`` db rows, through the count-only kernel.

    With device telemetry on, the per-chunk occupancy slab (``plan``'s
    ``n_launches * cpl`` chunks of ``plan.chunk`` rows against the db
    padded to ``db_tile``, as the reference's grid) is read in the same
    host copy as the counts and harvested into ``sweep.tele.*`` (under
    ``mesh=``: each shard's grid, the triples summed over the ranks)."""
    q, q_sig, db, db_sig = _operands(q, q_sig, db, db_sig)
    nq = q.shape[0]
    plan = plan_sweep(nq, chunk, q_tile, chunks_per_launch)
    pipe = _pipe(mesh, axes, depth)
    tele = _tele_slab(plan, q.device) if _obs_device.device_enabled() else None
    with _sweep_span("count", nq, n, plan, **_sharded(pipe)):
        counts, _ = _run(q, q_sig, db, db_sig, eps, t_lo, t_hi, plan, bitmap=False, tele=tele, pipe=pipe,
                         db_tile=db_tile)
        counts = counts[:nq]
        n_pad = _n_pad(db, n, pipe)
        if n_pad:
            counts = counts - _pad_col_hits(q_sig, eps, t_lo, t_hi, n_pad)
        parts = [counts]
        if tele is not None:
            if pipe is None:  # the plane adds its shards' pad pairs a launch
                tele += pad_grid_stats(q_sig, db_sig, int(t_lo), int(t_hi), chunk=plan.chunk,
                                       n_chunks=tele.shape[0], db_tile=db_tile)
            parts.append(tele.view(-1))
        host = torch.cat(parts).cpu().numpy()  # THE sweep's one host sync
        _metrics.counter("sweep.host_syncs").inc()
    if tele is not None:
        _obs_device.harvest_sweep_telemetry(host[nq:].reshape(-1, 3))
    return host[:nq].astype(np.int64)
