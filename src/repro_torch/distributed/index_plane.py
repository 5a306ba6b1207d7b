"""Device-sharded index plane on ``torch.distributed`` (port of
``repro.distributed.index_plane``).

The database rows and their packed sign-signature table are sharded
identically over a ``DeviceMesh``'s data axes, so every range query runs
shard-locally through the single-device Hamming-filter kernel.  Queries
are replicated; shard k holds global rows ``[k n_local, (k + 1)
n_local)``, k the flattened index over the axes, major axis first.
Only per-shard results cross ranks:

* counts: an all-reduce (SUM) of int32 partial counts;
* bitmaps: an all-gather of each shard's word-aligned (nq, n_local/32)
  int32 words, concatenated on the word axis in shard order, which *is*
  the global bitmap (``sharded_hamming_bitmap``, ``sweep_bitmap``); the
  clustering path keeps its words rank-local;
* the cluster fixpoint: a MIN all-reduce of the (R,) row minima a
  round, the counts' SUM once, the owner and column sums gathered once;

never the hit matrix, the database or the signature table.  Every
collective goes through :func:`plane_collective`, which refuses any
tensor that is not int32 (the reference's rule: only s32 counts and
labels cross ranks) and counts what it issues: ``plane.psum.*`` (SUM),
``plane.pmin.*`` (MIN), ``plane.gather.*`` (calls and bytes) and
``plane.chunks.pipelined`` / ``.serialized`` (the kernel chunks whose
counts, or occupancy triples, a sweep's all-reduces carried, issued
async or in line).  On a one-rank mesh nothing is issued and nothing is
counted: the plane is the plain wrapper call, as the reference's
1-device mesh is.

Plane padding (to a shard multiple of rows) is zero rows with zero
signatures at the end, corrected once after the sum by ``_pad_col_hits``
and never per shard; bits of columns >= n are cleared.  A sweep's count
all-reduces are pipelined by :class:`PlanePipeline`: at depth 2 a
launch's all-reduce is issued async and waited on only once the next
launch is enqueued (or the counts are read), the reference's
``_pipeline`` overlap; depth 1 issues each in line.  Both give identical
results.

The one-call evaluators (``sharded_hamming_count``, ``_bitmap``,
``sharded_band_marginals``, ``sharded_sweep_marginals``) take the whole
database on every rank and shard it themselves; the sweep launches and
the cluster pass take the rank-local blocks of ``shard_database`` and of
the sweep (``repro_torch.index.sweep`` under ``mesh=``).  Every rank must
make the same calls in the same order, as with any collective.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.range_query import unpack_bitmap_t
from ..index.signatures import _pad_block, shard_signatures
from ..kernels.hamming_filter.ops import (
    DEFAULT_DB_TILE,
    _pad_col_hits,
    _tail_word_mask,
    hamming_filter_bitmap,
    hamming_filter_count,
    hamming_filter_into,
    pad_grid_stats,
)
from ..obs import loop_scope as _loop_scope
from ..obs import metrics as _metrics
from .sharding import PlaneAxes, axis_size, data_axes, plane_axes

__all__ = [
    "ShardPlan",
    "shard_plan",
    "shard_database",
    "plane_collective",
    "PlanePipeline",
    "sharded_hamming_count",
    "sharded_hamming_bitmap",
    "sharded_band_marginals",
    "sharded_sweep_launch",
    "sharded_sweep_marginals",
    "sweep_marginals_local",
    "sharded_cluster_labels",
    "local_tail_mask",
]


def plane_collective(op: str, t: torch.Tensor, group, *, order=None, async_op: bool = False,
                     chunks: Optional[Tuple[int, bool]] = None):
    """The plane's one way across ranks.

    ``op`` is ``"sum"`` or ``"min"`` (an in-place all-reduce of ``t`` on
    ``group``; returns the work handle with ``async_op``, else None) or
    ``"gather"`` (returns every rank's ``t`` concatenated on the last
    axis, the group rank ``order[k]`` at place k).  ``t`` must be a
    contiguous int32 tensor.  ``group=None`` is a one-rank mesh: nothing
    is issued.  ``chunks=(n, pipelined)`` counts an all-reduce that
    carries ``n`` sweep chunks' results."""
    if t.dtype != torch.int32:
        raise TypeError(f"only int32 counts and labels cross ranks, got a {t.dtype} tensor")
    if not t.is_contiguous():
        raise ValueError("plane collectives take contiguous tensors")
    if group is None:
        return t if op == "gather" else None
    import torch.distributed as dist

    if op == "gather":
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        out = torch.cat([parts[g] for g in (order if order is not None else range(len(parts)))], dim=-1)
        _metrics.counter("plane.gather.calls").inc()
        _metrics.counter("plane.gather.bytes").inc(out.numel() * 4)
        return out
    if op not in ("sum", "min"):
        raise ValueError(f"unknown plane collective {op!r}")
    work = dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MIN, group=group,
                           async_op=async_op)
    name = "psum" if op == "sum" else "pmin"
    _metrics.counter(f"plane.{name}.calls").inc()
    _metrics.counter(f"plane.{name}.bytes").inc(t.numel() * 4)
    if chunks is not None:
        _metrics.counter("plane.chunks.pipelined" if chunks[1] else "plane.chunks.serialized").inc(chunks[0])
    return work


class PlanePipeline:
    """The count all-reduces of one sweep, one submit a launch.

    ``depth >= 2``: a launch's all-reduces are issued async and waited
    on when the next launch submits (its kernel already enqueued) or at
    :meth:`wait`; ``depth == 1``: each is issued in line."""

    def __init__(self, ax: PlaneAxes, depth: int = 2):
        self.ax, self.depth = ax, int(depth)
        self._pending = []

    def submit(self, tensors, n_chunks: int) -> None:
        self.wait()
        tensors = [t for t in tensors if t is not None]
        if not tensors or self.ax.group is None:
            return
        pipelined = self.depth >= 2
        works = [plane_collective("sum", t, self.ax.group, async_op=pipelined,
                                  chunks=(n_chunks, pipelined) if i == 0 else None)
                 for i, t in enumerate(tensors)]
        self._pending = [w for w in works if w is not None]

    def wait(self) -> None:
        for w in self._pending:
            w.wait()
        self._pending = []


@dataclass(frozen=True)
class ShardPlan:
    """Row layout of one database over one mesh: ``n_padded`` is ``n``
    rounded up so every shard holds the same number of rows and its
    packed bitmap words are whole (a shard's words concatenate into the
    global bitmap without bit shifting)."""

    axes: Tuple[str, ...]
    n_shards: int
    n: int
    n_padded: int

    @property
    def n_local(self) -> int:
        return self.n_padded // self.n_shards

    @property
    def n_pad(self) -> int:
        return self.n_padded - self.n


def shard_plan(mesh, n: int, axes=None, *, tile: int = 32) -> ShardPlan:
    """Row plan for an ``n``-row database sharded over ``axes`` (default:
    the mesh's data axes).  ``tile`` (a multiple of 32, e.g. the kernel's
    db tile) also aligns every shard's rows to that multiple:
    ``n_padded`` is a multiple of ``max(32, tile) * n_shards``."""
    axes = data_axes(mesh) if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))
    n_shards = axis_size(mesh, axes)
    if tile % 32:
        raise ValueError(f"tile must be a multiple of 32, got {tile}")
    mult = max(32, tile) * n_shards
    return ShardPlan(axes, n_shards, n, -(-n // mult) * mult)


def shard_database(mesh, data, sigs, axes=None, *, tile: int = 32, device=None):
    """Co-shard a database and its packed signature table: ``(db, db_sig,
    plan)`` with ``db`` (n_local, d) float32 and ``db_sig`` (n_local,
    words) int32 this rank's blocks on ``device`` (``None`` = cuda), zero
    rows past ``n``.  ``data`` / ``sigs``: arrays or tensors, whole on
    every rank; only this rank's rows are copied to the device."""
    if not torch.is_tensor(data):
        data = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
    plan = shard_plan(mesh, data.shape[0], axes, tile=tile)
    ax = plane_axes(mesh, plan.axes)
    dev = resolve_device(device)
    db = _pad_block(data.to(torch.float32), ax.index * plan.n_local, plan.n_local, dev)
    db_sig = shard_signatures(mesh, sigs, plan.axes, n_padded=plan.n_padded, device=dev)
    return db, db_sig, plan


def local_tail_mask(w_local: int, n: int, ax: PlaneAxes, device) -> torch.Tensor:
    """This shard's block of the global tail mask: int32 words clearing
    the bits of global columns >= n."""
    k = ax.index
    return _tail_word_mask(w_local * ax.size, n, device)[k * w_local : (k + 1) * w_local]


def _plane(q, db, q_sig, db_sig, mesh, axes, tile: int = 32):
    db, db_sig, plan = shard_database(mesh, db, db_sig, axes, tile=tile, device=q.device)
    return plan, plane_axes(mesh, plan.axes), db, db_sig


def sharded_hamming_count(q, db, q_sig, db_sig, eps, t_hi, *, mesh, t_lo=-1, axes=None):
    """(nq,) int32 global band-contract counts on every rank: each shard's
    kernel counts, one SUM, the plane padding subtracted once."""
    plan, ax, db, db_sig = _plane(q, db, q_sig, db_sig, mesh, axes)
    counts = hamming_filter_count(q, db, q_sig, db_sig, eps, t_hi, t_lo=t_lo)
    plane_collective("sum", counts, ax.group)
    if plan.n_pad:
        counts = counts - _pad_col_hits(q_sig, eps, t_lo, t_hi, plan.n_pad)
    return counts


def sharded_hamming_bitmap(q, db, q_sig, db_sig, eps, t_hi, *, mesh, t_lo=-1, axes=None):
    """(counts (nq,), packed hits (nq, ceil(n/32))) int32 on every rank,
    equal to the single-device wrapper's: the shards' word blocks
    gathered in shard order, plane-pad bits cleared."""
    n = db.shape[0]
    plan, ax, db, db_sig = _plane(q, db, q_sig, db_sig, mesh, axes)
    counts, bitmap = hamming_filter_bitmap(q, db, q_sig, db_sig, eps, t_hi, t_lo=t_lo)
    plane_collective("sum", counts, ax.group)
    bitmap = plane_collective("gather", bitmap, ax.group, order=ax.order)
    if plan.n_pad:
        counts = counts - _pad_col_hits(q_sig, eps, t_lo, t_hi, plan.n_pad)
        bitmap = bitmap & _tail_word_mask(bitmap.shape[1], n, bitmap.device)[None, :]
    return counts, bitmap[:, : -(-n // 32)]


def _marginals(q, db, q_sig, db_sig, eps, t_lo, t_hi, valid):
    _, bitmap = hamming_filter_bitmap(q, db, q_sig, db_sig, eps, t_hi, t_lo=t_lo)
    # all-zero db rows are padding (unit-norm data has none): whatever
    # their signatures say, they never count
    hit = unpack_bitmap_t(bitmap, db.shape[0]) & valid[None, :]
    return hit.sum(dim=1, dtype=torch.int32), hit.sum(dim=0, dtype=torch.int32)


def sharded_band_marginals(q, db, q_sig, db_sig, eps, t_hi, *, mesh, t_lo=-1, axes=None):
    """Both marginals of the hit matrix without gathering it: ``(counts
    (nq,), partial (n_local,))`` int32, the per-query counts summed over
    ranks and this shard's per-row partial counts (rows ``[k n_local,
    (k + 1) n_local)``; pad rows 0)."""
    _, ax, db, db_sig = _plane(q, db, q_sig, db_sig, mesh, axes)
    counts, partial = _marginals(q, db, q_sig, db_sig, eps, t_lo, t_hi, (db != 0).any(dim=1))
    plane_collective("sum", counts, ax.group)
    return counts, partial


def sharded_sweep_marginals(qs, db, q_sigs, db_sig, eps, t_hi, *, mesh, t_lo=-1, axes=None,
                            db_tile: int = DEFAULT_DB_TILE, depth: int = 2):
    """:func:`sharded_band_marginals` over pre-chunked frontiers, one
    kernel call and one count all-reduce a chunk, pipelined at
    ``depth``: ``qs`` (n_chunks, C, d), ``q_sigs`` (n_chunks, C, words);
    returns ``(counts (n_chunks, C), partial (n_local,))``, the partials
    summed over the chunks on this shard."""
    _, ax, db, db_sig = _plane(qs[0], db, q_sigs[0], db_sig, mesh, axes, tile=db_tile)
    return sweep_marginals_local(qs, db, q_sigs, db_sig, eps, t_lo, t_hi, ax, depth=depth)


def sweep_marginals_local(qs, db, q_sigs, db_sig, eps, t_lo, t_hi, ax: PlaneAxes, *, depth: int = 2):
    """The loop of :func:`sharded_sweep_marginals` over this rank's own
    blocks ``db`` / ``db_sig`` (all-zero rows are padding and never
    count), its count all-reduces on ``ax``'s group: ``(counts (n_chunks,
    C), partial (n_local,))``.  The chunks run inside
    ``obs.loop_scope("sweep.chunks")``."""
    valid = (db != 0).any(dim=1)
    counts = torch.zeros(qs.shape[:2], dtype=torch.int32, device=qs.device)
    partial = torch.zeros(db.shape[0], dtype=torch.int32, device=qs.device)
    pipe = PlanePipeline(ax, depth)
    with _loop_scope("sweep.chunks"):
        for k in range(qs.shape[0]):
            c, p = _marginals(qs[k], db, q_sigs[k], db_sig, eps, t_lo, t_hi, valid)
            counts[k] = c
            partial += p
            pipe.submit([counts[k]], 1)
    pipe.wait()
    return counts, partial


def sharded_sweep_launch(q, q_sig, db, db_sig, eps, t_lo, t_hi, *, counts, pipe: PlanePipeline,
                         chunk: int, bitmap=None, stats=None, db_tile: int = DEFAULT_DB_TILE,
                         reduce_counts: bool = True) -> None:
    """One launch of the sharded sweep (driven by ``repro_torch.index.
    sweep`` under ``mesh=``): the rank's kernel over its row block
    ``db``/``db_sig`` (``shard_database``'s, tile-aligned) into the
    zeroed outputs ``counts`` (and ``bitmap``'s local words), then the
    launch's count all-reduce submitted to ``pipe``.

    ``stats``, the launch's (cpl, 3) rows of the per-chunk occupancy
    slab, switches on the ``_stats`` bodies: the kernel's real pairs plus
    the reference's pad pairs of this shard's grid (``pad_grid_stats``:
    the launch's query rows padded to cpl chunks; the block is
    tile-aligned, so no db padding), summed over ranks with the counts.
    The plane padding's count correction is the driver's, once a sweep."""
    n_real = -(-q.shape[0] // chunk)
    hamming_filter_into(q, db, q_sig, db_sig, eps, t_lo, t_hi, counts, bitmap,
                        stats=None if stats is None else stats[:n_real], chunk_rows=chunk)
    if stats is not None:
        stats += pad_grid_stats(q_sig, db_sig, int(t_lo), int(t_hi), chunk=chunk,
                                n_chunks=stats.shape[0], db_tile=db_tile)
    # the triples cross ranks as one flat vector: no collective has a second axis
    pipe.submit([counts if reduce_counts else None, None if stats is None else stats.view(-1)],
                stats.shape[0] if stats is not None else n_real)


def sharded_cluster_labels(bitmap, rows, tau, *, mesh, axes, n: int, max_iters: int = 64, telemetry=None):
    """The cluster pass over a column-sharded packed slab.

    ``bitmap`` is this rank's (R, W_local) words of the sweep's slab
    (``sweep_bitmap_device`` under ``mesh=``: shard k's words are the
    columns of shard k's rows), ``rows`` the (R,) database indices of the
    slab rows (sentinel >= n on padding), the same on every rank.  Bits of
    columns >= n are cleared here.  Same contract as
    ``kernels.label_prop.packed_cluster_labels``: device tensors
    ``(labels, owner, col_sum, counts, rounds)`` over the global
    ``W_local * 32 * n_shards`` columns, identical on every rank, with no
    host read; ``owner`` and ``col_sum`` are gathered in shard order.  On
    one rank the fixpoint is its one cooperative launch; on several each
    round is three launches apart (see ``packed_cluster_fixpoint``).
    ``telemetry`` (default: the obs device switch) appends the (4,
    max_iters) per-round counts, the gather wins summed over ranks."""
    from ..kernels.label_prop import packed_cluster_fixpoint
    from ..obs import device as _obs_device

    if telemetry is None:
        telemetry = _obs_device.device_enabled()
    ax = plane_axes(mesh, axes)
    w_loc = bitmap.shape[1]
    bitmap = bitmap & local_tail_mask(w_loc, n, ax, bitmap.device)[None, :]
    rows = torch.as_tensor(rows).to(device=bitmap.device, dtype=torch.int32)
    cap_loc = w_loc * 32
    outs = packed_cluster_fixpoint(bitmap, rows, tau, n=n, cap=cap_loc * ax.size, max_iters=max_iters,
                                   telemetry=telemetry, col_off=ax.index * cap_loc, group=ax.group)
    if ax.group is None:
        return outs
    labels, owner, col_sum, counts, rounds = outs[:5]
    owner = plane_collective("gather", owner, ax.group, order=ax.order)
    col_sum = plane_collective("gather", col_sum, ax.group, order=ax.order)
    return (labels, owner, col_sum, counts, rounds) + tuple(outs[5:])
