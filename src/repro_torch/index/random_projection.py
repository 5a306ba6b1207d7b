"""Signed-random-projection ANN range backend (port of
``repro.index.random_projection``).

Per query: XOR + popcount between packed sign signatures splits pairs
on the Hamming band ``(t_lo, t_hi)`` — sure accepts below ``t_lo``,
exact fp32 verify inside the band, pruned above ``t_hi`` — the shared
predicate ``index.signatures.band_hits``.  ``verify="full"`` sets
``t_lo = -1`` (every candidate exact-checked).

Two evaluators of that one contract:

* the sweep engine (default): the database rows and signatures live on
  the backend's device and every query runs the Hamming-filter kernel
  (``kernels.hamming_filter``) with one host read per sweep;
  ``query_bitmap_device`` leaves the packed slab on the device for the
  cluster pass (``packs_natively``);
* ``oracle=True``: the host numpy path (``_tile_hits`` /
  ``_tile_counts``), the in-package parity oracle.

Sharded (``mesh=`` a ``DeviceMesh``, ``mesh_axes=`` default its data
axes, ``pipeline_depth=``): the database rows and signature table are
co-sharded over the mesh by ``distributed.index_plane.shard_database``
at ``fit`` and after every ``partial_fit`` append (``_reshard``); every
sweep runs the plane (``index.sweep`` under ``mesh=``).  The host copy
of the rows and signatures stays whole on every rank: queries and
column subsets are gathered on the host and uploaded whole, and the
signatures are signed on the device in the same blocks as on one device,
so their bits are the same.  Every rank must make the same calls.

Device faults: a sweep that fails (a refused launch, or a
``testing.faults`` plan firing at ``sweep.launch``, or ``plane.launch``
under ``mesh=``) raises to the caller.  Nothing retries it or falls back
to the host oracle.

``suggest_margin`` / ``record_occupancy`` price the Hamming band with
the kernel's ``[accept, band, reject]`` occupancy counters (or one host
Hamming sweep on the oracle); with metrics on, ``band()`` records its
own band's occupancy once per eps into ``index.band.*``.
``q_tile``/``db_tile`` are the reference kernel's tile grid, on which
those counters and the sweep's occupancy slab are defined.

Streaming: ``partial_fit`` signs the appended rows with the existing
projection on the device and writes rows and signatures in place into
capacity buffers that grow by doubling, rounded to ``db_tile`` as the
reference rounds them; the database never leaves the device and every
query sees exactly its first n rows.  ``state_export`` /
``state_import`` carry the reference's keys and dtypes (``n``,
``data_buf``, ``sigs_buf`` as uint32, ``projection``, ``n_bits``,
``seed``, ``db_tile``), so a snapshot restores in either package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.range_query import pack_bitmap, unpack_bitmap
from ..kernels.hamming_filter.ops import DEFAULT_DB_TILE, DEFAULT_Q_TILE, hamming_filter_count
from ..obs import get_logger, rate_limited_warn
from ..obs import metrics as _metrics
from ..testing import faults as _faults
from .base import RangeBackend, register_backend
from .signatures import hamming_band, hamming_numpy, make_projection, sign_signatures
from .sweep import DEFAULT_CHUNKS_PER_LAUNCH, sweep_bitmap, sweep_bitmap_device, sweep_counts

__all__ = ["RandomProjectionBackend", "suggest_margin", "record_occupancy"]

_SIGN_BLOCK = 65536  # rows a block, sign_signatures' own default


@register_backend
class RandomProjectionBackend(RangeBackend):
    name = "random_projection"

    def __init__(
        self,
        *,
        n_bits: int = 512,
        margin: float = 3.0,
        seed: int = 0,
        verify: str = "band",
        block_size: int = 2048,
        chunk: int = 256,
        max_band_frac: float = 0.05,
        q_tile: int = DEFAULT_Q_TILE,
        db_tile: int = DEFAULT_DB_TILE,
        chunks_per_launch: int = DEFAULT_CHUNKS_PER_LAUNCH,
        oracle: bool = False,
        device=None,
        mesh=None,
        mesh_axes=None,
        pipeline_depth: int = 2,
    ):
        if verify not in ("band", "full"):
            raise ValueError(f"verify must be 'band' or 'full', got {verify!r}")
        self.n_bits = n_bits
        self.margin = margin
        self.seed = seed
        self.verify = verify
        self.block_size = block_size
        self.chunk = chunk
        self.max_band_frac = max_band_frac
        self.q_tile = q_tile
        self.db_tile = db_tile
        self.chunks_per_launch = int(chunks_per_launch)
        self.oracle = bool(oracle)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.mesh_axes = mesh_axes
        self.pipeline_depth = int(pipeline_depth)
        # the plane: this rank's row blocks and their plan (mesh only);
        # the host signature buffer, whole on every rank
        self._db_plane: Optional[torch.Tensor] = None
        self._sig_plane: Optional[torch.Tensor] = None
        self._plan = None
        self._sigs_buf_host: Optional[np.ndarray] = None
        self.projection: Optional[np.ndarray] = None
        self._data: Optional[np.ndarray] = None
        self._data_dev: Optional[torch.Tensor] = None
        self._sigs_dev: Optional[torch.Tensor] = None
        self._sigs_host: Optional[np.ndarray] = None
        # capacity buffers (host rows, device rows, device signatures):
        # _data, _data_dev and _sigs_dev are their first n rows
        self._data_buf: Optional[np.ndarray] = None
        self._data_buf_dev: Optional[torch.Tensor] = None
        self._sigs_buf_dev: Optional[torch.Tensor] = None
        # eps values whose band occupancy was already measured into the
        # index.band.* metrics (one sampled pass per (backend, eps))
        self._occ_recorded: set = set()

    # -- index build -------------------------------------------------------
    def fit(self, data: np.ndarray) -> "RandomProjectionBackend":
        if self._data is data:
            return self
        data = np.ascontiguousarray(data, dtype=np.float32)
        if (
            self._data is not None
            and self._data.shape == data.shape
            and np.array_equal(self._data, data)
        ):
            self._data = data  # same content, fresh object: no rebuild
            return self
        self.projection = make_projection(data.shape[1], self.n_bits, self.seed)
        self._data = data
        if self.mesh is not None:
            self._data_buf, self._sigs_buf_host = data, self._sign_host(data)
            self._set_views(data.shape[0])
            self._data = data  # the array itself, so a refit on it is a no-op
            return self
        self._data_dev = torch.from_numpy(data).to(self.device)
        self._sigs_dev = sign_signatures(self._data_dev, self.projection, device=self.device)
        self._sigs_host = None
        # cap == n: the first append copies into owned buffers
        self._data_buf, self._data_buf_dev, self._sigs_buf_dev = self._data, self._data_dev, self._sigs_dev
        return self

    def partial_fit(self, rows: np.ndarray) -> "RandomProjectionBackend":
        """Append rows and their signatures (streaming ingest): signed
        through the existing projection on the device and written in
        place into the capacity buffers; nothing already indexed is
        recomputed or uploaded again.  Capacity doubles, rounded to the
        db tile, as the reference's does (``index.capacity_doublings``)."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if self._data is None:
            return self.fit(rows)
        n, b = self._data.shape[0], rows.shape[0]
        if b == 0:
            return self
        if n + b > self._data_buf.shape[0]:
            _metrics.counter("index.capacity_doublings").inc()
            cap = max(2 * self._data_buf.shape[0], n + b)
            cap = -(-cap // self.db_tile) * self.db_tile
            d, words = self._data.shape[1], self.n_bits // 32
            data_buf = np.zeros((cap, d), dtype=np.float32)
            data_buf[:n] = self._data
            if self.mesh is not None:
                sigs_buf = np.zeros((cap, words), dtype=np.int32)
                sigs_buf[:n] = self._sigs_buf_host[:n]
                self._data_buf, self._sigs_buf_host = data_buf, sigs_buf
            else:
                data_dev = torch.zeros((cap, d), dtype=torch.float32, device=self.device)
                data_dev[:n] = self._data_dev
                sigs_dev = torch.zeros((cap, words), dtype=torch.int32, device=self.device)
                sigs_dev[:n] = self._sigs_dev
                self._data_buf, self._data_buf_dev, self._sigs_buf_dev = data_buf, data_dev, sigs_dev
        self._data_buf[n : n + b] = rows
        if self.mesh is not None:
            self._sigs_buf_host[n : n + b] = self._sign_host(rows)
        else:
            new = torch.from_numpy(rows).to(self.device)
            self._data_buf_dev[n : n + b] = new
            self._sigs_buf_dev[n : n + b] = sign_signatures(new, self.projection, device=self.device)
        self._set_views(n + b)
        return self

    def _sign_host(self, rows: np.ndarray) -> np.ndarray:
        """(len(rows), words) int32 signatures signed on the device, in the
        blocks ``sign_signatures`` signs a device table in, read back."""
        out = np.empty((rows.shape[0], self.n_bits // 32), dtype=np.int32)
        for s in range(0, rows.shape[0], _SIGN_BLOCK):
            out[s : s + _SIGN_BLOCK] = sign_signatures(
                rows[s : s + _SIGN_BLOCK], self.projection, device=self.device).cpu().numpy()
        return out

    def _set_views(self, n: int) -> None:
        self._data = self._data_buf[:n]
        if self.mesh is not None:
            self._sigs_host = self._sigs_buf_host[:n].view(np.uint32)
            self._reshard()
            return
        self._data_dev = self._data_buf_dev[:n]
        self._sigs_dev = self._sigs_buf_dev[:n]
        self._sigs_host = None

    def _reshard(self) -> None:
        """Place this rank's row blocks of the rows and signatures on the
        plane (the plan depends on n, so every append re-pads them)."""
        from ..distributed.index_plane import shard_database

        self._db_plane, self._sig_plane, self._plan = shard_database(
            self.mesh, self._data, self._sigs_buf_host[: self._data.shape[0]], self.mesh_axes,
            tile=self.db_tile, device=self.device)

    def state_export(self):
        """Capacity-faithful snapshot in the reference's keys and dtypes:
        the whole capacity buffers (rows, uint32 signatures), the live
        row count, the projection and the config echo."""
        assert self._data is not None, "call fit() first"
        sigs_buf = self._sigs_buf_host if self.mesh is not None else self._sigs_buf_dev.cpu().numpy()
        return {
            "n": np.int64(self._data.shape[0]),
            "data_buf": np.ascontiguousarray(self._data_buf),
            "sigs_buf": sigs_buf.view(np.uint32),
            "projection": np.ascontiguousarray(self.projection),
            "n_bits": np.int64(self.n_bits),
            "seed": np.int64(self.seed),
            "db_tile": np.int64(self.db_tile),
        }

    def state_import(self, state) -> "RandomProjectionBackend":
        if int(state["n_bits"]) != self.n_bits:
            raise ValueError(f"snapshot n_bits={int(state['n_bits'])} != backend n_bits={self.n_bits}")
        if int(state["db_tile"]) != self.db_tile:
            raise ValueError(f"snapshot db_tile={int(state['db_tile'])} != backend db_tile={self.db_tile}")
        self._data_buf = np.ascontiguousarray(state["data_buf"], dtype=np.float32)
        sigs = np.ascontiguousarray(state["sigs_buf"], dtype=np.uint32).view(np.int32)
        if self.mesh is not None:
            self._sigs_buf_host = sigs.copy()
        else:
            self._data_buf_dev = torch.from_numpy(self._data_buf).to(self.device)
            self._sigs_buf_dev = torch.from_numpy(sigs).to(self.device)
        self.projection = np.ascontiguousarray(state["projection"], dtype=np.float32)
        self.seed = int(state["seed"])
        self._set_views(int(state["n"]))
        return self

    @property
    def data_device(self) -> torch.Tensor:
        if self.mesh is not None:  # the rank holds its row block only: upload the rows
            return super().data_device
        assert self._data_dev is not None, "call fit() first"
        return self._data_dev

    @property
    def signatures(self) -> np.ndarray:
        """Packed uint32 signatures on the host (copied once, lazily)."""
        if self.mesh is not None:
            assert self._sigs_host is not None, "call fit() first"
            return self._sigs_host
        assert self._sigs_dev is not None, "call fit() first"
        if self._sigs_host is None:
            self._sigs_host = self._sigs_dev.cpu().numpy().view(np.uint32)
        return self._sigs_host

    def band(self, eps: float) -> tuple[int, int]:
        """(t_lo, t_hi) for this index; t_lo is -1 in full-verify mode."""
        t_lo, t_hi = hamming_band(eps, self.n_bits, self.margin)
        if self.verify == "full":
            t_lo = -1
        if _metrics.enabled() and self._data is not None and float(eps) not in self._occ_recorded:
            # one sampled occupancy pass per (backend, eps) feeds index.band.*
            self._occ_recorded.add(float(eps))
            try:
                record_occupancy(self, eps)
            except Exception as e:  # instrumentation must not break queries
                rate_limited_warn(
                    get_logger("index"), "occupancy", "occupancy_record_failed",
                    error=type(e).__name__,
                )
        return t_lo, t_hi

    # -- host oracle -------------------------------------------------------
    def _band_split(self, ham: np.ndarray, eps: float):
        t_lo, t_hi = self.band(eps)
        accept = ham <= t_lo
        band = (ham <= t_hi) & ~accept
        return accept, band

    def _tile_hits(self, rows, cols, ham, eps):
        """Band split + exact verify for one (rows, cols) tile given its
        Hamming distances; ``cols=None`` means the whole database."""
        data = self._data
        thresh = 1.0 - eps
        accept, band = self._band_split(ham, eps)
        pi, pj = np.nonzero(band)
        if len(pi) > self.max_band_frac * band.size:
            # band saturated: dense exact verify of the tile
            cdata = data if cols is None else data[cols]
            dots = data[rows] @ cdata.T
            return accept | (band & (dots > thresh))
        hit = accept
        if len(pi):
            cj = pj if cols is None else cols[pj]
            dots = np.einsum("ij,ij->i", data[rows[pi]], data[cj], optimize=True)
            hit = accept.copy()
            hit[pi, pj] = dots > thresh
        return hit

    def _tile_counts(self, rows, ham, eps):
        """Per-row hit counts for one tile without the hit matrix."""
        data = self._data
        thresh = 1.0 - eps
        accept, band = self._band_split(ham, eps)
        counts = accept.sum(axis=1, dtype=np.int64)
        pi, pj = np.nonzero(band)
        if len(pi) > self.max_band_frac * band.size:
            dots = data[rows] @ data.T
            counts += (band & (dots > thresh)).sum(axis=1, dtype=np.int64)
        elif len(pi):
            dots = np.einsum("ij,ij->i", data[rows[pi]], data[pj], optimize=True)
            counts += np.bincount(pi[dots > thresh], minlength=counts.shape[0]).astype(np.int64)
        return counts

    def _host_chunks(self, rows):
        for start in range(0, len(rows), self.chunk):
            sub = rows[start : start + self.chunk]
            yield start, sub, hamming_numpy(self.signatures[sub], self.signatures)

    def _host_query_hits(self, rows, eps):
        hit = np.zeros((len(rows), self.n_points), dtype=bool)
        for start, sub, ham in self._host_chunks(rows):
            hit[start : start + len(sub)] = self._tile_hits(sub, None, ham, eps)
        return hit

    def _host_query_counts(self, rows, eps):
        counts = np.zeros(len(rows), dtype=np.int64)
        for start, sub, ham in self._host_chunks(rows):
            counts[start : start + len(sub)] = self._tile_counts(sub, ham, eps)
        return counts

    def _host_query_hits_subset(self, rows, cols, eps):
        hit = np.zeros((len(rows), len(cols)), dtype=bool)
        col_tile = 2048
        sigs = self.signatures
        for rs in range(0, len(rows), self.chunk):
            rsub = rows[rs : rs + self.chunk]
            for cs in range(0, len(cols), col_tile):
                csub = cols[cs : cs + col_tile]
                ham = hamming_numpy(sigs[rsub], sigs[csub])
                hit[rs : rs + len(rsub), cs : cs + len(csub)] = self._tile_hits(rsub, csub, ham, eps)
        return hit

    # -- sweep engine ------------------------------------------------------
    @property
    def _launch_site(self) -> str:
        """Fault-injection site of this backend's device sweeps."""
        return "plane.launch" if self.mesh is not None else "sweep.launch"

    def _gather(self, idx):
        """(rows, signatures) on the device for host or device indices;
        under ``mesh=`` gathered on the host (host indices) and uploaded."""
        if self.mesh is not None:
            idx = np.asarray(idx, dtype=np.int64)
            q = torch.from_numpy(np.ascontiguousarray(self._data[idx])).to(self.device)
            q_sig = torch.from_numpy(np.ascontiguousarray(self._sigs_host[idx]).view(np.int32)).to(self.device)
            return q, q_sig
        if not torch.is_tensor(idx):
            idx = torch.from_numpy(np.asarray(idx, dtype=np.int64))
        t = idx.to(device=self.device, dtype=torch.int64)
        return self._data_dev[t], self._sigs_dev[t]

    def _sweep_kw(self):
        return dict(chunk=self.chunk, chunks_per_launch=self.chunks_per_launch, q_tile=self.q_tile)

    def _db(self):
        """The sweep's database operands: the whole table, or under
        ``mesh=`` this rank's blocks with the plane's keywords."""
        if self.mesh is None:
            return self._data_dev, self._sigs_dev, {}
        return self._db_plane, self._sig_plane, dict(mesh=self.mesh, axes=self._plan.axes,
                                                     depth=self.pipeline_depth)

    def query_bitmap_device(self, rows, eps: float):
        """Packed adjacency slab for ``rows`` (host or device indices; host
        under ``mesh=``) as a device tensor, no host sync: ``(slab, plan)``
        from ``index.sweep.sweep_bitmap_device`` (under ``mesh=`` this
        rank's words)."""
        t_lo, t_hi = self.band(eps)
        q, q_sig = self._gather(rows)
        db, db_sig, plane = self._db()
        return sweep_bitmap_device(
            q, q_sig, db, db_sig, self.n_points, eps, t_lo, t_hi, db_tile=self.db_tile,
            **self._sweep_kw(), **plane,
        )

    def _sweep_hits_packed(self, rows, eps):
        _faults.maybe_fail(self._launch_site, op="hits")
        t_lo, t_hi = self.band(eps)
        q, q_sig = self._gather(rows)
        db, db_sig, plane = self._db()
        return sweep_bitmap(
            q, q_sig, db, db_sig, self.n_points, eps, t_lo, t_hi, **self._sweep_kw(), **plane,
        )

    # -- queries -----------------------------------------------------------
    @property
    def packs_natively(self) -> bool:
        return not self.oracle

    def query_hits(self, rows: np.ndarray, eps: float) -> np.ndarray:
        assert self._data is not None, "call fit() first"
        rows = np.asarray(rows, dtype=np.int64)
        if self.oracle:
            return self._host_query_hits(rows, eps)
        _, bitmap = self._sweep_hits_packed(rows, eps)
        return unpack_bitmap(bitmap, self.n_points)

    def query_hits_packed(self, rows: np.ndarray, eps: float):
        assert self._data is not None, "call fit() first"
        rows = np.asarray(rows, dtype=np.int64)
        if self.oracle:
            return super().query_hits_packed(rows, eps)
        return self._sweep_hits_packed(rows, eps)

    def query_packed_device(self, rows: np.ndarray, eps: float):
        """Packed hit rows (len(rows), ceil(n/32)) as an int32 tensor on
        the device, straight from the sweep's slab with no host read:
        the streaming ingest's native block.  On the oracle, the host
        oracle's words are uploaded instead."""
        assert self._data is not None, "call fit() first"
        rows = np.asarray(rows, dtype=np.int64)
        if self.oracle:
            words = pack_bitmap(self._host_query_hits(rows, eps)).view(np.int32)
            return torch.from_numpy(words).to(self.device)
        if self.mesh is not None:
            raise NotImplementedError("a sharded backend's packed rows are rank-local: "
                                      "use query_bitmap_device")
        _faults.maybe_fail(self._launch_site, op="hits")
        return self.query_bitmap_device(rows, eps)[0][: len(rows)]

    def query_hits_subset(self, rows: np.ndarray, cols: np.ndarray, eps: float) -> np.ndarray:
        assert self._data is not None, "call fit() first"
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if self.oracle:
            return self._host_query_hits_subset(rows, cols, eps)
        _faults.maybe_fail(self._launch_site, op="subset")
        t_lo, t_hi = self.band(eps)
        q, q_sig = self._gather(rows)
        db, db_sig = self._gather(cols)
        _, bitmap = sweep_bitmap(
            q, q_sig, db, db_sig, len(cols), eps, t_lo, t_hi, **self._sweep_kw()
        )
        return unpack_bitmap(bitmap, len(cols))

    def query_counts(self, rows: np.ndarray, eps: float) -> np.ndarray:
        """Counts without materializing a hit matrix: the count-only
        kernel on the sweep path, accept rows + verified band pairs on
        the host oracle."""
        assert self._data is not None, "call fit() first"
        rows = np.asarray(rows, dtype=np.int64)
        if self.oracle:
            return self._host_query_counts(rows, eps)
        _faults.maybe_fail(self._launch_site, op="counts")
        t_lo, t_hi = self.band(eps)
        q, q_sig = self._gather(rows)
        db, db_sig, plane = self._db()
        return sweep_counts(
            q, q_sig, db, db_sig, self.n_points, eps, t_lo, t_hi,
            db_tile=self.db_tile, **self._sweep_kw(), **plane,
        )


# ---------------------------------------------------------------------------
# margin auto-tune: price candidate Hamming bands with the kernel's
# occupancy counters (or the host Hamming sweep) and pick the widest
# band — best recall, ~Phi(margin) — the verify budget affords
# ---------------------------------------------------------------------------


def suggest_margin(
    backend: RandomProjectionBackend,
    eps: float,
    rows: Optional[np.ndarray] = None,
    *,
    margins=(4.0, 3.5, 3.0, 2.5, 2.0, 1.5, 1.0),
    max_band_frac: Optional[float] = None,
    report: bool = False,
):
    """Suggest an ``index_margin`` for a fitted backend at one eps.

    Recall of the dual-threshold contract is set by the band's upper
    edge, its cost by the exact-verify work on band pairs, so the
    question is the widest band whose band-pair fraction stays under
    ``max_band_frac`` (default: the backend's own).  Occupancy is
    measured on a deterministic row sample: through
    ``hamming_filter_count(..., return_stats=True)`` (the kernel's
    ``[accept, band, reject]`` counters) on the backend's device (under
    ``mesh=`` against each rank's row block, the triples summed over the
    ranks: every rank must call it), through one host Hamming sweep on
    the oracle.

    Returns the chosen margin, or ``(margin, rows)`` with the per-margin
    ``{margin, t_lo, t_hi, band_frac, accept_frac}`` table when
    ``report=True``.  If no candidate fits the budget the narrowest
    (cheapest) one is returned.
    """
    assert backend._data is not None, "call fit() first"
    if max_band_frac is None:
        max_band_frac = backend.max_band_frac
    n = backend._data.shape[0]
    if rows is None:
        rows = np.unique(np.linspace(0, n - 1, min(n, 4 * backend.q_tile)).astype(np.int64))
    rows = np.asarray(rows, dtype=np.int64)
    sigs = backend.signatures

    dev = not backend.oracle
    group = None
    if dev:
        q, q_sig = backend._gather(rows)
        db, db_sig, _ = backend._db()
        # the counters run on the reference's *padded* tile grid; pad rows
        # and cols are zero-signature pairs whose Hamming distance to a
        # real row is that row's popcount: classify and subtract them, so
        # the table prices real pairs only and agrees with the host table
        zero = np.zeros((1, sigs.shape[1]), np.uint32)
        q_pop = hamming_numpy(sigs[rows], zero)[:, 0].astype(np.int64)
        db_pop = hamming_numpy(sigs, zero)[:, 0].astype(np.int64)
        q_pad = (-len(rows)) % backend.q_tile
        db_pad = (-n) % backend.db_tile
        if backend.mesh is not None:
            # each rank counts against its tile-aligned row block and the
            # triples are summed over the ranks: the plane's zero rows
            # are the pad rows
            from ..distributed.sharding import plane_axes

            group = plane_axes(backend.mesh, backend._plan.axes).group
            db_pad = backend._plan.n_pad
    else:
        ham = hamming_numpy(sigs[rows], sigs)

    table = []
    for m in sorted(margins, reverse=True):
        t_lo, t_hi = hamming_band(eps, backend.n_bits, m)
        if backend.verify == "full":
            t_lo = -1
        if dev:
            _, stats = hamming_filter_count(
                q, db, q_sig, db_sig, eps, t_hi, t_lo=t_lo,
                q_tile=backend.q_tile, db_tile=backend.db_tile, return_stats=True,
            )
            if group is not None:
                from ..distributed.index_plane import plane_collective

                plane_collective("sum", stats, group)
            stats = stats.cpu().numpy().astype(np.int64).reshape(-1, 3).sum(axis=0)
            acc, bnd = int(stats[0]), int(stats[1])
            if q_pad or db_pad:
                # real q rows vs zero-padded db cols
                acc -= db_pad * int((q_pop <= t_lo).sum())
                bnd -= db_pad * int(((q_pop > t_lo) & (q_pop <= t_hi)).sum())
                # zero-padded q rows vs real db rows
                acc -= q_pad * int((db_pop <= t_lo).sum())
                bnd -= q_pad * int(((db_pop > t_lo) & (db_pop <= t_hi)).sum())
                # pad-vs-pad corner: Hamming distance 0
                if t_lo >= 0:
                    acc -= q_pad * db_pad
                else:
                    bnd -= q_pad * db_pad
            total = len(rows) * n
            acc_frac, band_frac = acc / total, bnd / total
        else:
            accept = ham <= t_lo
            band = (ham <= t_hi) & ~accept
            acc_frac = accept.mean()
            band_frac = band.mean()
        table.append(dict(margin=m, t_lo=t_lo, t_hi=t_hi,
                          band_frac=float(band_frac), accept_frac=float(acc_frac)))

    fits = [r for r in table if r["band_frac"] <= max_band_frac]
    chosen = fits[0]["margin"] if fits else table[-1]["margin"]
    chosen_row = next(r for r in table if r["margin"] == chosen)
    _feed_occupancy(chosen_row, len(rows), n)
    return (chosen, table) if report else chosen


def _feed_occupancy(row: dict, nq: int, n: int) -> None:
    """Write one occupancy measurement into the index.band.* metrics:
    raw pair counts (counters, accumulated over measurements) and the
    latest fractions (gauges)."""
    total = nq * n
    acc = int(round(row["accept_frac"] * total))
    bnd = int(round(row["band_frac"] * total))
    _metrics.counter("index.band.accept").inc(acc)
    _metrics.counter("index.band.band").inc(bnd)
    _metrics.counter("index.band.reject").inc(total - acc - bnd)
    _metrics.gauge("index.band.accept_frac").set(row["accept_frac"])
    _metrics.gauge("index.band.band_frac").set(row["band_frac"])
    _metrics.gauge("index.band.reject_frac").set(1.0 - row["accept_frac"] - row["band_frac"])


def record_occupancy(
    backend: RandomProjectionBackend, eps: float, rows: Optional[np.ndarray] = None
) -> dict:
    """Measure the dual-threshold occupancy of the backend's own band at
    one eps and feed the ``index.band.*`` metrics: :func:`suggest_margin`
    with the backend's configured margin as the single candidate.
    Returns the ``{margin, t_lo, t_hi, band_frac, accept_frac}`` row."""
    n = backend._data.shape[0]
    if rows is None:
        rows = np.unique(np.linspace(0, n - 1, min(n, 4 * backend.q_tile)).astype(np.int64))
    _, table = suggest_margin(
        backend, eps, rows, margins=(backend.margin,),
        max_band_frac=backend.max_band_frac, report=True,
    )
    return table[0]
