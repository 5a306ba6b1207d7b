"""Streaming LAF-DBSCAN: the batch ingest driver (port of
``repro.stream.ingest``).

``StreamingLAF`` owns a range-query backend (``repro_torch.index``) and a
:class:`~repro_torch.stream.state.StreamingClusterState`, and turns
embedding batches into maintained clusters:

1. ``backend.partial_fit(batch)`` appends the rows (and, on the RP
   backend, their signatures) in place on the device;
2. **only the new rows** are ranged against the database; old points'
   counts are bumped from the transposed hits, so a point crossing tau
   *promotes* to core and merges clusters without recomputing an old
   edge;
3. the optional estimator fast path: new rows predicted below
   ``alpha * tau`` skip their full range query (verified against the
   current core set only, ``query_hits_subset``) and promote later if
   their partial count crosses tau;
4. a ``decay`` hook can evict rows per batch; an eviction that demotes
   or kills a core point triggers a rebuild (``stream.rebuilds``).

On a backend that packs natively (the RP sweep engine) every block's
adjacency stays packed on the device: the sweep's slab
(``query_packed_device``) feeds the counts and bumps
(``ingest_rows_packed``), a promotion's re-query
(``promote_packed``) and the connectivity replay
(``apply_core_rows_packed``, ``packed_connectivity``), each with one host
read of its small results.  Every device-to-host read is counted as
``stream.ingest.host_syncs``: one a sweep block, one a promotion block,
one a connectivity block, where the reference reads a sweep block's
packed words, twice a promotion block and once a connectivity block.
Host backends (the exact backend, ``oracle=True``) take the boolean
path, one read a query block.

With the estimator off the maintained partition is **identical** to a
from-scratch batch run on the accumulated data.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..configs.laf_dbscan import StreamConfig
from ..core.range_query import pack_bitmap, unpack_bitmap
from ..index.base import RangeBackend, make_backend
from ..obs import get_logger, rate_limited_warn
from ..obs import metrics as _metrics
from ..obs import slo as _slo
from ..obs import span as _span
from .state import HOST_SYNCS, StreamingClusterState

__all__ = ["StreamingLAF", "IngestReport"]


@dataclass
class IngestReport:
    """Per-batch accounting (the streaming analog of ``DBSCANResult.extras``)."""

    n_new: int
    n_executed: int          # new rows that paid a full range query
    n_skipped: int           # new rows on the estimator fast path
    n_promoted: int          # old/skipped points that crossed tau this batch
    n_points: int            # database size after the batch
    n_clusters: int
    elapsed_s: float
    rebuilt: bool = False
    extras: dict = field(default_factory=dict)


def _host_read() -> None:
    _metrics.counter(HOST_SYNCS).inc()


class StreamingLAF:
    """Incremental LAF-DBSCAN over an append-mostly embedding stream.

    Args:
      eps, tau: the DBSCAN operating point (fixed per stream).
      backend: a registry name (a fresh instance on ``device``) or a
        constructed ``RangeBackend``, which keeps its own configuration
        (passing index kwargs or ``device`` beside one is an error).  A
        *pre-fitted* instance warm-starts the stream: its rows are
        absorbed as batch zero.
      device: torch device of a backend built from a name: ``None`` is
        cuda (raising without a card), ``"cpu"`` runs the plain versions.
      estimator: optional cardinality estimator for the fast path, a
        ``TrainedEstimator`` or a callable ``(vectors) -> counts``.
      config: a ``configs.laf_dbscan.StreamConfig`` of defaults for the
        remaining knobs; explicit kwargs win.
      decay: optional per-batch eviction hook ``(state) -> indices``.
    """

    def __init__(
        self,
        eps: float,
        tau: int,
        *,
        backend="random_projection",
        device=None,
        estimator=None,
        config: Optional[StreamConfig] = None,
        alpha: Optional[float] = None,
        use_estimator: Optional[bool] = None,
        block_size: Optional[int] = None,
        decay: Optional[Callable] = None,
        max_dead_frac: Optional[float] = None,
        **backend_kwargs,
    ):
        cfg = config or StreamConfig()
        self.eps = float(eps)
        self.tau = int(tau)
        self.alpha = cfg.alpha if alpha is None else float(alpha)
        self.use_estimator = cfg.use_estimator if use_estimator is None else bool(use_estimator)
        self.block_size = cfg.batch_rows if block_size is None else block_size
        self.decay = decay
        self.max_dead_frac = cfg.max_dead_frac if max_dead_frac is None else max_dead_frac
        self.config = cfg
        self.estimator = estimator
        if isinstance(backend, RangeBackend):
            dropped = sorted(backend_kwargs) + (["device"] if device is not None else [])
            if dropped:
                raise ValueError(
                    f"backend is a constructed instance; index kwargs {dropped} "
                    f"would be ignored — configure the instance instead, or "
                    f"pass the registry name"
                )
            self.backend = backend
        else:
            self.backend = make_backend(backend, block_size=self.block_size, device=device, **backend_kwargs)
        self.state = StreamingClusterState(eps, tau)
        self._serve = None  # ClusterIndex snapshot, keyed on state.version
        if getattr(self.backend, "_data", None) is not None and self.backend.n_points:
            # warm start from a pre-fitted index: absorb its rows so state
            # indices stay aligned with backend rows
            self._absorb(np.ascontiguousarray(self.backend.data))

    # -- estimator glue ----------------------------------------------------
    def _predict(self, vectors: np.ndarray) -> Optional[np.ndarray]:
        if self.estimator is None or not self.use_estimator:
            return None
        if hasattr(self.estimator, "predict_counts"):
            return np.asarray(self.estimator.predict_counts(vectors, self.eps))
        return np.asarray(self.estimator(vectors))

    # -- ingest ------------------------------------------------------------
    def partial_fit(self, batch: np.ndarray) -> IngestReport:
        """Absorb one embedding batch; returns the batch report."""
        batch = np.ascontiguousarray(batch, dtype=np.float32)
        if batch.ndim != 2 or batch.shape[0] == 0:
            raise ValueError(f"batch must be (rows, d) with rows >= 1, got {batch.shape}")
        # forced span, synced on the backend's device rows: the append
        # enqueues device copies, so the batch time waits for them
        with _span("ingest.batch", rows=batch.shape[0], n=self.state.n, force=True) as batch_sp:
            with _span("ingest.append", rows=batch.shape[0]):
                self.backend.partial_fit(batch)
            rep = self._absorb(batch)
            rebuilt = False
            if self.decay is not None:
                idx = self.decay(self.state)
                if idx is not None and len(idx):
                    rebuilt = self.evict(idx)
            batch_sp.sync_on(self.backend.data_device)
        rep.rebuilt = rebuilt
        rep.elapsed_s = batch_sp.dur
        rep.n_points = self.state.n
        rep.n_clusters = self.state.n_clusters
        if _metrics.enabled():
            _slo.check_and_alert(
                _slo.INGEST_SLOS, values={"ingest.skip_rate": rep.n_skipped / max(rep.n_new, 1)}
            )
        return rep

    def _absorb(self, batch: np.ndarray) -> IngestReport:
        """Cluster-maintenance pass for rows the backend already holds."""
        state, bk, eps = self.state, self.backend, self.eps
        pre_core = np.nonzero(state.core[: state.n] & state.alive[: state.n])[0]
        new_idx = state.extend(batch.shape[0])

        pred = self._predict(batch)
        exec_mask = np.ones(len(new_idx), dtype=bool) if pred is None else pred >= self.alpha * self.tau
        skip_idx = new_idx[~exec_mask]
        _metrics.counter("stream.ingest.skipped").inc(int(len(skip_idx)))
        if len(skip_idx):
            # fast path: skipped rows against the core set only
            with _span("ingest.fastpath", rows=len(skip_idx), cores=len(pre_core)):
                if len(pre_core):
                    hit_cores = bk.query_hits_subset(skip_idx, pre_core, eps)
                    _host_read()
                else:
                    hit_cores = np.zeros((len(skip_idx), 0), dtype=bool)
                state.seed_skipped(skip_idx, pre_core, hit_cores)

        exec_idx = new_idx[exec_mask]
        _metrics.counter("stream.ingest.executed").inc(int(len(exec_idx)))
        packed = []
        native = bool(bk.packs_natively)
        with _span("ingest.sweep", rows=len(exec_idx), native=native):
            for start in range(0, len(exec_idx), self.block_size):
                rows = exec_idx[start : start + self.block_size]
                # the whole executed set is excluded from the transposed
                # bumps: a same-batch pair split over two blocks would
                # otherwise count twice for the earlier block's endpoint
                if native:
                    pk = bk.query_packed_device(rows, eps)
                    state.ingest_rows_packed(rows, pk, exclude=exec_idx)
                else:
                    hit = bk.query_hits(rows, eps)
                    _host_read()
                    pk = pack_bitmap(hit)
                    state.ingest_rows(rows, hit, exclude=exec_idx)
                packed.append((rows, pk))

        # one promotion round closes the core set: new executed rows are
        # core straight from their counts; old/skipped points crossing tau
        # are re-queried for their exact counts and core-core edges
        promoted = state.take_promotions()
        requery = promoted[~np.isin(promoted, exec_idx, assume_unique=True)]
        _metrics.counter("stream.ingest.promoted").inc(int(len(requery)))
        _metrics.counter("stream.ingest.skipped_promoted").inc(
            int(np.isin(requery, skip_idx, assume_unique=True).sum())
        )
        with _span("ingest.promote", rows=len(requery), native=native):
            for start in range(0, len(requery), self.block_size):
                rows = requery[start : start + self.block_size]
                if native:
                    state.promote_packed(rows, bk.query_packed_device(rows, eps))
                else:
                    hit = bk.query_hits(rows, eps)
                    _host_read()
                    state.promote(rows, hit)
        # connectivity replay: on the native path each block's slab goes
        # through packed_connectivity on the device, never unpacked
        with _span("ingest.apply", blocks=len(packed), native=native):
            for rows, pk in packed:
                if native:
                    state.apply_core_rows_packed(rows, pk)
                else:
                    state.apply_core_rows(rows, unpack_bitmap(pk, state.n))

        self._serve = None
        return IngestReport(
            n_new=len(new_idx),
            n_executed=len(exec_idx),
            n_skipped=len(skip_idx),
            n_promoted=len(requery),
            n_points=state.n,
            n_clusters=-1,  # filled by partial_fit after decay runs
            elapsed_s=0.0,
        )

    # -- deletion ----------------------------------------------------------
    def evict(self, idx: np.ndarray) -> bool:
        """Tombstone rows; rebuilds when required.  Returns True iff a
        rebuild happened (a core died or was demoted, or tombstones piled
        past ``max_dead_frac``)."""
        idx = np.asarray(idx, dtype=np.int64)
        hit = self.backend.query_hits(idx, self.eps)
        _host_read()
        need = self.state.evict(idx, hit)
        state = self.state
        if need or state.n_dead > self.max_dead_frac * max(state.n, 1):
            self.rebuild(reason="core_death" if need else "tombstone_frac")
            return True
        self._serve = None
        return False

    def rebuild(self, reason: str = "manual") -> None:
        """Compact tombstones away: refit the backend on the live rows and
        replay them through the exact ingest path in one batch.  Counted
        in ``stream.rebuilds`` and ``stream.rebuilds.<reason>``, with a
        rate-limited structured warn."""
        _metrics.counter("stream.rebuilds").inc()
        _metrics.counter(f"stream.rebuilds.{reason}").inc()
        rate_limited_warn(
            get_logger("stream"), "stream.rebuild", "stream.rebuild",
            reason=reason, n=self.state.n, n_dead=self.state.n_dead, version=self.state.version,
        )
        live = np.nonzero(self.state.alive[: self.state.n])[0]
        data = np.ascontiguousarray(self.backend.data[live])
        self.backend.fit(data)
        self.state = StreamingClusterState(self.eps, self.tau)
        self._serve = None
        if len(data):
            est, self.use_estimator = self.use_estimator, False
            try:
                self._absorb(data)
            finally:
                self.use_estimator = est

    # -- serving -----------------------------------------------------------
    def snapshot(self):
        """Current :class:`~repro_torch.stream.serve.ClusterIndex` (cached
        per state version; ingest invalidates it)."""
        from .serve import ClusterIndex

        if self._serve is None or self._serve.version != self.state.version:
            self._serve = ClusterIndex.from_stream(self)
        return self._serve

    def assign(self, queries: np.ndarray, **kw):
        """Serving-grade assignment of unseen vectors (see
        :meth:`repro_torch.stream.serve.ClusterIndex.assign`)."""
        kw.setdefault("shortlist", self.config.shortlist)
        kw.setdefault("min_hits", self.config.min_hits)
        return self.snapshot().assign(queries, **kw)

    # -- views -------------------------------------------------------------
    def labels(self) -> np.ndarray:
        return self.state.labels()

    @property
    def n_points(self) -> int:
        return self.state.n

    @property
    def n_clusters(self) -> int:
        return self.state.n_clusters
