"""End-to-end LAF pipeline (port of ``repro.core.pipeline``): train the
estimator on the 80% split, cluster the 20% split with DBSCAN,
LAF-DBSCAN, DBSCAN++ or LAF-DBSCAN++, with the paper's timing
discipline — prediction time counts, training time does not (§3.1
Metrics).  ``elapsed_s`` and ``predict_s`` are the durations of the
reference's forced spans (``laf.run`` ⊃ ``laf.predict``, ``dbscan.run``,
``dbscanpp.run``): measured whether or not tracing is on, recorded in the
trace when it is, and each synced on its outputs before it closes, so
they include all device work.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from .. import resolve_device
from ..data.synthetic import train_test_split
from ..obs import metrics as _metrics
from ..obs import span as _span
from .cardinality import TrainedEstimator, train_rmi
from .dbscan import DBSCANResult, dbscan_parallel
from .dbscan_pp import auto_sample_fraction, dbscan_pp, laf_dbscan_pp
from .laf_dbscan import laf_dbscan

__all__ = ["LAFPipeline", "ClusterOutcome"]


@dataclass
class ClusterOutcome:
    result: DBSCANResult
    elapsed_s: float               # clustering time incl. estimator predict
    predict_s: float = 0.0         # estimator prediction share
    method: str = ""
    params: Dict = field(default_factory=dict)


class LAFPipeline:
    """Owns a trained cardinality estimator + the clustering engines.

    ``backend`` is the range-query backend of every method (registry
    name or constructed instance; ``"exact"`` by default, per-call
    ``backend=`` overrides it); ``device`` the torch device (``None`` =
    cuda, raising without a card; ``"cpu"`` runs every kernel's plain
    version); ``cluster_device`` routes LAF-DBSCAN's cluster formation
    (see ``laf_dbscan``).
    """

    def __init__(
        self,
        *,
        eps_grid=None,
        epochs: int = 200,
        batch_size: int = 512,
        lr: float = 1e-3,
        seed: int = 0,
        backend="exact",
        device=None,
        cluster_device="auto",
    ):
        self.eps_grid = eps_grid
        self.epochs = epochs
        self.batch_size = batch_size
        self.lr = lr
        self.seed = seed
        self.backend = backend
        self.device = resolve_device(device)
        self.cluster_device = cluster_device
        self.estimator: Optional[TrainedEstimator] = None
        self._stream = None

    def fit(self, train_vectors: np.ndarray) -> "LAFPipeline":
        self.estimator = train_rmi(
            train_vectors,
            eps_grid=self.eps_grid,
            epochs=self.epochs,
            batch_size=self.batch_size,
            lr=self.lr,
            seed=self.seed,
            device=self.device,
        )
        return self

    def fit_split(self, data: np.ndarray, frac_train: float = 0.8):
        """Paper protocol: 8:2 split; returns the test split to cluster."""
        train, test = train_test_split(data, frac_train, self.seed)
        self.fit(train)
        return test

    def predict_counts(self, vectors: np.ndarray, eps: float) -> np.ndarray:
        if self.estimator is None:
            raise RuntimeError("call fit() first")
        return self.estimator.predict_counts(vectors, eps)

    # -- streaming (repro_torch.stream) ------------------------------------
    @property
    def stream(self):
        """The live ``StreamingLAF`` (None until the first ``partial_fit``)."""
        return self._stream

    def partial_fit(self, batch: np.ndarray, *, eps: float = None, tau: int = None, **kw):
        """Ingest an embedding batch into the maintained online clustering.

        The first call fixes the (eps, tau) operating point and builds a
        ``repro_torch.stream.StreamingLAF`` on this pipeline's backend and
        device; a trained estimator (from ``fit``) is wired in as the
        ingest fast path (``use_estimator=False`` forces the exact path).
        Later calls stream batches in; changing eps/tau mid-stream raises.
        Returns the batch's ``IngestReport``.
        """
        if self._stream is None:
            if eps is None or tau is None:
                raise ValueError("the first partial_fit must fix eps= and tau=")
            from ..index.base import RangeBackend
            from ..stream import StreamingLAF

            if self.estimator is not None:
                kw.setdefault("estimator", self.estimator)
                kw.setdefault("use_estimator", True)
            kw.setdefault("backend", self.backend)
            if not isinstance(kw["backend"], RangeBackend):
                # a constructed instance keeps its own device; only
                # registry names take the pipeline's
                kw.setdefault("device", self.device)
            self._stream = StreamingLAF(eps, tau, **kw)
            return self._stream.partial_fit(batch)
        if (eps is not None and eps != self._stream.eps) or (tau is not None and tau != self._stream.tau):
            raise ValueError(
                f"stream is live at eps={self._stream.eps}, tau={self._stream.tau}; "
                f"got eps={eps}, tau={tau} — the maintained counts are "
                f"operating-point-specific (start a new pipeline/stream to change)"
            )
        if kw:
            raise ValueError(
                f"stream is live; constructor kwargs {sorted(kw)} cannot be "
                f"applied after the first partial_fit"
            )
        return self._stream.partial_fit(batch)

    def assign(self, queries: np.ndarray, **kw):
        """Serving API: cluster ids + confidence for unseen vectors
        against the streamed clustering (``repro_torch.stream.serve``)."""
        if self._stream is None:
            raise RuntimeError("call partial_fit() first")
        return self._stream.assign(queries, **kw)

    def _engine_kw(self, kw) -> dict:
        kw.setdefault("backend", self.backend)
        kw.setdefault("device", self.device)
        return kw

    def cluster_laf_dbscan(
        self, vectors: np.ndarray, eps: float, tau: int, alpha: float, **kw
    ) -> ClusterOutcome:
        """LAF-DBSCAN of ``vectors``; ``elapsed_s`` spans prediction and
        clustering (the ``laf.run`` span), ``predict_s`` the prediction
        (``laf.predict``)."""
        kw = self._engine_kw(kw)
        kw.setdefault("cluster_device", self.cluster_device)
        with _span("laf.run", n=len(vectors), eps=float(eps), tau=int(tau), force=True) as run:
            with _span("laf.predict", n=len(vectors), force=True) as pre:
                pred = self.predict_counts(vectors, eps)
                pre.sync_on(pred)
            res = laf_dbscan(vectors, eps, tau, alpha, pred, seed=self.seed, **kw)
            run.sync_on((res.labels, res.core))
        _metrics.gauge("laf.phase.predict_s").set(pre.dur)
        return ClusterOutcome(res, run.dur, pre.dur, "LAF-DBSCAN",
                              {"eps": eps, "tau": tau, "alpha": alpha})

    def cluster_dbscan(self, vectors: np.ndarray, eps: float, tau: int, **kw) -> ClusterOutcome:
        """Exact DBSCAN (``dbscan_parallel``), the paper's ground truth."""
        kw = self._engine_kw(kw)
        with _span("dbscan.run", n=len(vectors), force=True) as run:
            res = dbscan_parallel(vectors, eps, tau, **kw)
            run.sync_on((res.labels, res.core))
        return ClusterOutcome(res, run.dur, 0.0, "DBSCAN", {"eps": eps, "tau": tau})

    def cluster_dbscan_pp(
        self, vectors: np.ndarray, eps: float, tau: int,
        *, delta: float = 0.2, alpha: float = 1.0, p: Optional[float] = None, **kw
    ) -> ClusterOutcome:
        """DBSCAN++; without ``p`` the estimator sets it (p = delta + R_c)."""
        kw = self._engine_kw(kw)
        with _span("dbscanpp.run", n=len(vectors), force=True) as run:
            if p is None:
                p = auto_sample_fraction(self.predict_counts(vectors, eps), tau, alpha, delta)
            res = dbscan_pp(vectors, eps, tau, p, seed=self.seed, **kw)
            run.sync_on((res.labels, res.core))
        return ClusterOutcome(res, run.dur, 0.0, "DBSCAN++", {"eps": eps, "tau": tau, "p": p})

    def cluster_laf_dbscan_pp(
        self, vectors: np.ndarray, eps: float, tau: int,
        *, delta: float = 0.2, alpha: float = 1.0, p: Optional[float] = None, **kw
    ) -> ClusterOutcome:
        """LAF-DBSCAN++ over a uniform sample drawn as ``dbscan_pp`` draws
        it; prediction and sampling count in ``predict_s``."""
        kw = self._engine_kw(kw)
        with _span("laf.run", n=len(vectors), force=True) as run:
            with _span("laf.predict", n=len(vectors), force=True) as pre:
                pred_all = self.predict_counts(vectors, eps)
                if p is None:
                    p = auto_sample_fraction(pred_all, tau, alpha, delta)
                n = vectors.shape[0]
                m = max(1, int(round(p * n)))
                rng = np.random.default_rng(self.seed)
                sample_idx = np.sort(rng.choice(n, size=m, replace=False))
                pre.sync_on(pred_all)
            res = laf_dbscan_pp(
                vectors, eps, tau, p, pred_all[sample_idx],
                alpha=alpha, seed=self.seed, sample_idx=sample_idx, **kw
            )
            run.sync_on((res.labels, res.core))
        return ClusterOutcome(res, run.dur, pre.dur, "LAF-DBSCAN++",
                              {"eps": eps, "tau": tau, "p": p, "alpha": alpha})
