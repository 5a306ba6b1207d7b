"""End-to-end LAF pipeline (port of ``repro.core.pipeline``): train the
estimator on the 80% split, cluster the 20% split with DBSCAN,
LAF-DBSCAN, DBSCAN++ or LAF-DBSCAN++, with the paper's timing
discipline — prediction time counts, training time does not (§3.1
Metrics).  Every ``elapsed_s`` is a host clock reading that ends with
the labels on the host, so it includes all device work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from .. import resolve_device
from ..data.synthetic import train_test_split
from ..obs import metrics as _metrics
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

    def _engine_kw(self, kw) -> dict:
        kw.setdefault("backend", self.backend)
        kw.setdefault("device", self.device)
        return kw

    def cluster_laf_dbscan(
        self, vectors: np.ndarray, eps: float, tau: int, alpha: float, **kw
    ) -> ClusterOutcome:
        """LAF-DBSCAN of ``vectors``; ``elapsed_s`` spans prediction and
        clustering and ends with the labels on the host, so host clock
        readings are synced ones."""
        kw = self._engine_kw(kw)
        kw.setdefault("cluster_device", self.cluster_device)
        t0 = time.perf_counter()
        pred = self.predict_counts(vectors, eps)  # host array: synced
        t1 = time.perf_counter()
        res = laf_dbscan(vectors, eps, tau, alpha, pred, seed=self.seed, **kw)
        t2 = time.perf_counter()
        _metrics.gauge("laf.phase.predict_s").set(t1 - t0)
        return ClusterOutcome(res, t2 - t0, t1 - t0, "LAF-DBSCAN",
                              {"eps": eps, "tau": tau, "alpha": alpha})

    def cluster_dbscan(self, vectors: np.ndarray, eps: float, tau: int, **kw) -> ClusterOutcome:
        """Exact DBSCAN (``dbscan_parallel``), the paper's ground truth."""
        kw = self._engine_kw(kw)
        t0 = time.perf_counter()
        res = dbscan_parallel(vectors, eps, tau, **kw)
        return ClusterOutcome(res, time.perf_counter() - t0, 0.0, "DBSCAN",
                              {"eps": eps, "tau": tau})

    def cluster_dbscan_pp(
        self, vectors: np.ndarray, eps: float, tau: int,
        *, delta: float = 0.2, alpha: float = 1.0, p: Optional[float] = None, **kw
    ) -> ClusterOutcome:
        """DBSCAN++; without ``p`` the estimator sets it (p = delta + R_c)."""
        kw = self._engine_kw(kw)
        t0 = time.perf_counter()
        if p is None:
            p = auto_sample_fraction(self.predict_counts(vectors, eps), tau, alpha, delta)
        res = dbscan_pp(vectors, eps, tau, p, seed=self.seed, **kw)
        return ClusterOutcome(res, time.perf_counter() - t0, 0.0, "DBSCAN++",
                              {"eps": eps, "tau": tau, "p": p})

    def cluster_laf_dbscan_pp(
        self, vectors: np.ndarray, eps: float, tau: int,
        *, delta: float = 0.2, alpha: float = 1.0, p: Optional[float] = None, **kw
    ) -> ClusterOutcome:
        """LAF-DBSCAN++ over a uniform sample drawn as ``dbscan_pp`` draws
        it; prediction and sampling count in ``predict_s``."""
        kw = self._engine_kw(kw)
        t0 = time.perf_counter()
        pred_all = self.predict_counts(vectors, eps)
        if p is None:
            p = auto_sample_fraction(pred_all, tau, alpha, delta)
        n = vectors.shape[0]
        m = max(1, int(round(p * n)))
        rng = np.random.default_rng(self.seed)
        sample_idx = np.sort(rng.choice(n, size=m, replace=False))
        t1 = time.perf_counter()
        res = laf_dbscan_pp(
            vectors, eps, tau, p, pred_all[sample_idx],
            alpha=alpha, seed=self.seed, sample_idx=sample_idx, **kw
        )
        return ClusterOutcome(res, time.perf_counter() - t0, t1 - t0, "LAF-DBSCAN++",
                              {"eps": eps, "tau": tau, "p": p, "alpha": alpha})
