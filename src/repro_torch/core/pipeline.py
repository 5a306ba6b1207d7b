"""End-to-end LAF pipeline (port of ``repro.core.pipeline``, LAF-DBSCAN
engine): train the estimator on the 80% split, cluster the 20% split,
with the paper's timing discipline — prediction time counts, training
time does not (§3.1 Metrics).
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
from .dbscan import DBSCANResult
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
    """Owns a trained cardinality estimator + the LAF-DBSCAN engine.

    ``backend`` is the range-query backend (registry name or constructed
    instance); ``device`` the torch device (``None`` = cuda, raising
    without a card; ``"cpu"`` runs every kernel's plain version);
    ``cluster_device`` routes cluster formation (see ``laf_dbscan``).
    """

    def __init__(
        self,
        *,
        eps_grid=None,
        epochs: int = 200,
        batch_size: int = 512,
        lr: float = 1e-3,
        seed: int = 0,
        backend="random_projection",
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

    def cluster_laf_dbscan(
        self, vectors: np.ndarray, eps: float, tau: int, alpha: float, **kw
    ) -> ClusterOutcome:
        """LAF-DBSCAN of ``vectors``; ``elapsed_s`` spans prediction and
        clustering and ends with the labels on the host, so host clock
        readings are synced ones."""
        kw.setdefault("backend", self.backend)
        kw.setdefault("device", self.device)
        kw.setdefault("cluster_device", self.cluster_device)
        t0 = time.perf_counter()
        pred = self.predict_counts(vectors, eps)  # host array: synced
        t1 = time.perf_counter()
        res = laf_dbscan(vectors, eps, tau, alpha, pred, seed=self.seed, **kw)
        t2 = time.perf_counter()
        _metrics.gauge("laf.phase.predict_s").set(t1 - t0)
        return ClusterOutcome(res, t2 - t0, t1 - t0, "LAF-DBSCAN",
                              {"eps": eps, "tau": tau, "alpha": alpha})
