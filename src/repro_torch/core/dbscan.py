"""DBSCAN result container and label conventions (port of the
``DBSCANResult`` / ``NOISE`` / ``UNDEFINED`` part of ``repro.core.dbscan``):
-1 noise, clusters 0..k-1."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["DBSCANResult", "NOISE", "UNDEFINED"]

UNDEFINED = -2
NOISE = -1


@dataclass
class DBSCANResult:
    labels: np.ndarray          # (n,) int64: -1 noise, else cluster id
    core: np.ndarray            # (n,) bool
    n_clusters: int
    n_range_queries: int        # executed range queries (the paper's cost unit)
    extras: dict = field(default_factory=dict)

    @property
    def noise_ratio(self) -> float:
        return float(np.mean(self.labels == NOISE))
