"""Exact DBSCAN: faithful sequential transcription + batch-parallel
engine (port of ``repro.core.dbscan``).

``dbscan_sequential`` is the classic algorithm (Ester et al. 1996) as in
the black text of the paper's Algorithm 1: a host loop over neighbor
lists that the exact backend computes on the device.
``dbscan_parallel`` is the batch form the paper's evaluation uses as
ground truth:
   1. neighbor counts for ALL points (one range query each) -> core mask
   2. connected components of the core-core eps-graph -> cluster ids
      (one vectorized star union per core row)
   3. border points join the cluster of their first (lowest-index) core
      finder.
Both return labels with the same convention: -1 noise, clusters 0..k-1.
On the exact backend the range queries run through the ``range_count``
kernel on the backend's device.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..obs.metrics import PhaseClock
from .range_query import neighbor_lists, range_counts
from .union_find import compact_labels_from_parent, union_star

__all__ = [
    "DBSCANResult", "dbscan_sequential", "dbscan_parallel", "core_mask", "cluster_cores", "NOISE", "UNDEFINED",
]

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


def dbscan_sequential(
    data: np.ndarray, eps: float, tau: int, *, precomputed_neighbors=None, device=None
) -> DBSCANResult:
    """Classic DBSCAN (the black text of the paper's Algorithm 1).

    Every point is range-queried exactly once, so the neighbor lists are
    computed up front (``precomputed_neighbors``, else ``neighbor_lists``
    on the exact backend: the ``range_count`` kernel on ``device``,
    ``None`` = cuda) and the loop reads them; ``n_range_queries`` counts
    the reads, as the reference counts its queries.
    """
    data = np.asarray(data, dtype=np.float32)
    n = data.shape[0]
    neigh = precomputed_neighbors
    if neigh is None:
        neigh = neighbor_lists(data, eps, device=device)
    queries = 0

    def range_query(i: int) -> np.ndarray:
        nonlocal queries
        queries += 1
        return neigh[i]

    labels = np.full(n, UNDEFINED, dtype=np.int64)
    core = np.zeros(n, dtype=bool)
    c = 0
    for p in range(n):
        if labels[p] != UNDEFINED:
            continue
        nbrs = range_query(p)
        if len(nbrs) < tau:
            labels[p] = NOISE
            continue
        core[p] = True
        labels[p] = c
        seeds = deque(int(q) for q in nbrs if q != p)
        while seeds:
            q = seeds.popleft()
            if labels[q] == NOISE:
                labels[q] = c  # noise -> border
            if labels[q] != UNDEFINED:
                continue
            labels[q] = c
            qn = range_query(q)
            if len(qn) >= tau:
                core[q] = True
                seeds.extend(int(x) for x in qn)
        c += 1
    return DBSCANResult(labels, core, c, queries)


def core_mask(data: np.ndarray, eps: float, tau: int, block_size: int = 2048, *, device=None) -> np.ndarray:
    """Core points of ``data``: exact neighbor count >= tau."""
    counts = range_counts(data, data, eps, block_size=block_size, device=device)
    return counts.cpu().numpy() >= tau


def cluster_cores(bk, core: np.ndarray, eps: float, block_size: int, *, conn_eps=None):
    """Steps 2-3 of ``dbscan_parallel`` over a given core mask: a star
    union per core row over its core hits, then each border point joins
    its first (lowest-index) core finder, ``block_size`` core rows a
    query.  ``conn_eps`` (default ``eps``) is the radius of the core-core
    edges (rho-approximate DBSCAN's relaxed connectivity); the border
    claims stay at ``eps``.  Returns (labels, host reads: one per
    ``query_hits``)."""
    n = len(core)
    core_idx = np.nonzero(core)[0]
    parent = np.arange(n, dtype=np.int64)
    owner = np.full(n, -1, dtype=np.int64)  # first core finder per column
    reads = 0
    for start in range(0, len(core_idx), block_size):
        rows = core_idx[start : start + block_size]
        hit = bk.query_hits(rows, eps)  # (b, n)
        conn = hit if conn_eps is None else bk.query_hits(rows, conn_eps)
        reads += 1 if conn_eps is None else 2
        hit_core = conn & core[None, :]
        for bi in range(len(rows)):
            union_star(parent, np.nonzero(hit_core[bi])[0])
        # border claim: first core row in this block to hit an unclaimed col
        claimed = hit.any(axis=0)
        todo = claimed & (owner < 0) & ~core
        if todo.any():
            first = hit[:, todo].argmax(axis=0)
            owner[todo] = rows[first]

    labels = compact_labels_from_parent(parent, core)
    borders = np.nonzero(~core & (owner >= 0))[0]
    labels[borders] = labels[owner[borders]]
    return labels, reads


def dbscan_parallel(
    data: np.ndarray,
    eps: float,
    tau: int,
    *,
    block_size: int = 2048,
    backend="exact",
    device=None,
) -> DBSCANResult:
    """Batch-parallel DBSCAN (blocked core detection + star unions).

    ``backend`` selects the range-query engine (``repro_torch.index``):
    the default ``"exact"`` is brute-force DBSCAN.  ``device`` is the
    torch device of a backend built from a name (``None`` = cuda,
    raising without a card); a constructed instance keeps its own.
    Phase times go to the ``dbscan.phase.*`` gauges.
    """
    from ..index import as_fitted

    data = np.asarray(data, dtype=np.float32)
    n = data.shape[0]
    clock = PhaseClock.for_engine(backend, device)
    bk = as_fitted(backend, data, block_size=block_size, device=device)
    clock.mark("fit_index")
    counts = bk.query_counts(np.arange(n), eps)
    core = counts >= tau
    clock.mark("core_counts")
    labels, _ = cluster_cores(bk, core, eps, block_size)
    clock.mark("components")
    clock.publish("dbscan.phase")
    n_clusters = int(labels.max()) + 1 if labels.max() >= 0 else 0
    return DBSCANResult(labels, core, n_clusters, n)
