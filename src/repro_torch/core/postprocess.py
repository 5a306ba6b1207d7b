"""LAF post-processing — Algorithms 2 and 3 of the paper (numpy copy of
``repro.core.postprocess``).

``UpdatePartialNeighbors`` (Alg. 2): after every *executed* range query
(P, N), every neighbor P_n already registered in the partial-neighbor
map 𝓔 gains P as a partial neighbor.

``PostProcessing`` (Alg. 3): a registered point P with |𝓔(P)| ≥ τ is a
detected false-negative core prediction.  The clusters of its partial
neighbors were wrongly separated by P, so they are merged into one
destination cluster (that of a randomly selected non-noise member).  We
additionally assign P itself to the destination cluster — P is a proven
core point, and leaving it noise would contradict DBSCAN semantics; the
paper's published code does the same (merge implies membership).
Merging is transitive across rescue points; a union-find over cluster
ids realizes exactly the sequential chain of merges.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from .union_find import UnionFind

__all__ = ["PartialNeighborMap", "update_partial_neighbors", "post_processing"]

NOISE = -1
UNDEFINED = -2


class PartialNeighborMap:
    """The map 𝓔: predicted-stop point -> set of partial neighbors."""

    def __init__(self):
        self._map: Dict[int, Set[int]] = {}

    def register(self, p: int) -> None:
        """Lines 8 / 27 of Algorithm 1: ``if P not in 𝓔 then 𝓔(P) := ∅``."""
        self._map.setdefault(int(p), set())

    def __contains__(self, p: int) -> bool:
        return int(p) in self._map

    def __getitem__(self, p: int) -> Set[int]:
        return self._map[int(p)]

    def items(self):
        return self._map.items()

    def __len__(self):
        return len(self._map)


def update_partial_neighbors(p: int, neighbors, emap: PartialNeighborMap) -> PartialNeighborMap:
    """Algorithm 2, verbatim."""
    for pn in neighbors:
        pn = int(pn)
        if pn in emap:
            emap[pn].add(int(p))
    return emap


def post_processing(
    labels: np.ndarray,
    emap: PartialNeighborMap,
    tau: int,
    *,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Algorithm 3 with transitive merges via union-find.

    Returns updated labels (same id space; merged clusters collapse onto
    the destination's representative id).
    """
    rng = rng or np.random.default_rng(0)
    labels = labels.copy()
    n_clusters = int(labels.max()) + 1 if labels.max() >= 0 else 0
    if n_clusters == 0:
        return labels
    uf = UnionFind(n_clusters)
    rescued: List[tuple[int, int]] = []  # (point, destination cluster id)

    for p, partial in emap.items():
        if len(partial) < tau:
            continue
        members = np.fromiter(partial, dtype=np.int64)
        member_labels = labels[members]
        non_noise = member_labels[member_labels >= 0]
        if len(non_noise) == 0:
            continue
        # line 3: randomly select a non-noise neighbor P' in 𝓔(P)
        dest = int(rng.choice(non_noise))
        # line 5: merge the clusters of 𝓔(P) into the destination cluster
        for c in np.unique(non_noise):
            uf.union(dest, int(c))
        rescued.append((int(p), dest))

    remap = np.array([uf.find(c) for c in range(n_clusters)], dtype=np.int64)
    mask = labels >= 0
    labels[mask] = remap[labels[mask]]
    for p, dest in rescued:
        labels[p] = remap[dest]
    return labels
