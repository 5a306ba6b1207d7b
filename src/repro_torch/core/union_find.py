"""Host union-find for cluster formation (port of the host half of
``repro.core.union_find``; numpy only).

``union_star`` / ``compact_labels_from_parent`` are the host cluster
pass of ``laf_dbscan`` (the parity oracle of the device pass), and
``UnionFind`` carries the post-processing merges.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "UnionFind",
    "find_roots_vec",
    "union_star",
    "compact_labels",
    "compact_labels_from_parent",
]


def compact_labels(labels: np.ndarray) -> np.ndarray:
    """Renumber non-negative labels to 0..k-1 (order-preserving), one
    ``np.unique`` pass; negative labels (noise) are kept as-is."""
    out = labels.copy()
    pos = labels >= 0
    if pos.any():
        _, inv = np.unique(labels[pos], return_inverse=True)
        out[pos] = inv
    return out


def find_roots_vec(parent: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """Vectorized multi-find with path halving over a parent array.

    Loops only graph-depth times (tiny under constant compression) with
    full-vector numpy ops — no per-element Python.
    """
    roots = np.asarray(nodes, dtype=np.int64)
    while True:
        p = parent[roots]
        gp = parent[p]
        parent[roots] = gp  # path halving
        if np.array_equal(p, gp):
            return p
        roots = gp


def union_star(parent: np.ndarray, members: np.ndarray) -> None:
    """Union all ``members`` into one component (vectorized star union)."""
    if len(members) == 0:
        return
    roots = find_roots_vec(parent, members)
    m = roots.min()
    parent[roots] = m


def compact_labels_from_parent(
    parent: np.ndarray, active: np.ndarray
) -> np.ndarray:
    """-1 for inactive nodes; components renumbered 0..k-1 by smallest member."""
    n = len(parent)
    labels = np.full(n, -1, dtype=np.int64)
    idx = np.nonzero(active)[0]
    if len(idx) == 0:
        return labels
    roots = find_roots_vec(parent, idx)
    uniq, inv = np.unique(roots, return_inverse=True)
    labels[idx] = inv
    return labels


class UnionFind:
    """Array-based union-find with path halving + union by size.

    ``grow`` extends the element universe in place (new elements start
    as singletons; existing components and their roots are untouched),
    which is what lets the streaming cluster state add points without
    rebuilding the forest.  ``parent`` is a plain array, so the
    vectorized helpers above (``find_roots_vec`` / ``union_star``)
    compose with it — they union by min root rather than by size, which
    path halving tolerates (any forest stays a valid forest).
    """

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.size = np.ones(n, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.parent)

    def grow(self, n: int) -> None:
        """Extend to ``n`` elements; no-op when already that large.

        Amortized O(new elements): ``parent``/``size`` become views into
        doubling capacity buffers, so per-batch growth in the streaming
        state never recopies the whole forest.  The buffer tails are
        pre-initialized to identity parents / unit sizes and nothing
        ever writes past the logical length (unions and path halving
        only touch existing elements), so exposing a longer view always
        reveals fresh singletons.
        """
        old = len(self.parent)
        if n <= old:
            return
        buf = getattr(self, "_parent_buf", None)
        if buf is None or n > buf.shape[0]:
            cap = max(2 * old, n, 64)
            pbuf = np.arange(cap, dtype=np.int64)
            sbuf = np.ones(cap, dtype=np.int64)
            pbuf[:old] = self.parent
            sbuf[:old] = self.size
            self._parent_buf, self._size_buf = pbuf, sbuf
        self.parent = self._parent_buf[:n]
        self.size = self._size_buf[:n]

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return int(x)

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]

    def roots(self) -> np.ndarray:
        return np.array([self.find(i) for i in range(len(self.parent))])
