"""Connected components: host union-find + min-label propagation (port
of ``repro.core.union_find``).

* ``UnionFind`` / ``connected_components_host`` — path-halving
  union-find on the host (numpy); ``union_star`` /
  ``compact_labels_from_parent`` are the host cluster pass of
  ``laf_dbscan`` (the parity oracle of the device pass), and
  ``UnionFind`` carries the post-processing merges.
* ``label_propagation`` / ``label_propagation_dense`` — iterated
  min-label propagation with pointer jumping over a packed int32 (or a
  dense bool) adjacency, plain PyTorch on tensors of any device; the
  plain version that ``kernels.label_prop.label_propagation_pallas`` is
  held against.  The packed one unpacks ``block`` rows at a time.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from .range_query import unpack_bitmap_t

__all__ = [
    "UnionFind",
    "connected_components_host",
    "find_roots_vec",
    "union_star",
    "compact_labels",
    "compact_labels_from_parent",
    "label_propagation",
    "label_propagation_dense",
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


def connected_components_host(
    n: int, edges: Iterable[Tuple[int, int]], mask: np.ndarray | None = None
) -> np.ndarray:
    """Component label per node (-1 where ``mask`` is False).

    Labels are compacted to 0..k-1 ordered by smallest member index, so
    the result is deterministic regardless of edge order.
    """
    uf = UnionFind(n)
    for a, b in edges:
        uf.union(int(a), int(b))
    roots = uf.roots()
    labels = np.full(n, -1, dtype=np.int64)
    active = np.arange(n) if mask is None else np.nonzero(mask)[0]
    remap: dict[int, int] = {}
    for i in active:
        r = roots[i]
        if r not in remap:
            remap[r] = len(remap)
        labels[i] = remap[r]
    return labels


def _min_over_neighbors(labels: torch.Tensor, bitmap: torch.Tensor, big: int, *, block: int = 1024):
    """For each row i: min over {labels[j] : bit j set in bitmap[i]}
    (``big`` where none; columns past ``len(labels)`` read ``big``)."""
    from ..kernels.label_prop.ref import label_prop_rect_ref

    n, nw = labels.shape[0], bitmap.shape[1]
    padded = torch.full((nw * 32,), big, dtype=labels.dtype, device=labels.device)
    padded[:n] = labels
    rows = torch.full((bitmap.shape[0],), big, dtype=labels.dtype, device=labels.device)
    return label_prop_rect_ref(rows, padded, bitmap, big, block=block)


def _propagate(neighbors, active: torch.Tensor, max_iters: int) -> torch.Tensor:
    """Min-label rounds with pointer jumping until nothing changes (one
    host read a round): ``neighbors(labels)`` is each row's min neighbor
    label, ``n`` where none."""
    n = active.shape[0]
    labels = torch.where(active, torch.arange(n, dtype=torch.int32, device=active.device), n)
    for _ in range(max_iters):
        new = torch.minimum(labels, torch.where(active, neighbors(labels), n))
        # pointer jumping: label <- label of my label (labels index nodes)
        jump = torch.where(new < n, new, 0).long()
        new = torch.where(new < n, torch.minimum(new, new[jump]), new)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels


def as_device_operands(a, active, dtype, device=None):
    """``a`` as a ``dtype`` tensor and ``active`` as a bool one beside
    it.  A tensor stays on its device; an array goes to ``device``
    (default cuda), uint32 words reinterpreted as int32."""
    if not torch.is_tensor(a):
        from .. import resolve_device

        a = np.asarray(a)
        a = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(resolve_device(device))
    return a.to(dtype), torch.as_tensor(active).to(device=a.device, dtype=torch.bool)


def label_propagation(bitmap, active, *, max_iters: int = 64, block: int = 1024, device=None) -> torch.Tensor:
    """Connected-component ids by min-label propagation + pointer jumping.

    Args:
      bitmap: (n, ceil(n/32)) packed int32 adjacency words, LSB-first
        (symmetric over active nodes; self-bits are fine).
      active: (n,) bool; inactive nodes get label ``n`` (sentinel).
      max_iters: propagation rounds; with pointer jumping the number of
        required rounds is O(log n) for any topology.
      device: where an array ``bitmap`` goes (default cuda); a tensor
        stays on its device.

    Returns (n,) int32 on the bitmap's device: min active-node index of
    each component, or n.
    """
    bitmap, active = as_device_operands(bitmap, active, torch.int32, device)
    n = active.shape[0]
    return _propagate(lambda lab: _min_over_neighbors(lab, bitmap, n, block=block), active, max_iters)


def label_propagation_dense(adj, active, *, max_iters: int = 64, device=None) -> torch.Tensor:
    """Same as :func:`label_propagation` but over a dense bool adjacency."""
    adj, active = as_device_operands(adj, active, torch.bool, device)
    n = active.shape[0]
    return _propagate(lambda lab: torch.where(adj, lab[None, :], n).amin(dim=1), active, max_iters)
