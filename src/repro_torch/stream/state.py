"""Incremental LAF-DBSCAN cluster state (port of ``repro.stream.state``).

The batch engines recompute the whole eps-graph per run; this module
keeps just enough state to maintain the *same partition* online:

* exact per-point neighbor counts (``counts``) for points whose range
  query was executed; a lower bound for skipped (predicted-stop) points,
  the paper's partial-neighbor map |𝓔| semantics;
* the core mask and a growable ``core.union_find.UnionFind`` over the
  core-core eps-graph;
* per-point border ownership (``owner``): the **minimum-index core
  neighbor**, the "first core finder" rule both batch engines implement,
  so streaming labels match a from-scratch run point for point.

Every eps-pair is observed exactly once, by the *later* arrival's range
query (new rows query old + new); core-core union edges are closed under
a new core's own row and a promotion's re-query.  ``evict`` tombstones
rows and reports whether a core died or was demoted: the driver then
rebuilds (union-find cannot split).

The state is host numpy, as the reference's.  Two methods take a packed
block that lies on a device and run kernels there, each with one host
read of its small results (``stream.ingest.host_syncs``):
``ingest_rows_packed`` (``row_popcount`` for the block's counts and
``col_reduce`` for the transposed bumps, so the block is never
unpacked) and ``apply_core_rows_packed`` (``packed_connectivity``, B10;
``promote_packed``'s counts and the block's rounds,
``stream.ingest.connectivity_rounds``, ride the same read).  A numpy
block is a block on the CPU: the kernels' plain versions run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.range_query import pack_bitmap
from ..core.union_find import UnionFind, compact_labels_from_parent, union_star
from ..obs import metrics as _metrics

__all__ = ["StreamingClusterState"]

BIG = np.iinfo(np.int32).max
HOST_SYNCS = "stream.ingest.host_syncs"


def _grow_to(arr: np.ndarray, n: int, fill) -> np.ndarray:
    """Amortized-doubling growth of a 1-d state array to >= n entries."""
    if arr.shape[0] >= n:
        return arr
    cap = max(2 * arr.shape[0], n, 64)
    out = np.full(cap, fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _as_block(pk) -> torch.Tensor:
    """A packed block as an int32 tensor: a tensor stays on its device,
    numpy uint32 words become a CPU tensor with the same bits."""
    if torch.is_tensor(pk):
        return pk
    return torch.from_numpy(np.ascontiguousarray(pk, dtype=np.uint32).view(np.int32))


def _read(parts) -> np.ndarray:
    """The one host read of a packed step: its int32 results in one copy."""
    host = torch.cat([p.reshape(-1).to(torch.int32) for p in parts]).cpu().numpy()
    _metrics.counter(HOST_SYNCS).inc()
    return host


class StreamingClusterState:
    """Cluster bookkeeping for one (eps, tau) operating point.

    The driver (``repro_torch.stream.ingest``) owns the range-query
    backend and feeds hit rows in; this class never touches vectors.
    Hit rows handed in cover the *current* ``n`` points and are masked by
    ``alive`` internally, so tombstoned rows neither count nor union.
    """

    def __init__(self, eps: float, tau: int):
        self.eps = float(eps)
        self.tau = int(tau)
        self.n = 0
        self.counts = np.zeros(0, dtype=np.int64)
        self.core = np.zeros(0, dtype=bool)
        self.alive = np.zeros(0, dtype=bool)
        self.queried = np.zeros(0, dtype=bool)  # False => counts is a lower bound
        self.owner = np.full(0, -1, dtype=np.int64)  # min-index core neighbor
        self.uf = UnionFind(0)
        self.version = 0  # bumped per mutation epoch; serving snapshots key on it

    # -- growth ------------------------------------------------------------
    def extend(self, k: int) -> np.ndarray:
        """Register k new points; returns their (contiguous) indices."""
        new = np.arange(self.n, self.n + k, dtype=np.int64)
        self.n += k
        self.counts = _grow_to(self.counts, self.n, 0)
        self.core = _grow_to(self.core, self.n, False)
        self.alive = _grow_to(self.alive, self.n, False)
        self.queried = _grow_to(self.queried, self.n, False)
        self.owner = _grow_to(self.owner, self.n, -1)
        self.alive[new] = True
        self.uf.grow(self.n)
        self.version += 1
        return new

    # -- per-batch updates (driven by ingest) ------------------------------
    def _masked(self, hit: np.ndarray) -> np.ndarray:
        return hit & self.alive[: hit.shape[1]][None, :]

    def mask_packed(self, pk) -> torch.Tensor:
        """``_masked`` in packed space: the block's first ceil(n/32) words
        (a device slab may carry more) AND the packed alive mask, whose
        zero tail clears bits past n.  Stays on the block's device."""
        pk = _as_block(pk)
        alive = pack_bitmap(self.alive[: self.n][None, :]).view(np.int32)
        return pk[:, : alive.shape[1]] & torch.from_numpy(alive).to(pk.device)

    def ingest_rows(
        self, rows: np.ndarray, hit: np.ndarray, exclude: Optional[np.ndarray] = None
    ) -> None:
        """Count update for newly added, *executed* rows.

        ``hit`` is (len(rows), n): each row's complete adjacency against
        every current point.  Own counts are the row sums; every other
        point's count is bumped by the transposed hits, **except** the
        points in ``exclude``: the whole batch's executed set (defaults
        to ``rows``), so a same-batch pair split over two blocks lands
        exactly once per endpoint.
        """
        hit = self._masked(hit)
        self.ingest_counts(rows, hit.sum(axis=1, dtype=np.int64), hit.sum(axis=0, dtype=np.int64), exclude)

    def ingest_rows_packed(self, rows: np.ndarray, pk, exclude: Optional[np.ndarray] = None) -> None:
        """``ingest_rows`` on a packed block (its first len(rows) rows),
        never unpacked: the counts are ``row_popcount`` of the masked
        block and the bumps ``col_reduce``'s column sums, both on the
        block's device, read in one copy."""
        from ..kernels.label_prop import col_reduce
        from ..kernels.popcount import row_popcount

        r = len(rows)
        pk = self.mask_packed(_as_block(pk)[:r])
        ones = torch.ones(r, dtype=torch.int32, device=pk.device)
        _, bump = col_reduce(pk, torch.full((r,), BIG, dtype=torch.int32, device=pk.device), ones)
        host = _read([row_popcount(pk), bump[: self.n]])
        self.ingest_counts(rows, host[:r].astype(np.int64), host[r:].astype(np.int64), exclude)

    def ingest_counts(self, rows, counts, bump, exclude=None) -> None:
        """The host half of ``ingest_rows``: own counts, then the bumps of
        every point outside ``exclude`` (default ``rows``)."""
        self.counts[rows] = counts
        self.queried[rows] = True
        bump = np.array(bump, dtype=np.int64)
        bump[rows if exclude is None else exclude] = 0
        self.counts[: len(bump)] += bump

    def seed_skipped(self, rows: np.ndarray, core_idx: np.ndarray, hit_cores: np.ndarray) -> None:
        """Count lower bound + ownership for skipped (predicted-stop) rows.

        ``hit_cores`` is (len(rows), len(core_idx)) against the current
        core set only (the online analog of the paper's map 𝓔): a
        skipped point accrues neighbors only from core queries, and
        promotes through ``promote`` if its lower bound crosses tau.
        """
        if len(core_idx) == 0:
            self.counts[rows] = 0
            return
        self.counts[rows] = hit_cores.sum(axis=1, dtype=np.int64)
        any_hit = hit_cores.any(axis=1)
        first = core_idx[hit_cores.argmax(axis=1)]  # min core idx (core_idx sorted)
        self.owner[rows[any_hit]] = first[any_hit]

    def take_promotions(self) -> np.ndarray:
        """Alive non-core points whose count has crossed tau, marked core
        at once (so the re-queries union promoted-promoted edges)."""
        idx = np.nonzero(self.alive & ~self.core & (self.counts >= self.tau))[0]
        self.core[idx] = True
        return idx

    def promote(self, rows: np.ndarray, hit: np.ndarray) -> None:
        """Full re-query rows of freshly promoted points: exact counts,
        unions with every core neighbor and claims of non-core
        neighbors, bumping no one else's count."""
        hit = self._masked(hit)
        self.counts[rows] = hit.sum(axis=1, dtype=np.int64)
        self.queried[rows] = True
        self.apply_core_rows(rows, hit)

    def promote_packed(self, rows: np.ndarray, pk) -> None:
        """``promote`` on a packed re-query block: the counts by
        ``row_popcount`` ride the connectivity step's one host read."""
        counts = self.apply_core_rows_packed(rows, pk, with_counts=True)
        self.counts[rows] = counts
        self.queried[rows] = True

    def apply_core_rows(self, rows: np.ndarray, hit: np.ndarray) -> None:
        """Union + ownership from the hit rows of core points.

        For each core row r: star-union {r} ∪ (N(r) ∩ core), and offer r
        as owner to its non-core neighbors (min-index rule).  Rows that
        are not core only pick up their own ownership.
        """
        hit = self._masked(hit)
        core = self.core[: hit.shape[1]]
        hit_core = hit & core[None, :]
        row_core = self.core[rows]
        for bi in np.nonzero(row_core)[0]:
            union_star(self.uf.parent, np.nonzero(hit_core[bi])[0])
        sub = hit[row_core]
        if sub.shape[0]:
            subrows = rows[row_core]
            claimed = sub.any(axis=0)
            cand = claimed & ~core
            if cand.any():
                first = subrows[sub[:, cand].argmax(axis=0)]
                cur = self.owner[: hit.shape[1]][cand]
                best = np.where((cur < 0) | (first < cur), first, cur)
                self.owner[np.nonzero(cand)[0]] = best
        nc = ~row_core
        if nc.any():
            ncrows = rows[nc]
            own_core = hit_core[nc]
            any_hit = own_core.any(axis=1)
            first = own_core.argmax(axis=1)
            cur = self.owner[ncrows]
            best = np.where(any_hit & ((cur < 0) | (first < cur)), first, cur)
            self.owner[ncrows] = best
        self.version += 1

    def apply_core_rows_packed(self, rows: np.ndarray, pk, *, with_counts: bool = False):
        """``apply_core_rows`` on a *packed* block, never unpacked.

        ``pk`` holds the (len(rows), >= ceil(n/32)) packed hit rows, int32
        on a device or uint32 numpy.  The alive-masked block goes through
        ``kernels.label_prop.packed_connectivity`` on its device, and three
        small int32 vectors come back in one host read: per-column
        component representative, per-column min core row, per-row min
        core column (``with_counts`` adds the rows' popcounts and returns
        them).  The union-find and owner updates they drive are the
        unpacked pass's.
        """
        from ..kernels.label_prop import packed_connectivity
        from ..kernels.popcount import row_popcount

        n = self.n
        rows = np.asarray(rows, dtype=np.int64)
        r = len(rows)
        pk = self.mask_packed(_as_block(pk)[:r])
        row_core = self.core[rows]
        dev = pk.device
        comp, owner, row_first, rounds = packed_connectivity(
            pk, torch.from_numpy(rows).to(dev), torch.from_numpy(row_core).to(dev),
            torch.from_numpy(self.core[:n]).to(dev),
        )
        host = _read([rounds, comp, owner, row_first] + ([row_popcount(pk)] if with_counts else []))
        _metrics.counter("stream.ingest.connectivity_rounds").inc(int(host[0]))
        host = host[1:]
        comp, owner = host[:n], host[n : 2 * n]
        row_first = host[2 * n : 2 * n + r]
        # star-union each component (only columns adjacent to a core
        # block row participate; everything else kept its own label)
        sel = np.nonzero(self.core[:n] & (owner != BIG))[0]
        if sel.size:
            sel = sel[np.argsort(comp[sel], kind="stable")]
            _, starts = np.unique(comp[sel], return_index=True)
            for grp in np.split(sel, starts[1:]):
                union_star(self.uf.parent, grp)
        # ownership offers from the block's core rows
        cand = (~self.core[:n]) & (owner != BIG)
        if cand.any():
            first = owner[cand].astype(np.int64)
            cur = self.owner[:n][cand]
            best = np.where((cur < 0) | (first < cur), first, cur)
            self.owner[np.nonzero(cand)[0]] = best
        # non-core rows pick up their own ownership
        nc = ~row_core
        if nc.any():
            ncrows = rows[nc]
            first = row_first[nc].astype(np.int64)
            any_hit = first < BIG
            cur = self.owner[ncrows]
            best = np.where(any_hit & ((cur < 0) | (first < cur)), first, cur)
            self.owner[ncrows] = best
        self.version += 1
        return host[2 * n + r :].astype(np.int64) if with_counts else None

    # -- deletion ----------------------------------------------------------
    def evict(self, rows: np.ndarray, hit: np.ndarray) -> bool:
        """Tombstone rows; returns True when a rebuild is required.

        ``hit`` is the evicted rows' adjacency against all current
        points (queried *before* tombstoning).  Surviving counts are
        decremented; a rebuild is required when the eviction kills or
        demotes a core point (union-find cannot split).
        """
        rows = np.asarray(rows, dtype=np.int64)
        rows, first = np.unique(rows, return_index=True)  # a repeated index decrements once
        hit = hit[first]
        live = self.alive[rows]
        rows, hit = rows[live], hit[live]  # drop already-dead rows and their hit rows
        if len(rows) == 0:
            return False
        killed_core = bool(self.core[rows].any())
        hit = self._masked(hit)
        dec = hit.sum(axis=0, dtype=np.int64)
        dec[rows] = 0
        self.alive[rows] = False
        self.counts[: len(dec)] -= dec
        demoted = self.alive[: self.n] & self.core[: self.n] & (self.counts[: self.n] < self.tau)
        self.version += 1
        return killed_core or bool(demoted.any())

    @property
    def n_dead(self) -> int:
        return int(self.n - self.alive[: self.n].sum())

    # -- durability --------------------------------------------------------
    def export_arrays(self) -> dict:
        """Snapshot as a flat dict of host arrays, capacity-faithful (the
        doubling-grown arrays whole), in the reference's keys."""
        return {
            "eps": np.float64(self.eps),
            "tau": np.int64(self.tau),
            "n": np.int64(self.n),
            "version": np.int64(self.version),
            "counts": self.counts.copy(),
            "core": self.core.copy(),
            "alive": self.alive.copy(),
            "queried": self.queried.copy(),
            "owner": self.owner.copy(),
            "uf_parent": self.uf.parent[: self.n].copy(),
            "uf_size": self.uf.size[: self.n].copy(),
        }

    @classmethod
    def import_arrays(cls, state: dict) -> "StreamingClusterState":
        """Rebuild from an ``export_arrays`` dict (bit-identical labels,
        owners and counts: the kill-restore contract)."""
        self = cls(float(state["eps"]), int(state["tau"]))
        self.n = int(state["n"])
        self.version = int(state["version"])
        self.counts = np.ascontiguousarray(state["counts"], dtype=np.int64)
        self.core = np.ascontiguousarray(state["core"], dtype=bool)
        self.alive = np.ascontiguousarray(state["alive"], dtype=bool)
        self.queried = np.ascontiguousarray(state["queried"], dtype=bool)
        self.owner = np.ascontiguousarray(state["owner"], dtype=np.int64)
        self.uf = UnionFind(self.n)
        self.uf.parent[: self.n] = state["uf_parent"]
        self.uf.size[: self.n] = state["uf_size"]
        return self

    # -- extraction --------------------------------------------------------
    def labels(self) -> np.ndarray:
        """(n,) labels: -1 noise/dead, clusters 0..k-1 (compacted by
        smallest member, the batch engines' convention)."""
        active = self.core[: self.n] & self.alive[: self.n]
        labels = compact_labels_from_parent(self.uf.parent[: self.n].copy(), active)
        border = self.alive[: self.n] & ~self.core[: self.n] & (self.owner[: self.n] >= 0)
        bidx = np.nonzero(border)[0]
        if len(bidx):
            owners = self.owner[bidx]
            ok = self.alive[owners] & self.core[owners]
            labels[bidx[ok]] = labels[owners[ok]]
        return labels

    @property
    def n_clusters(self) -> int:
        labels = self.labels()
        return int(labels.max()) + 1 if labels.size and labels.max() >= 0 else 0
