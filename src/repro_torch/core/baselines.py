"""The paper's baseline DBSCAN variants on the card (port of
``repro.core.baselines``): the same results, label for label, with the
distance work on the device.

* ``knn_block_dbscan`` — KNN-BLOCK DBSCAN: a point is core iff enough
  of its candidates lie within eps, the candidates being a window of
  ``window`` points on each side of it along ``n_proj`` random
  projections (the projections and their order are the reference's own
  numpy draws).  Sorted by one projection, each point's window is a band
  of columns, so a block of sorted rows is one ``range_count_bitmap``
  launch against the band's column slice, and ``row_popcount`` counts
  each row's hits within its own window.  The count is the maximum over
  the projections, as in the reference.
* ``block_dbscan`` — BLOCK-DBSCAN: a greedy cover by balls of Euclidean
  radius eps_e/2 (``_greedy_cover``, below); blocks with >= tau members
  are inner (all core, no query); the rest are counted by ``range_count``;
  blocks are joined through sampled pair checks (``rnt``) between blocks
  whose landmarks lie within 2 eps_e.
* ``rho_approx_dbscan`` — rho-approximate DBSCAN: exact cores
  (``range_count``), core-core edges within eps(1 + rho)
  (``range_count_bitmap``), with the published grid-cell bookkeeping on
  the host for ``engine="cell"`` (the overhead the paper's Table 4
  measures).

Thresholds: the reference compares float32 products with Python floats,
which NumPy rounds to float32 first, so a hit is ``dot >
float32(1 - eps)`` (``kernels.range_count.threshold``) and the cover's
and the candidate test's ``>=`` compare with the float32 rounding of
their bounds.  Every thresholded count or hit goes through the
``range_count`` kernel; the closest-point products outside it (the
cover's similarities, the landmark dots, the pair and border arg-maxes)
are fp32 ``torch.matmul`` with TF32 off.  Only connected components
decide the labels (``compact_labels_from_parent`` numbers components by
their smallest member), so unions may run in any order.

Each entry point takes ``device=`` (``None`` = cuda, raising without a
card) and counts its device-to-host reads on the
``baselines.<name>.host_syncs`` counter; they grow with n / block_size,
not with n.  Phase times go to the ``baselines.<name>.phase.*`` gauges.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import exact_fp32
from ..kernels.popcount import row_popcount
from ..kernels.range_count import range_count, range_count_bitmap
from ..obs import metrics as _metrics
from ..obs.metrics import PhaseClock
from .dbscan import DBSCANResult, cluster_cores
from .dbscan_pp import nearest_core
from .distances import cos_to_euclidean
from .range_query import unpack_bitmap_t
from .union_find import compact_labels_from_parent, find_roots_vec, union_star

__all__ = ["knn_block_dbscan", "block_dbscan", "rho_approx_dbscan", "METRICS"]

# each entry point's metric names: <prefix>.host_syncs, <prefix>.phase.*_s
METRICS = {"knn_block_dbscan": "baselines.knn_block", "block_dbscan": "baselines.block",
           "rho_approx_dbscan": "baselines.rho_approx"}
ARGMAX_PAIRS = 4096  # block pairs per batched arg-max product
BAND_ALIGN = 128  # columns: a band's bitmap rows are whole 16-byte pieces of words


class _Host:
    """Device-to-host reads of one call, counted on its counter."""

    def __init__(self, name: str):
        self.counter = _metrics.counter(f"{METRICS[name]}.host_syncs")

    def __call__(self, t: torch.Tensor) -> np.ndarray:
        self.counter.inc()
        return t.cpu().numpy()

    def add(self, n: int) -> None:
        self.counter.inc(n)


def _backend(data, block_size, device):
    from ..index.exact import ExactBackend  # deferred: repro_torch.index imports core

    return ExactBackend(block_size=block_size, device=device).fit(data)


def _result(labels, core, queries, extras) -> DBSCANResult:
    n_clusters = int(labels.max()) + 1 if labels.max() >= 0 else 0
    return DBSCANResult(labels, core, n_clusters, queries, extras)


# ---------------------------------------------------------------------------
# KNN-BLOCK-style
# ---------------------------------------------------------------------------


def _projection_order(data: np.ndarray, n_proj: int, seed: int) -> np.ndarray:
    """(n, n_proj) row order along each of the reference's random
    projections (its own draws and argsort)."""
    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal((data.shape[1], n_proj)).astype(np.float32)
    return np.argsort(data @ dirs, axis=0)


def _band(s: int, e: int, n: int, window: int, device):
    """The band of sorted rows [s, e): the column slice [c0, c1) that holds
    every row's window, widened to a multiple of ``BAND_ALIGN`` columns
    where n allows (``row_popcount`` then reads the slice's bitmap in
    16-byte pieces), and each row's window [lo, hi) as (e - s,) int32 bit
    ranges within the slice."""
    c0, c1 = max(s - window, 0), min(e + window, n)
    width = min(-(-(c1 - c0) // BAND_ALIGN) * BAND_ALIGN, n)
    c1 = min(c0 + width, n)
    c0 = c1 - width
    pos = torch.arange(s, e, dtype=torch.int32, device=device)
    lo = (pos - window).clamp(min=0) - c0
    hi = (pos + window + 1).clamp(max=n) - c0
    return c0, c1, lo, hi


def _approx_knn_core(
    x: torch.Tensor, data: np.ndarray, eps: float, tau: int, n_proj: int, window: int, seed: int,
    block_size: int,
) -> torch.Tensor:
    """Approximate core mask (a device bool tensor) via random-projection
    candidate windows: row r's candidates along projection j are the
    sorted positions [pos - window, pos + window] (clipped), itself
    included; its count is the maximum over the projections."""
    n = data.shape[0]
    order = _projection_order(data, n_proj, seed)
    counts = torch.zeros(n, dtype=torch.int32, device=x.device)
    for j in range(n_proj):
        idx = torch.from_numpy(np.ascontiguousarray(order[:, j])).to(x.device)
        xs = x[idx]  # rows in projection order: windows are bands of columns
        got = torch.empty(n, dtype=torch.int32, device=x.device)
        for s in range(0, n, block_size):
            e = min(s + block_size, n)
            c0, c1, lo, hi = _band(s, e, n, window, x.device)
            _, words = range_count_bitmap(xs[s:e], xs[c0:c1], eps)
            got[s:e] = row_popcount(words, lo, hi)
        counts = torch.maximum(counts, torch.empty_like(got).index_put_((idx,), got))
    return counts >= tau


def knn_block_dbscan(
    data: np.ndarray,
    eps: float,
    tau: int,
    *,
    n_proj: int = 4,
    window: Optional[int] = None,
    leaves_ratio: float = 0.6,
    block_size: int = 2048,
    seed: int = 0,
    device=None,
) -> DBSCANResult:
    """KNN-pruned DBSCAN.  ``window=None`` derives it from leaves_ratio
    (fraction of the dataset examined per point, the original's knob);
    a window of at least n/2 is exact mode (``range_count`` over all)."""
    data = np.asarray(data, dtype=np.float32)
    n = data.shape[0]
    if window is None:
        window = max(tau, int(leaves_ratio * n / 2))
    host = _Host("knn_block_dbscan")
    clock = PhaseClock.for_engine(None, device)
    bk = _backend(data, block_size, device)
    x = bk.data_device
    clock.mark("fit_index")
    if window * 2 >= n:
        core_t = range_count(x, x, eps) >= tau
        queries = n
    else:
        core_t = _approx_knn_core(x, data, eps, tau, n_proj, window, seed, block_size)
        queries = int(np.ceil(n * min(1.0, 2 * window * n_proj / n)))
    core = host(core_t)
    clock.mark("core_counts")
    # clustering over the detected cores (star unions + first-finder border)
    labels, reads = cluster_cores(bk, core, eps, block_size)
    host.add(reads)
    clock.mark("components")
    clock.publish(f"{METRICS['knn_block_dbscan']}.phase")
    return _result(labels, core, queries, {"window": int(window)})


# ---------------------------------------------------------------------------
# BLOCK-DBSCAN-style
# ---------------------------------------------------------------------------


def _greedy_cover(x: torch.Tensor, radius_e: float, block_size: int, seed: int, host: _Host):
    """Greedy metric cover: every point within Euclidean ``radius_e`` of
    its landmark.  Returns (landmark ids, assignment as a device int64
    tensor).

    The reference visits ``rng.permutation(n)`` one point at a time; a
    point becomes a landmark iff its best similarity to the landmarks so
    far is below ``sim_thresh``, and each point keeps the first landmark
    of its highest similarity (the strict ``>`` update, and the final
    arg-max).  Here a chunk of the permutation is decided at once: its
    points' best similarities are read, those still uncovered are
    multiplied against every point once, and the host walks the chunk in
    order over their similarities to each other.  The chunk's landmarks
    then update every point's best similarity and landmark on the card
    from the same product."""
    n = x.shape[0]
    dev = x.device
    thr = np.float32(1.0 - radius_e**2 / 2.0)  # euclid <= r  <=>  dot >= 1 - r^2/2
    order = np.random.default_rng(seed).permutation(n)
    exact_fp32()
    best = torch.full((n,), -np.inf, dtype=torch.float32, device=dev)
    assign = torch.full((n,), -1, dtype=torch.int64, device=dev)
    landmarks: list[np.ndarray] = []
    n_lm = 0
    for s in range(0, n, block_size):
        chunk = order[s : s + block_size]
        run = host(best[torch.from_numpy(chunk).to(dev)])
        open_ = ~(run >= thr)
        cand, run = chunk[open_], run[open_]
        if len(cand) == 0:
            continue
        cand_t = torch.from_numpy(cand).to(dev)
        sims = x @ x[cand_t].T  # (n, |cand|)
        local = host(sims[cand_t].T.contiguous())  # local[b, a] = <x_cand[a], x_cand[b]>: row b is landmark b's update
        new = []
        for a in range(len(cand)):
            if run[a] >= thr:
                continue
            new.append(a)
            run = np.fmax(run, local[a])  # the update skips NaN, as ``sims > best`` does
        lm_sims = sims[:, torch.tensor(new, dtype=torch.int64, device=dev)]
        arg = torch.argmax(lm_sims, dim=1)  # first of equal maxima
        top = lm_sims.gather(1, arg[:, None])[:, 0]
        upd = top > best
        best = torch.where(upd, top, best)
        assign = torch.where(upd, n_lm + arg, assign)
        landmarks.append(cand[new])
        n_lm += len(new)
    return np.concatenate(landmarks).astype(np.int64), assign


def _members(groups: np.ndarray, n_groups: int):
    """Ascending member indices of each group id (``np.nonzero(groups
    == g)[0]`` for every g at once)."""
    order = np.argsort(groups, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(groups, minlength=n_groups))])
    return [order[bounds[g] : bounds[g + 1]] for g in range(n_groups)]


def _union_edges(parent: np.ndarray, a: np.ndarray, b: np.ndarray) -> None:
    """Union a[k] with b[k] for every k: each round hooks the larger root
    of every edge whose ends still differ under the smallest root offered
    to it, so every root stays its component's smallest member, as after
    ``union_star`` of each pair."""
    a, b = np.asarray(a, dtype=np.int64), np.asarray(b, dtype=np.int64)
    while len(a):
        ra, rb = find_roots_vec(parent, a), find_roots_vec(parent, b)
        diff = ra != rb
        a, b, ra, rb = a[diff], b[diff], ra[diff], rb[diff]
        np.minimum.at(parent, np.maximum(ra, rb), np.minimum(ra, rb))


def _pair_argmax(x: torch.Tensor, ii: np.ndarray, jj: np.ndarray, host: _Host):
    """First flat arg-max of ``x[ii[p]] @ x[jj[p]].T`` for every pair p:
    ``ii``/``jj`` are (P, m) member indices padded with -1.  Returns the
    (P,) chosen members of each side."""
    exact_fp32()
    m = ii.shape[1]
    out = []
    for s in range(0, len(ii), ARGMAX_PAIRS):
        i_t = torch.from_numpy(ii[s : s + ARGMAX_PAIRS]).to(x.device)
        j_t = torch.from_numpy(jj[s : s + ARGMAX_PAIRS]).to(x.device)
        dots = torch.bmm(x[i_t.clamp(min=0)], x[j_t.clamp(min=0)].transpose(1, 2))
        valid = (i_t >= 0)[:, :, None] & (j_t >= 0)[:, None, :]
        out.append(torch.argmax(torch.where(valid, dots, -np.inf).reshape(len(i_t), m * m), dim=1))
    flat = host(torch.cat(out)) if out else np.zeros(0, dtype=np.int64)
    rows = np.arange(len(ii))
    return ii[rows, flat // m], jj[rows, flat % m]


def _padded(groups, width: int) -> np.ndarray:
    out = np.full((len(groups), width), -1, dtype=np.int64)
    for k, g in enumerate(groups):
        out[k, : len(g)] = g
    return out


def _bits(words: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Bits (rows, cols) of a packed LSB-first slab, as bools."""
    return ((words[rows, cols >> 5] >> (cols & 31)) & 1).bool()


def _inter_block_edges(x, assign, core, landmarks, eps, eps_e, rnt, seed, block_size, host):
    """The pairs that the reference's inter-block loop unions
    (``repro/core/baselines.py:207-228``), as two arrays.

    A pair of blocks i < j is checked when both have core members and
    their landmarks' dot is >= cand_sim; its checked members are all its
    core members, or ``rnt`` drawn by ``rng.choice`` when it has more.
    It unions the first arg-max pair of the checked members' dots when
    one of them exceeds the threshold.
    * Pairs of two blocks with at most ``rnt`` core members draw nothing,
      and they matter only where a core-core hit joins them: those pairs
      are found from the core-core bitmap (``range_count_bitmap``).
    * Pairs with a larger block are replayed on the host in the loop's
      order with the same generator; their hits are read from the same
      bitmap.
    """
    n_blocks = len(landmarks)
    dev = x.device
    core_idx = np.nonzero(core)[0]
    nc = len(core_idx)
    if nc == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    blkc = assign[core_idx]
    cm = np.bincount(blkc, minlength=n_blocks)  # core members a block
    cmem = [core_idx[g] for g in _members(blkc, n_blocks)]
    large = cm > rnt
    c32 = float(np.float32(1.0 - (2.0 * eps_e) ** 2 / 2.0))  # landmarks within 2 eps_e
    exact_fp32()

    # core-core hits across two small blocks, row block < column block
    xc = x[torch.from_numpy(core_idx).to(dev)]
    _, words = range_count_bitmap(xc, xc, eps)
    blkc_t = torch.from_numpy(blkc).to(dev)
    small_t = torch.from_numpy(~large[blkc]).to(dev)
    keys = []
    for s in range(0, nc, block_size):
        e = min(s + block_size, nc)
        keep = unpack_bitmap_t(words[s:e], nc)
        keep &= (blkc_t[s:e, None] < blkc_t[None, :]) & small_t[s:e, None] & small_t[None, :]
        r, c = torch.nonzero(keep, as_tuple=True)
        host.add(1)  # nonzero reads its size
        keys.append(blkc_t[s + r] * n_blocks + blkc_t[c])
    # one (i, j) block pair per hit pair, each block pair once, in order
    key_t = torch.unique(torch.cat(keys))
    bi_t, bj_t = key_t // n_blocks, key_t % n_blocks
    key = host(key_t)
    bi, bj = key // n_blocks, key % n_blocks

    # the landmark dots, a block of landmark rows at a time: the small
    # pairs' candidate test, and every candidate pair with a large block
    lm_t = x[torch.from_numpy(landmarks).to(dev)]
    has_core = torch.from_numpy(cm > 0).to(dev)
    large_t = torch.from_numpy(large).to(dev)
    ids = torch.arange(n_blocks, device=dev)
    small_ok = torch.zeros(len(bi), dtype=torch.bool, device=dev)
    big_pairs = []
    if len(bi) or large.any():
        for a in range(0, n_blocks, block_size):
            b = min(a + block_size, n_blocks)
            cand = (lm_t[a:b] @ lm_t.T) >= c32  # (rows i, cols j)
            sel = (bi_t >= a) & (bi_t < b)
            small_ok = torch.where(sel, cand[(bi_t - a).clamp(0, b - a - 1), bj_t], small_ok)
            if large.any():
                # j > i, both with core members, one of them large
                ok = cand & (ids[None, :] > ids[a:b, None]) & has_core[a:b, None] & has_core[None, :]
                ok &= large_t[a:b, None] | large_t[None, :]
                big_pairs.append(torch.nonzero(ok) + torch.tensor([a, 0], device=dev))
                host.add(1)
    edges_a, edges_b = [], []
    keep = host(small_ok) if len(bi) else np.zeros(0, dtype=bool)
    bi, bj = bi[keep], bj[keep]
    single = (cm[bi] == 1) & (cm[bj] == 1)
    first = np.full(n_blocks, len(core), dtype=np.int64)  # each block's first core member
    np.minimum.at(first, blkc, core_idx)
    edges_a.append(first[bi[single]])
    edges_b.append(first[bj[single]])
    multi = np.nonzero(~single)[0]
    if len(multi):
        ea, eb = _pair_argmax(x, _padded([cmem[i] for i in bi[multi]], rnt),
                              _padded([cmem[j] for j in bj[multi]], rnt), host)
        edges_a.append(ea)
        edges_b.append(eb)

    pairs = host(torch.cat(big_pairs)) if big_pairs else []  # lexicographic: the loop's order
    if len(pairs):
        rng = np.random.default_rng(seed)
        ii_l, jj_l = [], []
        for i, j in pairs:
            mi, mj = cmem[i], cmem[j]
            ii_l.append(mi if len(mi) <= rnt else rng.choice(mi, rnt, replace=False))
            jj_l.append(mj if len(mj) <= rnt else rng.choice(mj, rnt, replace=False))
        ii, jj = _padded(ii_l, rnt), _padded(jj_l, rnt)
        cpos = np.full(len(core) + 1, -1, dtype=np.int64)  # cpos[-1]: the padding's -1
        cpos[core_idx] = np.arange(nc)
        any_hit = []
        for s in range(0, len(ii), ARGMAX_PAIRS):
            pi = torch.from_numpy(cpos[ii[s : s + ARGMAX_PAIRS]]).to(dev)
            pj = torch.from_numpy(cpos[jj[s : s + ARGMAX_PAIRS]]).to(dev)
            valid = (pi >= 0)[:, :, None] & (pj >= 0)[:, None, :]
            hit = _bits(words, pi.clamp(min=0)[:, :, None], pj.clamp(min=0)[:, None, :])
            any_hit.append((hit & valid).flatten(1).any(dim=1))
        joined = np.nonzero(host(torch.cat(any_hit)))[0]
        ea, eb = _pair_argmax(x, ii[joined], jj[joined], host)
        edges_a.append(ea)
        edges_b.append(eb)
    return np.concatenate(edges_a), np.concatenate(edges_b)


def block_dbscan(
    data: np.ndarray,
    eps: float,
    tau: int,
    *,
    rnt: int = 10,
    block_size: int = 2048,
    seed: int = 0,
    device=None,
) -> DBSCANResult:
    """BLOCK-DBSCAN: greedy eps_e/2 cover, inner core blocks certified
    without queries, the rest counted exactly, blocks joined by sampled
    pair checks (RNT), borders to their nearest core within eps."""
    data = np.asarray(data, dtype=np.float32)
    n = data.shape[0]
    eps_e = float(cos_to_euclidean(eps))
    host = _Host("block_dbscan")
    clock = PhaseClock.for_engine(None, device)
    bk = _backend(data, block_size, device)
    x = bk.data_device
    clock.mark("fit_index")
    landmarks, assign_t = _greedy_cover(x, eps_e / 2.0, block_size, seed, host)
    assign = host(assign_t)
    clock.mark("cover")
    n_blocks = len(landmarks)
    sizes = np.bincount(assign, minlength=n_blocks)

    # inner core blocks: >= tau members => every member core, no queries
    inner = sizes >= tau
    core = inner[assign].copy()
    rest = np.nonzero(~core)[0]
    if len(rest):
        core[rest] = bk.query_counts(rest, eps) >= tau
        host.add(1)
    queries = len(rest)
    clock.mark("core_counts")

    # connectivity: intra-block cliques are free (diameter <= eps_e)
    parent = np.arange(n, dtype=np.int64)
    members = _members(assign, n_blocks)
    for b in np.nonzero(inner)[0]:
        union_star(parent, members[b])
    edges = _inter_block_edges(x, assign, core, landmarks, eps, eps_e, rnt, seed, block_size, host)
    clock.mark("block_pairs")
    _union_edges(parent, *edges)
    labels = compact_labels_from_parent(parent, core)
    clock.mark("unions")
    # border points: the nearest core's cluster, if within eps
    non_core = np.nonzero(~core)[0]
    core_idx = np.nonzero(core)[0]
    if len(core_idx) and len(non_core):
        best, ok = nearest_core(x[torch.from_numpy(non_core).to(x.device)],
                                x[torch.from_numpy(core_idx).to(x.device)], eps, block_size)
        host.add(2)
        labels[non_core[ok]] = labels[core_idx[best[ok]]]
    clock.mark("borders")
    clock.publish(f"{METRICS['block_dbscan']}.phase")
    return _result(labels, core, queries, {"n_blocks": n_blocks, "inner_blocks": int(inner.sum())})


# ---------------------------------------------------------------------------
# rho-approximate-style
# ---------------------------------------------------------------------------


def rho_approx_dbscan(
    data: np.ndarray,
    eps: float,
    tau: int,
    rho: float = 1.0,
    *,
    engine: str = "cell",
    block_size: int = 2048,
    seed: int = 0,
    device=None,
) -> DBSCANResult:
    """rho-approximate DBSCAN semantics: exact cores, connectivity within
    eps(1+rho) allowed.  ``engine="cell"`` carries the grid-cell
    bookkeeping of the published structure on the host (slow in high-d —
    Table 4); "direct" is the semantics-only fast path."""
    data = np.asarray(data, dtype=np.float32)
    n, d = data.shape
    eps_conn = min(eps * (1.0 + rho), 2.0)
    host = _Host("rho_approx_dbscan")
    clock = PhaseClock.for_engine(None, device)
    bk = _backend(data, block_size, device)
    x = bk.data_device
    clock.mark("fit_index")

    cell_ids = None
    if engine == "cell":
        # literal grid assignment: side eps_e/sqrt(d) per published algo.
        # In high-d this is pure overhead (every point its own cell).
        eps_e = float(cos_to_euclidean(eps))
        w = eps_e / np.sqrt(d)
        cells = np.floor(data / w).astype(np.int64)
        # dict-of-cells bookkeeping (hashing d-dim keys per point)
        table: dict[bytes, list[int]] = {}
        for i in range(n):
            table.setdefault(cells[i].tobytes(), []).append(i)
        cell_ids = table
        clock.mark("cells")

    counts = []
    for start in range(0, n, block_size):
        counts.append(range_count(x[start : start + block_size], x, eps))
        if engine == "cell":
            # per-point cell lookups emulate the structure traversal cost
            # (on the host, while the block's counts run on the card)
            for i in range(start, min(start + block_size, n)):
                _ = cell_ids.get(cells[i].tobytes())
    core = host(torch.cat(counts) >= tau)
    clock.mark("core_counts")

    labels, reads = cluster_cores(bk, core, eps, block_size, conn_eps=eps_conn)
    host.add(reads)
    clock.mark("components")
    clock.publish(f"{METRICS['rho_approx_dbscan']}.phase")
    return _result(labels, core, n, {"rho": rho, "engine": engine})
