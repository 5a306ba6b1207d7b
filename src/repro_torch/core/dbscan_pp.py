"""DBSCAN++ (Jang & Jiang 2019) and its LAF-enhanced variant (port of
``repro.core.dbscan_pp``).

DBSCAN++ samples a subset S (uniform or greedy k-center), detects core
points *within S but w.r.t. the entire dataset*, grows clusters over the
sampled cores, and assigns every remaining point to the cluster of its
closest sampled core within eps (else noise).

LAF-DBSCAN++ (paper §3.1, α fixed at 1.0): the cardinality estimator
runs before each *sampled* point's range query; predicted-stop samples
are skipped and registered in 𝓔; partial neighbors accumulate from the
executed sample queries (which scan the full dataset); Algorithm 3
rescues false negatives exactly as in LAF-DBSCAN.

Range queries go through the backend (on the exact backend, the
``range_count`` kernel).  The k-center similarities and the
nearest-sampled-core assignment are closest-point queries outside the
backend contract: plain fp32 products on the backend's device, TF32 off.

The paper's automatic sample fraction: p = δ + R_c, with R_c the ratio
of points the estimator predicts core and δ ∈ [0.1, 0.3].
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import exact_fp32, resolve_device
from ..obs.metrics import PhaseClock
from .dbscan import NOISE, DBSCANResult
from .postprocess import PartialNeighborMap, post_processing
from .union_find import compact_labels_from_parent, union_star

__all__ = ["auto_sample_fraction", "kcenter_sample", "nearest_core", "dbscan_pp", "laf_dbscan_pp"]


def auto_sample_fraction(
    predicted_counts: np.ndarray, tau: int, alpha: float, delta: float = 0.2
) -> float:
    """Paper §3.1 parameter rule: p = δ + R_c (clipped to (0, 1])."""
    r_c = float(np.mean(np.asarray(predicted_counts) >= alpha * tau))
    return float(np.clip(delta + r_c, 0.01, 1.0))


def kcenter_sample(data, m: int, seed: int = 0, *, device=None) -> np.ndarray:
    """Greedy k-center (farthest-first) sample of m indices — the
    initialization DBSCAN++ reports best results with.  ``data`` is a
    host array (uploaded to ``device``) or float32 rows already on a
    device.  The similarities and each argmin stay there; the chosen
    indices are read once."""
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    m = min(m, n)
    first = int(rng.integers(n))
    exact_fp32()
    if torch.is_tensor(data):
        x = data
    else:
        x = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32)).to(resolve_device(device))
    chosen = [torch.tensor(first, device=x.device)]
    # max cosine similarity to any chosen center (=> min distance)
    best_sim = x @ x[first]
    for _ in range(m - 1):
        nxt = torch.argmin(best_sim)
        chosen.append(nxt)
        best_sim = torch.maximum(best_sim, x @ x[nxt])
    return np.sort(torch.stack(chosen).cpu().numpy().astype(np.int64))


def nearest_core(x: torch.Tensor, core_x: torch.Tensor, eps: float, block_size: int):
    """For every row of ``x``: the first most similar row of ``core_x``
    and whether that dot exceeds float32(1 - eps), as host arrays (two
    reads).  An exact fp32 product, ``block_size`` rows at a time."""
    exact_fp32()
    thresh = torch.tensor(1.0 - eps, dtype=torch.float32, device=x.device)
    best, ok = [], []
    for start in range(0, x.shape[0], block_size):
        dots = x[start : start + block_size] @ core_x.T  # (b, m_core)
        b = torch.argmax(dots, dim=1)
        best.append(b)
        ok.append(dots.gather(1, b[:, None])[:, 0] > thresh)
    return torch.cat(best).cpu().numpy(), torch.cat(ok).cpu().numpy()


def _cluster_from_sampled_cores(
    sample_idx: np.ndarray,
    core_in_sample: np.ndarray,
    eps: float,
    block_size: int,
    bk,
    clock: PhaseClock,
) -> np.ndarray:
    """Connected components over sampled cores + nearest-core assignment.

    Core-core edges go through the range backend; the nearest-core
    assignment is an argmax (closest-point) query outside the
    ``RangeBackend`` contract, so it stays an exact fp32 product over
    the backend's resident rows.
    """
    n = bk.n_points
    core_idx = sample_idx[core_in_sample]
    labels = np.full(n, NOISE, dtype=np.int64)
    if len(core_idx) == 0:
        clock.mark("components")
        clock.mark("assign")
        return labels
    parent = np.arange(len(core_idx), dtype=np.int64)
    # core-core unions within the sample
    for start in range(0, len(core_idx), block_size):
        hit = bk.query_hits_subset(core_idx[start : start + block_size], core_idx, eps)
        for bi in range(hit.shape[0]):
            union_star(parent, np.nonzero(hit[bi])[0])
    comp = compact_labels_from_parent(parent, np.ones(len(core_idx), bool))
    clock.mark("components")
    # assign every point to its closest sampled core within eps
    x = bk.data_device
    best_h, ok_h = nearest_core(x, x[torch.from_numpy(core_idx).to(x.device)], eps, block_size)
    labels[ok_h] = comp[best_h[ok_h]]
    clock.mark("assign")
    return labels


def _sample(n: int, p: float, init: str, seed: int, bk) -> np.ndarray:
    m = max(1, int(round(p * n)))
    if init == "kcenter":
        return kcenter_sample(bk.data_device, m, seed)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=m, replace=False))


def dbscan_pp(
    data: np.ndarray,
    eps: float,
    tau: int,
    p: float,
    *,
    init: str = "uniform",
    block_size: int = 2048,
    seed: int = 0,
    backend="exact",
    device=None,
) -> DBSCANResult:
    """DBSCAN++ with sample fraction p (``backend``/``device`` as in
    ``dbscan_parallel``); phase times go to ``dbscanpp.phase.*``."""
    from ..index import as_fitted

    data = np.asarray(data, dtype=np.float32)
    n = data.shape[0]
    clock = PhaseClock.for_engine(backend, device)
    bk = as_fitted(backend, data, block_size=block_size, device=device)
    clock.mark("fit_index")
    m = max(1, int(round(p * n)))
    sample_idx = _sample(n, p, init, seed, bk)
    clock.mark("sample")

    # core detection: sampled queries against the ENTIRE dataset
    counts = bk.query_counts(sample_idx, eps)
    core_in_sample = counts >= tau
    clock.mark("core_counts")

    labels = _cluster_from_sampled_cores(
        sample_idx, core_in_sample, eps, block_size, bk, clock
    )
    clock.publish("dbscanpp.phase")
    core = np.zeros(n, dtype=bool)
    core[sample_idx[core_in_sample]] = True
    n_clusters = int(labels.max()) + 1 if labels.max() >= 0 else 0
    return DBSCANResult(
        labels, core, n_clusters, int(m), {"sample_fraction": p, "m": m}
    )


def laf_dbscan_pp(
    data: np.ndarray,
    eps: float,
    tau: int,
    p: float,
    predicted_counts_sample: np.ndarray,
    *,
    alpha: float = 1.0,
    init: str = "uniform",
    block_size: int = 2048,
    seed: int = 0,
    sample_idx: Optional[np.ndarray] = None,
    backend="exact",
    device=None,
) -> DBSCANResult:
    """LAF-DBSCAN++: skip sampled range queries for predicted-stop samples.

    ``predicted_counts_sample`` aligns with the sample (either the given
    ``sample_idx`` or the one this function draws with ``seed`` — drawn
    identically to :func:`dbscan_pp` so the two share samples).  Phase
    times go to ``lafpp.phase.*``.
    """
    from ..index import as_fitted

    data = np.asarray(data, dtype=np.float32)
    n = data.shape[0]
    clock = PhaseClock.for_engine(backend, device)
    bk = as_fitted(backend, data, block_size=block_size, device=device)
    clock.mark("fit_index")
    if sample_idx is None:
        sample_idx = _sample(n, p, init, seed, bk)
    m = len(sample_idx)

    predicted_core = np.asarray(predicted_counts_sample) >= alpha * tau
    exec_rows = sample_idx[predicted_core]

    counts = np.zeros(m, dtype=np.int64)
    partial_counts = np.zeros(n, dtype=np.int64)
    for start in range(0, len(exec_rows), block_size):
        rows = exec_rows[start : start + block_size]
        hit = bk.query_hits(rows, eps)
        # map back to sample positions
        pos = np.searchsorted(sample_idx, rows)
        counts[pos] = hit.sum(axis=1)
        partial_counts += hit.sum(axis=0)
    core_in_sample = predicted_core & (counts >= tau)
    clock.mark("sweep")

    labels = _cluster_from_sampled_cores(
        sample_idx, core_in_sample, eps, block_size, bk, clock
    )

    # ---- post-processing (Algorithm 3) over predicted-stop samples -----
    in_sample_stop = np.zeros(n, dtype=bool)
    in_sample_stop[sample_idx[~predicted_core]] = True
    rescue_mask = in_sample_stop & (partial_counts >= tau)
    rescue_idx = np.nonzero(rescue_mask)[0]
    emap = PartialNeighborMap()
    if len(rescue_idx) > 0:
        for start in range(0, len(exec_rows), block_size):
            rows = exec_rows[start : start + block_size]
            hit = bk.query_hits_subset(rows, rescue_idx, eps)
            for ri in np.nonzero(hit.any(axis=0))[0]:
                r = int(rescue_idx[ri])
                emap.register(r)
                emap[r].update(int(f) for f in rows[hit[:, ri]])
    labels = post_processing(labels, emap, tau, rng=np.random.default_rng(seed))
    clock.mark("rescue")
    clock.publish("lafpp.phase")

    core = np.zeros(n, dtype=bool)
    core[sample_idx[core_in_sample]] = True
    n_clusters = len(np.unique(labels[labels >= 0]))
    extras = {
        "sample_fraction": p,
        "m": int(m),
        "n_skipped": int(m - len(exec_rows)),
        "n_rescued": int(len(rescue_idx)),
    }
    return DBSCANResult(labels, core, n_clusters, int(len(exec_rows)), extras)
