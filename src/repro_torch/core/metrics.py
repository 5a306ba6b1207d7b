"""Clustering quality metrics: ARI (Hubert & Arabie 1985) and AMI
(Vinh, Epps & Bailey 2010) — the paper's two effectiveness metrics
(port of ``repro.core.metrics``: host numpy, as in the reference).

Implemented from scratch (no sklearn/scipy in the environment); AMI uses
the exact hypergeometric E[MI] with an (a_i, b_j)-value cache so large
contingency tables stay tractable.  Both treat label values opaquely;
noise (-1) is a regular label, matching how the paper scores against
DBSCAN ground truth.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = [
    "contingency",
    "adjusted_rand_index",
    "mutual_info",
    "expected_mutual_info",
    "adjusted_mutual_info",
    "entropy",
]


def contingency(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Contingency matrix between two labelings plus marginals."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    if a.shape != b.shape:
        raise ValueError("labelings must have equal length")
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    ra, rb = ai.max() + 1, bi.max() + 1
    m = np.zeros((ra, rb), dtype=np.int64)
    np.add.at(m, (ai, bi), 1)
    return m, m.sum(axis=1), m.sum(axis=0)


def _comb2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    return x * (x - 1.0) / 2.0


def adjusted_rand_index(a: np.ndarray, b: np.ndarray) -> float:
    m, ra, cb = contingency(a, b)
    n = ra.sum()
    sum_comb = _comb2(m).sum()
    sum_a = _comb2(ra).sum()
    sum_b = _comb2(cb).sum()
    total = _comb2(np.asarray([n]))[0]
    expected = sum_a * sum_b / total if total > 0 else 0.0
    max_index = 0.5 * (sum_a + sum_b)
    if max_index == expected:
        return 1.0
    return float((sum_comb - expected) / (max_index - expected))


def entropy(counts: np.ndarray) -> float:
    counts = counts[counts > 0].astype(np.float64)
    n = counts.sum()
    p = counts / n
    return float(-(p * np.log(p)).sum())


def mutual_info(a: np.ndarray, b: np.ndarray) -> float:
    m, ra, cb = contingency(a, b)
    n = float(ra.sum())
    nz = m > 0
    nij = m[nz].astype(np.float64)
    outer = np.outer(ra, cb)[nz].astype(np.float64)
    return float((nij / n * (np.log(nij * n) - np.log(outer))).sum())


def expected_mutual_info(ra: np.ndarray, cb: np.ndarray) -> float:
    """Exact E[MI] under the permutation model (Vinh et al. 2010, Eq. 24a).

    Vectorized over the hypergeometric support per (a_i, b_j) pair, with a
    cache keyed on the (a, b) values — contingency tables from DBSCAN runs
    have many repeated marginal values (singleton clusters), so this is
    orders of magnitude faster than the naive triple loop.
    """
    n = int(ra.sum())
    lg = np.zeros(n + 2, dtype=np.float64)
    for i in range(2, n + 2):
        lg[i] = lg[i - 1] + math.log(i - 1)  # lg[k] = log((k-1)!)
    log_n = math.log(n)

    cache: dict[Tuple[int, int], float] = {}
    emi = 0.0
    for a in ra:
        a = int(a)
        for b in cb:
            b = int(b)
            key = (a, b)
            if key in cache:
                emi += cache[key]
                continue
            start = max(1, a + b - n)
            end = min(a, b)
            if end < start:
                cache[key] = 0.0
                continue
            nij = np.arange(start, end + 1, dtype=np.int64)
            term1 = nij / n * (np.log(nij) + log_n - math.log(a) - math.log(b))
            logw = (
                lg[a + 1]
                + lg[b + 1]
                + lg[n - a + 1]
                + lg[n - b + 1]
                - lg[n + 1]
                - lg[nij + 1]
                - lg[a - nij + 1]
                - lg[b - nij + 1]
                - lg[n - a - b + nij + 1]
            )
            val = float((term1 * np.exp(logw)).sum())
            cache[key] = val
            emi += val
    return emi


def adjusted_mutual_info(a: np.ndarray, b: np.ndarray) -> float:
    """AMI with arithmetic mean normalization (sklearn default)."""
    m, ra, cb = contingency(a, b)
    if len(ra) == 1 and len(cb) == 1:
        return 1.0
    mi = mutual_info(a, b)
    emi = expected_mutual_info(ra, cb)
    h = 0.5 * (entropy(ra) + entropy(cb))
    denom = h - emi
    if abs(denom) < 1e-15:
        return 0.0 if abs(mi - emi) > 1e-15 else 1.0
    return float((mi - emi) / denom)
