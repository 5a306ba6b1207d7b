"""Synthetic dataset generators (numpy copy of the LAF-DBSCAN part of
``repro.data.synthetic`` and of its ``token_stream``, ``ctr_batch``,
``powerlaw_graph`` and ``random_small_graphs``: same draws from the same
seeds).

The paper evaluates on normalized high-dimensional neural embeddings
(NYT bag-of-words 256-d, Glove 200-d, MS-MARCO passage embeddings
768-d).  Offline we generate seeded **von Mises-Fisher mixtures** on the
unit sphere — the canonical generative model for angular-distance
clustering — matched to the paper's operating points (n, d, noise ratio,
cluster count; Table 1 / Table 2).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = [
    "sample_uniform_sphere",
    "sample_vmf",
    "make_angular_clusters",
    "train_test_split",
    "token_stream",
    "ctr_batch",
    "powerlaw_graph",
    "random_small_graphs",
]


def sample_uniform_sphere(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _sample_vmf_w(rng: np.random.Generator, kappa: float, d: int, n: int) -> np.ndarray:
    """Wood (1994) rejection sampler for the vMF marginal cos-angle w."""
    b = (-2.0 * kappa + math.sqrt(4.0 * kappa**2 + (d - 1.0) ** 2)) / (d - 1.0)
    x0 = (1.0 - b) / (1.0 + b)
    c = kappa * x0 + (d - 1.0) * math.log(1.0 - x0**2)
    out = np.empty(n, dtype=np.float64)
    filled = 0
    while filled < n:
        m = (n - filled) * 2 + 16
        z = rng.beta((d - 1.0) / 2.0, (d - 1.0) / 2.0, size=m)
        w = (1.0 - (1.0 + b) * z) / (1.0 - (1.0 - b) * z)
        u = rng.uniform(size=m)
        ok = kappa * w + (d - 1.0) * np.log1p(-x0 * w) - c >= np.log(u)
        take = min(int(ok.sum()), n - filled)
        out[filled : filled + take] = w[ok][:take]
        filled += take
    return out


def sample_vmf(rng: np.random.Generator, mu: np.ndarray, kappa: float, n: int) -> np.ndarray:
    """n samples from vMF(mu, kappa) on S^{d-1}."""
    d = mu.shape[0]
    if kappa <= 0:
        return sample_uniform_sphere(rng, n, d)
    w = _sample_vmf_w(rng, kappa, d, n)  # (n,)
    v = rng.standard_normal((n, d))
    v -= (v @ mu)[:, None] * mu[None, :]  # orthogonalize against mu
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    x = w[:, None] * mu[None, :] + np.sqrt(np.maximum(1.0 - w**2, 0.0))[:, None] * v
    return x.astype(np.float32)


def make_angular_clusters(
    n: int,
    d: int,
    n_clusters: int,
    *,
    kappa: float = 120.0,
    noise_frac: float = 0.3,
    cluster_size_alpha: float = 1.2,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded vMF mixture + uniform noise on the sphere.

    Returns (data (n,d) float32 L2-normalized, true_labels (n,) with -1
    noise).  Cluster sizes follow a power law (the paper's datasets have
    heavy-tailed cluster sizes — Table 6's tiny missed clusters).
    """
    rng = np.random.default_rng(seed)
    n_noise = int(round(n * noise_frac))
    n_clustered = n - n_noise
    raw = rng.pareto(cluster_size_alpha, size=n_clusters) + 1.0
    sizes = np.maximum((raw / raw.sum() * n_clustered).astype(int), 1)
    while sizes.sum() < n_clustered:
        sizes[rng.integers(n_clusters)] += 1
    while sizes.sum() > n_clustered:
        i = rng.integers(n_clusters)
        if sizes[i] > 1:
            sizes[i] -= 1
    centers = sample_uniform_sphere(rng, n_clusters, d)
    xs, ys = [], []
    for k in range(n_clusters):
        xs.append(sample_vmf(rng, centers[k].astype(np.float64), kappa, int(sizes[k])))
        ys.append(np.full(int(sizes[k]), k, dtype=np.int64))
    if n_noise:
        xs.append(sample_uniform_sphere(rng, n_noise, d))
        ys.append(np.full(n_noise, -1, dtype=np.int64))
    data = np.concatenate(xs, axis=0)
    labels = np.concatenate(ys, axis=0)
    perm = rng.permutation(n)
    data = data[perm]
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    return data.astype(np.float32), labels[perm]


def train_test_split(
    data: np.ndarray, frac_train: float = 0.8, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Paper §3.1: 8:2 split; estimator trains on train, clustering on test."""
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    perm = rng.permutation(n)
    k = int(round(n * frac_train))
    return data[perm[:k]], data[perm[k:]]


def token_stream(rng: np.random.Generator, batch: int, seq_len: int, vocab: int):
    """Zipf-ish token batch + next-token labels."""
    z = rng.zipf(1.3, size=(batch, seq_len + 1))
    toks = np.minimum(z - 1, vocab - 1).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def ctr_batch(
    rng: np.random.Generator,
    batch: int,
    n_fields: int,
    vocab_sizes: np.ndarray,
    seq_len: int = 0,
):
    """Criteo-style CTR batch: sparse ids per field (+ optional behavior seq)."""
    ids = np.stack(
        [rng.integers(0, v, size=batch) for v in vocab_sizes], axis=1
    ).astype(np.int32)
    out = {"ids": ids, "label": rng.integers(0, 2, size=batch).astype(np.float32)}
    if seq_len:
        out["hist"] = rng.integers(0, vocab_sizes[0], size=(batch, seq_len)).astype(np.int32)
    return out


def powerlaw_graph(rng: np.random.Generator, n_nodes: int, n_edges: int, d_feat: int):
    """Random graph with power-law-ish degree: preferential src sampling."""
    w = 1.0 / (np.arange(1, n_nodes + 1) ** 0.8)
    w /= w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=w).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    feats = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, 7, size=n_nodes).astype(np.int32)
    return {"src": src, "dst": dst, "feats": feats, "labels": labels}


def random_small_graphs(
    rng: np.random.Generator, batch: int, n_nodes: int, n_edges: int, d_feat: int
):
    """Batched molecule-style small graphs (padded dense edge lists)."""
    src = rng.integers(0, n_nodes, size=(batch, n_edges)).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=(batch, n_edges)).astype(np.int32)
    feats = rng.standard_normal((batch, n_nodes, d_feat)).astype(np.float32)
    y = rng.standard_normal((batch,)).astype(np.float32)
    return {"src": src, "dst": dst, "feats": feats, "y": y}
