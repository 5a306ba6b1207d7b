"""Distance primitives for angular-distance clustering (port of
``repro.core.distances``).

Cosine distance on L2-normalized embeddings; Equation 1 of the paper
converts cosine thresholds to Euclidean ones for unit vectors:
``d_euc = sqrt(2 * d_cos)``.  Products run with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import exact_fp32

__all__ = [
    "l2_normalize",
    "cosine_distance",
    "pairwise_cosine_distance",
    "cos_to_euclidean",
    "euclidean_to_cos",
]


def l2_normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize vectors along ``axis`` (paper §3.1: all data normalized)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def cosine_distance(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cosine distance 1 - <u,v> for *normalized* u, v (elementwise batched)."""
    return 1.0 - torch.sum(u * v, dim=-1)


def pairwise_cosine_distance(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """All-pairs cosine distance of normalized rows: (nq, d) x (nd, d) -> (nq, nd)."""
    exact_fp32()
    return 1.0 - q @ db.T


def cos_to_euclidean(d_cos):
    """Paper Eq. 1: d_euc = sqrt(2 * d_cos) for unit vectors."""
    return np.sqrt(2.0 * np.asarray(d_cos))


def euclidean_to_cos(d_euc):
    """Inverse of Eq. 1: d_cos = d_euc^2 / 2."""
    d = np.asarray(d_euc)
    return d * d / 2.0
