"""Featurization + training-set construction for the cardinality
estimator (port of ``repro.core.cardinality.features``).

The estimator input is (query point ⊕ distance threshold); the training
set covers cosine thresholds 0.1..0.9.  Ground-truth counts come from
one blocked fp32 product per database block shared by every threshold.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ... import exact_fp32, resolve_device

__all__ = ["featurize", "multi_eps_counts", "build_training_set", "DEFAULT_EPS_GRID"]

DEFAULT_EPS_GRID: Tuple[float, ...] = tuple(np.round(np.arange(0.1, 0.91, 0.1), 2))


def featurize(queries: torch.Tensor, eps) -> torch.Tensor:
    """Concat query vectors with the (broadcast) eps feature -> (n, d+1)."""
    e = torch.as_tensor(eps, dtype=queries.dtype, device=queries.device).reshape(-1)
    e = e.expand(queries.shape[0])
    return torch.cat([queries, e[:, None]], dim=1)


def multi_eps_counts(queries: torch.Tensor, db: torch.Tensor, eps_grid: Sequence[float],
                     *, block_size: int = 2048) -> torch.Tensor:
    """Exact counts for every (query, eps) pair: (n_eps, nq) int32.

    A count decides the training target, so the products run in full
    fp32 (TF32 off, see ``exact_fp32``).
    """
    exact_fp32()
    # dot > 1 - eps, thresholds rounded to fp32 as the reference compares
    thresholds = 1.0 - torch.tensor(tuple(eps_grid), dtype=torch.float32, device=queries.device)
    counts = torch.zeros((len(eps_grid), queries.shape[0]), dtype=torch.int32, device=queries.device)
    for s in range(0, db.shape[0], block_size):
        dots = queries @ db[s : s + block_size].T
        counts += (dots[None] > thresholds[:, None, None]).sum(dim=2, dtype=torch.int32)
    return counts


def build_training_set(
    train_vectors,
    eps_grid: Sequence[float] = DEFAULT_EPS_GRID,
    *,
    query_batch: int = 4096,
    block_size: int = 2048,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(features, targets) over the full (train point × eps) grid, on the
    device, in the reference's row order (query batch, then eps, then
    row).  features: (n*|grid|, d+1) fp32; targets: z = log2(1+count)."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(train_vectors, np.float32)).to(dev)
    grid = tuple(float(e) for e in eps_grid)
    feats, targets = [], []
    for start in range(0, x.shape[0], query_batch):
        q = x[start : start + query_batch]
        counts = multi_eps_counts(q, x, grid, block_size=block_size)  # (n_eps, b)
        for ei, e in enumerate(grid):
            feats.append(featurize(q, e))
            # log2 in float64 then fp32, as numpy computes the reference's
            targets.append(torch.log2(1.0 + counts[ei].to(torch.float64)).to(torch.float32))
    return torch.cat(feats), torch.cat(targets)
