"""Plain PyTorch version of the exact range-count kernel (the port's
counterpart of ``repro.kernels.range_count.ref``).

``q @ db.T > thresh`` with TF32 off and ``thresh = float32(1 - eps)``,
packed LSB-first by ``pack_bitmap_t``.  Blocked over both axes so the
(rows, cols) score block stays bounded at main-path shapes.
"""

from __future__ import annotations

import torch

from ... import exact_fp32
from ...core.range_query import pack_bitmap_t

__all__ = ["range_count_ref", "range_count_bitmap_ref"]


def _blocked(q, db, thresh: float, with_bitmap: bool, block: int):
    exact_fp32()
    nq, nd = q.shape[0], db.shape[0]
    counts = torch.zeros(nq, dtype=torch.int32, device=q.device)
    bitmap = (
        torch.zeros((nq, -(-nd // 32)), dtype=torch.int32, device=q.device)
        if with_bitmap else None
    )
    for i in range(0, nq, block):
        qi = q[i : i + block]
        for j in range(0, nd, block):  # block % 32 == 0: word-aligned
            hit = qi @ db[j : j + block].T > thresh
            counts[i : i + block] += hit.sum(dim=1, dtype=torch.int32)
            if with_bitmap:
                words = pack_bitmap_t(hit)
                bitmap[i : i + block, j // 32 : j // 32 + words.shape[1]] = words
    return counts, bitmap


def range_count_ref(q, db, thresh: float, *, block: int = 1024) -> torch.Tensor:
    """(nq,) int32 counts of ``q @ db.T > thresh``."""
    return _blocked(q, db, thresh, False, block)[0]


def range_count_bitmap_ref(q, db, thresh: float, *, block: int = 1024):
    """(counts (nq,) int32, packed hits (nq, ceil(nd/32)) int32)."""
    return _blocked(q, db, thresh, True, block)
