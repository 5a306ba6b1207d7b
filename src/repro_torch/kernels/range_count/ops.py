"""Wrappers for the exact range-count kernel (port of
``repro.kernels.range_count.ops``).

``range_count(q, db, eps)`` returns ``counts[i] = |{j : <q_i, db_j> >
float32(1 - eps)}|`` as (nq,) int32; ``range_count_bitmap`` also returns
the packed LSB-first hit words, (nq, ceil(nd/32)) int32 holding the
reference's uint32 bits.  A CPU tensor runs the plain version
(``ref.py``); a CUDA tensor launches the CUDA kernel
(``csrc/range_count.cu``) or raises.  The kernel masks ragged nq/nd
itself, so the results equal the reference wrapper's pad-corrected ones
(eps > 1 included) without padding.
"""

from __future__ import annotations

import numpy as np
import torch

from ...obs import metrics as _metrics
from .. import _build
from .ref import range_count_bitmap_ref, range_count_ref

__all__ = ["range_count", "range_count_bitmap", "threshold", "LAUNCHES"]

LAUNCHES = {
    "range_count": "kernel.range_count.launches",
    "range_count_bitmap": "kernel.range_count_bitmap.launches",
}
MAX_QUERY_ROWS = 65535 * 128  # grid.y limit of the 128-row query tiles


def threshold(eps) -> float:
    """``1 - eps`` rounded once to float32: a hit is ``dot > threshold``."""
    return float(np.float32(1.0 - float(eps)))


def _check_operands(q, db):
    if q.device != db.device:
        raise ValueError("range_count operands must share one device")
    if q.dtype != torch.float32 or db.dtype != torch.float32:
        raise TypeError("q and db must be float32")
    if q.dim() != 2 or db.dim() != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and db {tuple(db.shape)} must be (n, d) with equal d")
    if not (q.is_contiguous() and db.is_contiguous()):
        raise ValueError("range_count operands must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _launch(q, db, eps, with_bitmap: bool):
    nq, nd = q.shape[0], db.shape[0]
    if nq > MAX_QUERY_ROWS:
        raise ValueError(f"at most {MAX_QUERY_ROWS} query rows per launch, got {nq}")
    counts = torch.zeros(nq, dtype=torch.int32, device=q.device)
    bitmap = torch.empty((nq, -(-nd // 32)), dtype=torch.int32, device=q.device) if with_bitmap else None
    if nq == 0 or nd == 0:
        if bitmap is not None:
            bitmap.zero_()
        return counts, bitmap
    err = _build.load("range_count").range_count_launch(
        q.data_ptr(), db.data_ptr(), nq, nd, q.shape[1], threshold(eps),
        counts.data_ptr(), bitmap.data_ptr() if with_bitmap else None,
        bitmap.stride(0) if with_bitmap else 0, int(with_bitmap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    name = "range_count_bitmap" if with_bitmap else "range_count"
    _build.check(err, name)
    _metrics.counter(LAUNCHES[name]).inc()
    return counts, bitmap


def range_count(q, db, eps) -> torch.Tensor:
    """Exact neighbor counts of q (nq, d) against db (nd, d), (nq,) int32."""
    _check_operands(q, db)
    if q.device.type == "cpu":
        return range_count_ref(q, db, threshold(eps))
    return _launch(q, db, eps, False)[0]


def range_count_bitmap(q, db, eps):
    """(counts (nq,) int32, packed hits (nq, ceil(nd/32)) int32)."""
    _check_operands(q, db)
    if q.device.type == "cpu":
        return range_count_bitmap_ref(q, db, threshold(eps))
    return _launch(q, db, eps, True)
