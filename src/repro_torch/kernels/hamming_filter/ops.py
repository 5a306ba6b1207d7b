"""Wrappers for the Hamming-filter kernel (port of
``repro.kernels.hamming_filter.ops``).

``hamming_filter_bitmap`` / ``hamming_filter_count`` take q (nq, d) and
db (nd, d) fp32 rows with their packed int32 signatures, the runtime
``eps`` and the Hamming band ``(t_lo, t_hi)`` (``t_lo = -1`` is
full-verify mode), and return per-query int32 counts (and the packed
LSB-first hit words, (nq, ceil(nd/32)) int32).  A CPU tensor runs the
plain version (``ref.py``); a CUDA tensor launches the CUDA kernel
(``csrc/hamming_filter.cu``) or raises.  The kernel masks ragged nq/nd
itself, so no tile padding is needed; ``_pad_col_hits`` and
``_tail_word_mask`` serve callers whose db carries zero rows past the
live ``n`` (capacity slack), exactly as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.range_query import pack_bitmap_t
from ...index.signatures import popcount32
from ...obs import metrics as _metrics
from .. import _build
from .ref import hamming_filter_ref

__all__ = [
    "hamming_filter_bitmap",
    "hamming_filter_count",
    "hamming_filter_into",
    "LAUNCHES",
]

LAUNCHES = "kernel.hamming_filter.launches"
MAX_WORDS = 32  # n_bits <= 1024: the signature tiles' shared-memory budget


def _tail_word_mask(n_words: int, n: int, device) -> torch.Tensor:
    """int32 per-word masks clearing bits for columns >= n."""
    valid = torch.arange(n_words * 32, device=device) < n
    return pack_bitmap_t(valid[None, :])[0]


def _pad_col_hits(q_sig: torch.Tensor, eps, t_lo, t_hi, n_pad: int) -> torch.Tensor:
    """Per-query hits contributed by ``n_pad`` zero db rows (zero vector,
    zero signature): Hamming distance popcount(q_sig), dot 0, fed to the
    band predicate with ``1 - eps`` taken in fp32 as the reference does —
    a sure-accept when popcount <= t_lo, a band hit only when eps > 1."""
    pop = popcount32(q_sig).sum(dim=1, dtype=torch.int32)
    one_minus = torch.tensor(1.0, dtype=torch.float32) - torch.tensor(eps, dtype=torch.float32)
    band_ok = bool(0.0 > float(one_minus))
    passes = (pop <= int(t_lo)) | ((pop <= int(t_hi)) & band_ok)
    return torch.where(passes, n_pad, 0).to(torch.int32)


def _check_operands(q, db, q_sig, db_sig):
    if q.device != db.device or q_sig.device != q.device or db_sig.device != q.device:
        raise ValueError("hamming_filter operands must share one device")
    if q.dtype != torch.float32 or db.dtype != torch.float32:
        raise TypeError("q and db must be float32")
    if q_sig.dtype != torch.int32 or db_sig.dtype != torch.int32:
        raise TypeError("signatures must be int32 words")
    if q.dim() != 2 or db.dim() != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and db {tuple(db.shape)} must be (n, d) with equal d")
    w = q_sig.shape[1]
    if q_sig.shape != (q.shape[0], w) or db_sig.shape != (db.shape[0], w):
        raise ValueError("signature rows must match q/db rows with equal word counts")
    if not 0 < w <= MAX_WORDS:
        raise ValueError(f"signatures must have 1..{MAX_WORDS} words, got {w}")
    for t in (q, db, q_sig, db_sig):
        if not t.is_contiguous():
            raise ValueError("hamming_filter operands must be contiguous")


def hamming_filter_into(q, db, q_sig, db_sig, eps, t_lo, t_hi, counts, bitmap=None) -> None:
    """Write counts (and hit words) of q against db into preallocated
    outputs: ``counts`` (nq,) int32 and ``bitmap`` (nq, ld >= ceil(nd/32))
    int32 with unit column stride, both ZERO on entry (the kernel adds
    counts and stores only nonzero words).  ``bitmap=None`` is the
    count-only mode."""
    _check_operands(q, db, q_sig, db_sig)
    nq, nd = q.shape[0], db.shape[0]
    n_words = -(-nd // 32)
    if counts.dtype != torch.int32 or counts.shape != (nq,) or not counts.is_contiguous():
        raise ValueError("counts must be a contiguous (nq,) int32 tensor")
    if bitmap is not None and (
        bitmap.dtype != torch.int32 or bitmap.dim() != 2 or bitmap.shape[0] != nq
        or bitmap.shape[1] < n_words or bitmap.stride(1) != 1
    ):
        raise ValueError("bitmap must be (nq, >= ceil(nd/32)) int32 with unit column stride")
    if q.device.type == "cpu":
        c, b = hamming_filter_ref(q, db, q_sig, db_sig, eps, t_lo, t_hi,
                                  with_bitmap=bitmap is not None)
        counts += c
        if bitmap is not None:
            bitmap[:, :n_words] = b
        return
    if q.device.type != "cuda" or counts.device != q.device or (
        bitmap is not None and bitmap.device != q.device
    ):
        raise ValueError("hamming_filter outputs must be on the operands' CUDA device")
    if nq == 0 or nd == 0:
        return
    if -(-nq // 32) > 65535:
        raise ValueError("too many query rows for one launch")
    lib = _build.load("hamming_filter")
    err = lib.hamming_filter_launch(
        q.data_ptr(), db.data_ptr(), q_sig.data_ptr(), db_sig.data_ptr(),
        nq, nd, q.shape[1], q_sig.shape[1], float(np.float32(1.0 - float(eps))),
        int(t_lo), int(t_hi), counts.data_ptr(),
        bitmap.data_ptr() if bitmap is not None else None,
        bitmap.stride(0) if bitmap is not None else 0,
        int(bitmap is not None), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "hamming_filter")
    _metrics.counter(LAUNCHES).inc()


def hamming_filter_count(q, db, q_sig, db_sig, eps, t_hi, *, t_lo=-1) -> torch.Tensor:
    """Band-contract neighbor counts, (nq,) int32."""
    counts = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    hamming_filter_into(q, db, q_sig, db_sig, eps, t_lo, t_hi, counts)
    return counts


def hamming_filter_bitmap(q, db, q_sig, db_sig, eps, t_hi, *, t_lo=-1):
    """(counts (nq,) int32, packed hits (nq, ceil(nd/32)) int32)."""
    nq, nd = q.shape[0], db.shape[0]
    counts = torch.zeros(nq, dtype=torch.int32, device=q.device)
    bitmap = torch.zeros((nq, -(-nd // 32)), dtype=torch.int32, device=q.device)
    hamming_filter_into(q, db, q_sig, db_sig, eps, t_lo, t_hi, counts, bitmap)
    return counts, bitmap
