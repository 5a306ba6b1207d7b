"""Wrappers for the Hamming-filter kernel (port of
``repro.kernels.hamming_filter.ops``).

``hamming_filter_bitmap`` / ``hamming_filter_count`` take q (nq, d) and
db (nd, d) fp32 rows with their packed int32 signatures, the runtime
``eps`` and the Hamming band ``(t_lo, t_hi)`` (``t_lo = -1`` is
full-verify mode), and return per-query int32 counts (and the packed
LSB-first hit words, (nq, ceil(nd/32)) int32).  A CPU tensor runs the
plain version (``ref.py``); a CUDA tensor launches the CUDA kernel
(``csrc/hamming_filter.cu``) or raises.  The kernel masks ragged nq/nd
itself, so no tile padding is needed (the Hamming distances run on the
tensor cores as +-1 int8 products: ``csrc/hamming_filter.cu``);
``_pad_col_hits`` and
``_tail_word_mask`` serve callers whose db carries zero rows past the
live ``n`` (capacity slack), exactly as in the reference.

``return_stats=True`` runs the ``_stats`` bodies: the occupancy triple
``[accept, band, reject]`` of the reference's ``(1, 3)`` whole-call
output, on the reference's padded ``q_tile x db_tile`` grid.  The
kernel counts real pairs only; :func:`pad_grid_stats` adds the pairs of
the zero pad rows the reference's grid holds, so every triple equals
the reference's bit for bit.

The CUDA launch is the operator ``repro_torch::hamming_filter``
(``torch.library.custom_op``): its fake implementation lets a dispatch
trace under ``FakeTensorMode`` take the CUDA branch with no card, and
its cost (``kernels.cost.hamming_filter_cost``) is registered beside it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.range_query import pack_bitmap_t
from ...index.signatures import popcount32
from ...obs import metrics as _metrics
from .. import _build
from ..cost import hamming_filter_cost, register_op
from .ref import hamming_filter_ref

__all__ = [
    "hamming_filter_bitmap",
    "hamming_filter_count",
    "hamming_filter_into",
    "pad_grid_stats",
    "LAUNCHES",
    "STATS_LAUNCHES",
    "DEFAULT_Q_TILE",
    "DEFAULT_DB_TILE",
]

LAUNCHES = "kernel.hamming_filter.launches"
# the `_stats` bodies, keyed by bitmap mode
STATS_LAUNCHES = {False: "kernel.hamming_filter_count_stats.launches",
                  True: "kernel.hamming_filter_bitmap_stats.launches"}
MAX_WORDS = 32  # n_bits <= 1024
ROWS_PER_BLOCK = 128  # the kernel's query rows per block (kRows): grid rows = ceil(nq / 128)
# a block splits its occupancy triple per 32-row group (its warps' rows
# never straddle one), so a chunk of ``chunk_rows`` rows may be any
# multiple of 32
CHUNK_GRAIN = 32
# the reference kernel's tile grid, on which its occupancy triples are defined
DEFAULT_Q_TILE = 128
DEFAULT_DB_TILE = 256


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


def pad_grid_stats(q_sig, db_sig, t_lo: int, t_hi: int, *, chunk: int, n_chunks: int,
                   db_tile: int) -> torch.Tensor:
    """(n_chunks, 3) int32 ``[accept, band, reject]`` of the pad pairs the
    reference's tile grid adds to each chunk of ``chunk`` query rows: the
    query rows are zero-padded to ``n_chunks * chunk`` and the db rows to
    a multiple of ``db_tile``.  A zero-signature pad row has Hamming
    distance popcount(signature) to a real row and 0 to another pad row;
    the occupancy split reads the Hamming distance alone.  This is the
    inverse of the correction ``suggest_margin`` applies, and the only
    definition of those pairs.  Device tensors in, device tensor out; no
    sync."""
    nq, nd = q_sig.shape[0], db_sig.shape[0]
    dev = q_sig.device
    if nq > n_chunks * chunk:
        raise ValueError(f"{nq} query rows do not fit {n_chunks} chunks of {chunk}")
    db_pad = (-nd) % db_tile

    def split(pop):
        accept = pop <= t_lo
        return accept.to(torch.int64), ((pop <= t_hi) & ~accept).to(torch.int64)

    qa, qb = split(popcount32(q_sig).sum(dim=1))
    da, dband = split(popcount32(db_sig).sum(dim=1))
    rows_pad = n_chunks * chunk - nq
    qa = torch.nn.functional.pad(qa, (0, rows_pad)).view(n_chunks, chunk).sum(dim=1)
    qb = torch.nn.functional.pad(qb, (0, rows_pad)).view(n_chunks, chunk).sum(dim=1)
    real = (nq - chunk * torch.arange(n_chunks, device=dev)).clamp(0, chunk)
    q_pad = chunk - real
    corner = q_pad * db_pad  # pad vs pad: Hamming distance 0
    acc = db_pad * qa + q_pad * da.sum() + (corner if t_lo >= 0 else 0)
    band = db_pad * qb + q_pad * dband.sum() + (corner if t_lo < 0 <= t_hi else 0)
    total = db_pad * real + q_pad * nd + corner
    return torch.stack([acc, band, total - acc - band], dim=1).to(torch.int32)


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


def hamming_filter_into(q, db, q_sig, db_sig, eps, t_lo, t_hi, counts, bitmap=None,
                        *, stats=None, chunk_rows=None) -> None:
    """Write counts (and hit words) of q against db into preallocated
    outputs: ``counts`` (nq,) int32 and ``bitmap`` (nq, ld >= ceil(nd/32))
    int32 with unit column stride, both ZERO on entry (the kernel adds
    counts and stores only nonzero words).  ``bitmap=None`` is the
    count-only mode.

    ``stats`` (the ``_stats`` bodies): a contiguous (ceil(nq/chunk_rows),
    3) int32 tensor the real pairs' ``[accept, band, reject]`` of each
    chunk of ``chunk_rows`` query rows are ADDED into; ``chunk_rows`` is a
    multiple of ``CHUNK_GRAIN`` (32) or at least nq (one whole-call
    triple)."""
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
    if stats is not None:
        if chunk_rows is None or chunk_rows <= 0 or (
            chunk_rows % CHUNK_GRAIN and chunk_rows < nq
        ):
            raise ValueError(f"chunk_rows must be a multiple of {CHUNK_GRAIN} or >= nq")
        if (stats.dtype != torch.int32 or stats.shape != (-(-nq // chunk_rows), 3)
                or not stats.is_contiguous()):
            raise ValueError("stats must be a contiguous (ceil(nq/chunk_rows), 3) int32 tensor")
    if q.device.type == "cpu":
        out = hamming_filter_ref(q, db, q_sig, db_sig, eps, t_lo, t_hi,
                                 with_bitmap=bitmap is not None,
                                 stats_chunk=chunk_rows if stats is not None else None)
        counts += out[0]
        if bitmap is not None:
            bitmap[:, :n_words] = out[1]
        if stats is not None:
            stats += out[2]
        return
    if q.device.type != "cuda" or any(
        t is not None and t.device != q.device for t in (counts, bitmap, stats)
    ):
        raise ValueError("hamming_filter outputs must be on the operands' CUDA device")
    if nq == 0 or nd == 0:
        return
    if -(-nq // ROWS_PER_BLOCK) > 65535:
        raise ValueError("too many query rows for one launch")
    _hamming_filter_op(q, db, q_sig, db_sig, float(np.float32(1.0 - float(eps))), int(t_lo), int(t_hi),
                       counts, bitmap, stats, int(chunk_rows) if stats is not None else 0)


def _launch_counter(q, db, q_sig, db_sig, one_minus_eps, t_lo, t_hi, counts, bitmap, stats, chunk_rows) -> str:
    return LAUNCHES if stats is None else STATS_LAUNCHES[bitmap is not None]


@torch.library.custom_op("repro_torch::hamming_filter", mutates_args=("counts", "bitmap", "stats"),
                         device_types="cuda")
def _hamming_filter_op(q: torch.Tensor, db: torch.Tensor, q_sig: torch.Tensor, db_sig: torch.Tensor,
                       one_minus_eps: float, t_lo: int, t_hi: int, counts: torch.Tensor,
                       bitmap: Optional[torch.Tensor], stats: Optional[torch.Tensor], chunk_rows: int) -> None:
    """One launch of ``csrc/hamming_filter.cu`` on checked operands."""
    lib = _build.load("hamming_filter")
    err = lib.hamming_filter_launch(
        q.data_ptr(), db.data_ptr(), q_sig.data_ptr(), db_sig.data_ptr(),
        q.shape[0], db.shape[0], q.shape[1], q_sig.shape[1], one_minus_eps,
        t_lo, t_hi, counts.data_ptr(),
        bitmap.data_ptr() if bitmap is not None else None,
        bitmap.stride(0) if bitmap is not None else 0,
        int(bitmap is not None),
        stats.data_ptr() if stats is not None else None,
        chunk_rows,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "hamming_filter")
    _metrics.counter(_launch_counter(q, db, q_sig, db_sig, one_minus_eps, t_lo, t_hi, counts, bitmap, stats,
                                     chunk_rows)).inc()


@_hamming_filter_op.register_fake
def _(q, db, q_sig, db_sig, one_minus_eps, t_lo, t_hi, counts, bitmap, stats, chunk_rows) -> None:
    return None


register_op(
    "repro_torch::hamming_filter", _launch_counter,
    lambda q, db, q_sig, db_sig, one_minus_eps, t_lo, t_hi, counts, bitmap, stats, chunk_rows: hamming_filter_cost(
        q.shape[0], db.shape[0], q.shape[1], q_sig.shape[1], bitmap=bitmap is not None,
        stats_chunks=0 if stats is None else stats.shape[0]),
)


def _whole_call_stats(q_sig, db_sig, t_lo, t_hi, q_tile, db_tile):
    """A zeroed (1, 3) triple for the kernel and its pad-grid complement
    on the reference's ``q_tile x db_tile`` grid."""
    chunk = -(-max(q_sig.shape[0], 1) // q_tile) * q_tile
    pad = pad_grid_stats(q_sig, db_sig, t_lo, t_hi, chunk=chunk, n_chunks=1, db_tile=db_tile)
    return torch.zeros((1, 3), dtype=torch.int32, device=q_sig.device), pad


def hamming_filter_count(q, db, q_sig, db_sig, eps, t_hi, *, t_lo=-1, return_stats: bool = False,
                         q_tile: int = DEFAULT_Q_TILE, db_tile: int = DEFAULT_DB_TILE):
    """Band-contract neighbor counts, (nq,) int32; with ``return_stats``
    ``(counts, stats)``, stats the reference's (1, 3) int32 whole-call
    occupancy on the padded ``q_tile x db_tile`` grid."""
    counts = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    if not return_stats:
        hamming_filter_into(q, db, q_sig, db_sig, eps, t_lo, t_hi, counts)
        return counts
    stats, pad = _whole_call_stats(q_sig, db_sig, int(t_lo), int(t_hi), q_tile, db_tile)
    hamming_filter_into(q, db, q_sig, db_sig, eps, t_lo, t_hi, counts,
                        stats=stats, chunk_rows=max(q.shape[0], 1))
    return counts, stats + pad


def hamming_filter_bitmap(q, db, q_sig, db_sig, eps, t_hi, *, t_lo=-1, return_stats: bool = False,
                          q_tile: int = DEFAULT_Q_TILE, db_tile: int = DEFAULT_DB_TILE):
    """(counts (nq,) int32, packed hits (nq, ceil(nd/32)) int32), and the
    (1, 3) occupancy triple with ``return_stats`` (see
    ``hamming_filter_count``)."""
    nq, nd = q.shape[0], db.shape[0]
    counts = torch.zeros(nq, dtype=torch.int32, device=q.device)
    bitmap = torch.zeros((nq, -(-nd // 32)), dtype=torch.int32, device=q.device)
    if not return_stats:
        hamming_filter_into(q, db, q_sig, db_sig, eps, t_lo, t_hi, counts, bitmap)
        return counts, bitmap
    stats, pad = _whole_call_stats(q_sig, db_sig, int(t_lo), int(t_hi), q_tile, db_tile)
    hamming_filter_into(q, db, q_sig, db_sig, eps, t_lo, t_hi, counts, bitmap,
                        stats=stats, chunk_rows=max(nq, 1))
    return counts, bitmap, stats + pad
