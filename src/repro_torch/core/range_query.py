"""Range queries: the exact engine's counts and packed adjacency rows,
and the LSB-first uint32 bit order shared by the signatures, the sweep
bitmaps and the label-propagation slab (port of
``repro.core.range_query``).

A range query for P returns N = {Q : d_cos(P, Q) < eps}, i.e. the rows
with ``<P, Q> > 1 - eps`` on normalized vectors.  ``range_counts``,
``range_bitmap`` and ``range_counts_and_bitmap`` compute it for a block
of queries against a database through the ``range_count`` kernel on
``cuda`` and its plain version on the CPU.  On ``cuda`` one launch takes
every query row (the kernel masks ragged tiles itself); on the CPU the
plain version runs ``block_size`` query rows at a time (the reference's
bound on the score tile; here it bounds the host working set).

Bit j of word w in row i is set iff hits[i, 32*w + j].  The numpy pair
works in ``uint32``; the torch twins carry the same bits in ``int32``
tensors (torch on the CPU has no ``uint32`` shifts), so
``t.cpu().numpy().view(np.uint32)`` gives the reference's bytes.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "range_counts",
    "range_bitmap",
    "range_counts_and_bitmap",
    "bitmap_row_to_indices",
    "neighbor_lists",
    "pack_bitmap",
    "unpack_bitmap",
    "pack_bitmap_t",
    "unpack_bitmap_t",
]


def _num_words(n: int) -> int:
    return (n + 31) // 32


def pack_bitmap(hits: np.ndarray) -> np.ndarray:
    """Pack a boolean (nq, nd) matrix into uint32 words (nq, ceil(nd/32)).

    Bytes are packed LSB-first and read as little-endian words, which is
    the reference's bit order with one byte per 8 bits of work space."""
    hits = np.asarray(hits, dtype=bool)
    nq, nd = hits.shape
    nw = _num_words(nd)
    padded = np.zeros((nq, nw * 32), dtype=bool)
    padded[:, :nd] = hits
    packed = np.packbits(padded, axis=1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").astype(np.uint32)


def unpack_bitmap(bitmap: np.ndarray, nd: int) -> np.ndarray:
    """Inverse of :func:`pack_bitmap`."""
    words = np.ascontiguousarray(bitmap, dtype="<u4")
    nq, nw = words.shape
    bits = np.unpackbits(words.view(np.uint8).reshape(nq, 4 * nw), axis=1,
                         count=nd, bitorder="little")
    return bits.view(bool)


def _words_to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor holding the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def pack_bitmap_t(hits: torch.Tensor) -> torch.Tensor:
    """(nq, nd) bool -> (nq, ceil(nd/32)) int32 words, LSB-first."""
    nq, nd = hits.shape
    nw = _num_words(nd)
    bits = torch.zeros((nq, nw * 32), dtype=torch.int64, device=hits.device)
    bits[:, :nd] = hits.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=hits.device)
    return _words_to_int32((bits.view(nq, nw, 32) << shifts).sum(dim=2))


def unpack_bitmap_t(bitmap: torch.Tensor, nd: int) -> torch.Tensor:
    """(nq, W) int32 words -> (nq, nd) bool.  ``>>`` sign-extends an
    int32, so each bit is taken as ``(w >> k) & 1``."""
    nq, nw = bitmap.shape
    shifts = torch.arange(32, dtype=torch.int32, device=bitmap.device)
    bits = (bitmap[:, :, None] >> shifts) & 1
    return bits.reshape(nq, nw * 32)[:, :nd].to(torch.bool)


# -- the exact range query -------------------------------------------------


def _operand(x, device) -> torch.Tensor:
    """A tensor stays where it is; an array goes to ``device``."""
    if torch.is_tensor(x):
        return x.contiguous()
    from .. import resolve_device

    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(resolve_device(device))


def _query_blocks(q: torch.Tensor, block_size: int):
    """Query row blocks: ``block_size`` rows each for the plain version
    on the CPU, one block per launch's row limit on ``cuda``."""
    from ..kernels.range_count.ops import MAX_QUERY_ROWS

    step = block_size if q.device.type == "cpu" else MAX_QUERY_ROWS
    return [q[s : s + step] for s in range(0, max(q.shape[0], 1), step)]


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def range_counts_and_bitmap(queries, db, eps, *, block_size: int = 2048, device=None):
    """(counts (nq,) int32, packed rows (nq, ceil(nd/32)) int32) from
    the ``range_count_bitmap`` kernel."""
    from ..kernels.range_count import range_count_bitmap

    q, d = _operand(queries, device), _operand(db, device)
    parts = [range_count_bitmap(b, d, eps) for b in _query_blocks(q, block_size)]
    return _cat([c for c, _ in parts]), _cat([b for _, b in parts])


def range_counts(queries, db, eps, *, block_size: int = 2048, device=None) -> torch.Tensor:
    """Exact neighbor counts |{j : d_cos(q_i, db_j) < eps}| per query,
    (nq,) int32 on the operands' device."""
    from ..kernels.range_count import range_count

    q, d = _operand(queries, device), _operand(db, device)
    return _cat([range_count(b, d, eps) for b in _query_blocks(q, block_size)])


def range_bitmap(queries, db, eps, *, block_size: int = 2048, device=None) -> torch.Tensor:
    """Packed int32 adjacency rows: bit j of row i set iff d(q_i, db_j) < eps."""
    return range_counts_and_bitmap(queries, db, eps, block_size=block_size, device=device)[1]


def bitmap_row_to_indices(row: np.ndarray, nd: int) -> np.ndarray:
    """Decode one packed row to sorted neighbor indices (host-side)."""
    return np.nonzero(unpack_bitmap(np.asarray(row)[None, :], nd)[0])[0]


def neighbor_lists(data: np.ndarray, eps: float, block_size: int = 4096, *,
                   backend="exact", device=None):
    """Host-side neighbor lists for the whole dataset (self included):
    ``list[np.ndarray]`` of sorted indices, from ``backend`` fit on
    ``data`` and queried ``block_size`` rows at a time."""
    from ..index import as_fitted  # deferred: repro_torch.index imports this module

    return as_fitted(backend, np.asarray(data, np.float32), device=device).neighbor_lists(
        eps, block_size=block_size
    )
