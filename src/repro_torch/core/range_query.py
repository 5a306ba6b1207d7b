"""Packed adjacency words: the LSB-first uint32 bit order shared by the
signatures, the sweep bitmaps and the label-propagation slab (port of
``repro.core.range_query.pack_bitmap`` / ``unpack_bitmap``).

Bit j of word w in row i is set iff hits[i, 32*w + j].  The numpy pair
works in ``uint32``; the torch twins carry the same bits in ``int32``
tensors (torch on the CPU has no ``uint32`` shifts), so
``t.cpu().numpy().view(np.uint32)`` gives the reference's bytes.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pack_bitmap",
    "unpack_bitmap",
    "pack_bitmap_t",
    "unpack_bitmap_t",
]


def _num_words(n: int) -> int:
    return (n + 31) // 32


def pack_bitmap(hits: np.ndarray) -> np.ndarray:
    """Pack a boolean (nq, nd) matrix into uint32 words (nq, ceil(nd/32))."""
    nq, nd = hits.shape
    nw = _num_words(nd)
    padded = np.zeros((nq, nw * 32), dtype=bool)
    padded[:, :nd] = hits
    bits = padded.reshape(nq, nw, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return (bits << shifts[None, None, :]).sum(axis=2, dtype=np.uint32)


def unpack_bitmap(bitmap: np.ndarray, nd: int) -> np.ndarray:
    """Inverse of :func:`pack_bitmap`."""
    bitmap = np.asarray(bitmap)
    nq, nw = bitmap.shape
    shifts = np.arange(32, dtype=np.uint32)
    bits = (bitmap[:, :, None] >> shifts[None, None, :]) & np.uint32(1)
    return bits.reshape(nq, nw * 32)[:, :nd].astype(bool)


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
