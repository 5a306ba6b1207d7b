"""Plain PyTorch version of the row popcount kernel: the port's
counterpart of ``jnp.sum(lax.population_count(bitmap), axis=1)``
(``repro.kernels.label_prop.ops``), with an optional bit range per row.

Torch has no popcount op, so ``popcount32`` counts each word through a
byte table; a range masks the words first.
"""

from __future__ import annotations

import torch

from ...core.range_query import _words_to_int32
from ...index.signatures import popcount32

__all__ = ["row_popcount_ref"]


def _range_mask(lo: torch.Tensor, hi: torch.Tensor, n_words: int) -> torch.Tensor:
    """(R, n_words) int32 words with exactly the bits [lo_r, hi_r) of
    each row set (LSB-first, 32 bits a word)."""
    base = 32 * torch.arange(n_words, dtype=torch.int64, device=lo.device)
    a = (lo.long()[:, None] - base).clamp(0, 32)
    b = (hi.long()[:, None] - base).clamp(0, 32)
    one = torch.ones((), dtype=torch.int64, device=lo.device)
    return _words_to_int32(torch.where(b > a, (one << b) - (one << a), 0))


def row_popcount_ref(words: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """(R,) int32 set bits of each row of an (R, W) int32 slab; with
    ``lo``/``hi`` ((R,) int32) only the bits b with lo_r <= b < hi_r."""
    if lo is not None:
        words = words & _range_mask(lo, hi, words.shape[1])
    return popcount32(words).sum(dim=1, dtype=torch.int32)
