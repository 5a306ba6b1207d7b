"""Plain PyTorch version of the fused Hamming-filter + exact-verify
kernel (the port's counterpart of ``repro.kernels.hamming_filter.ref``).

Same predicate (``index.signatures.band_hits``) as the CUDA kernel:
fp32 dots from one ``q @ db.T`` product with TF32 off, table popcount
of the XORed signature words.  Blocked over both axes so the
(rows, cols, words) XOR tensor stays bounded at main-path shapes.
"""

from __future__ import annotations

import torch

from ... import exact_fp32
from ...core.range_query import pack_bitmap_t
from ...index.signatures import band_hits, hamming_words

__all__ = ["hamming_filter_ref"]


def hamming_filter_ref(q, db, q_sig, db_sig, eps, t_lo, t_hi, *,
                       with_bitmap: bool = True, block: int = 1024):
    """(counts int32 (nq,), packed int32 hits (nq, ceil(nd/32)) or None)."""
    exact_fp32()
    nq, nd = q.shape[0], db.shape[0]
    counts = torch.zeros(nq, dtype=torch.int32, device=q.device)
    bitmap = (
        torch.zeros((nq, -(-nd // 32)), dtype=torch.int32, device=q.device)
        if with_bitmap else None
    )
    for i in range(0, nq, block):
        qi, qsi = q[i : i + block], q_sig[i : i + block]
        for j in range(0, nd, block):  # block % 32 == 0: word-aligned
            dots = qi @ db[j : j + block].T
            ham = hamming_words(qsi, db_sig[j : j + block])
            # a Python-float threshold compares in fp32, as in the reference
            hit = band_hits(dots, ham, float(eps), t_lo, t_hi)
            counts[i : i + block] += hit.sum(dim=1, dtype=torch.int32)
            if with_bitmap:
                words = pack_bitmap_t(hit)
                bitmap[i : i + block, j // 32 : j // 32 + words.shape[1]] = words
    return counts, bitmap
