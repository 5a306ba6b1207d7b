"""Plain PyTorch version of the fused Hamming-filter + exact-verify
kernel (the port's counterpart of ``repro.kernels.hamming_filter.ref``).

Same predicate (``index.signatures.band_hits``) as the CUDA kernel:
fp32 dots from one ``q @ db.T`` product with TF32 off, table popcount
of the XORed signature words.  Blocked over both axes so the
(rows, cols, words) XOR tensor stays bounded at main-path shapes.
With ``stats_chunk`` it also counts the occupancy of the ``_stats``
bodies from the same Hamming blocks: per chunk of ``stats_chunk`` query
rows, the real pairs' ``[accept, band, reject]``.
"""

from __future__ import annotations

import torch

from ... import exact_fp32
from ...core.range_query import pack_bitmap_t
from ...index.signatures import band_hits, hamming_words

__all__ = ["hamming_filter_ref"]


def hamming_filter_ref(q, db, q_sig, db_sig, eps, t_lo, t_hi, *,
                       with_bitmap: bool = True, stats_chunk=None, block: int = 1024):
    """(counts int32 (nq,), packed int32 hits (nq, ceil(nd/32)) or None),
    plus the int32 (ceil(nq/stats_chunk), 3) occupancy triples when
    ``stats_chunk`` is given."""
    exact_fp32()
    nq, nd = q.shape[0], db.shape[0]
    dev = q.device
    counts = torch.zeros(nq, dtype=torch.int32, device=dev)
    bitmap = torch.zeros((nq, -(-nd // 32)), dtype=torch.int32, device=dev) if with_bitmap else None
    if stats_chunk is not None:
        row_acc = torch.zeros(nq, dtype=torch.int64, device=dev)
        row_band = torch.zeros(nq, dtype=torch.int64, device=dev)
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
            if stats_chunk is not None:
                accept = ham <= t_lo
                row_acc[i : i + block] += accept.sum(dim=1)
                row_band[i : i + block] += ((ham <= t_hi) & ~accept).sum(dim=1)
    if stats_chunk is None:
        return counts, bitmap
    n_chunks = -(-nq // stats_chunk)
    pad = n_chunks * stats_chunk - nq
    acc = torch.nn.functional.pad(row_acc, (0, pad)).view(n_chunks, -1).sum(dim=1)
    band = torch.nn.functional.pad(row_band, (0, pad)).view(n_chunks, -1).sum(dim=1)
    rows = (nq - stats_chunk * torch.arange(n_chunks, device=dev)).clamp(max=stats_chunk)
    stats = torch.stack([acc, band, rows * nd - acc - band], dim=1).to(torch.int32)
    return counts, bitmap, stats
