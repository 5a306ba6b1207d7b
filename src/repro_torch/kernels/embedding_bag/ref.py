"""Plain PyTorch version of EmbeddingBag (the port's counterpart of
``repro.kernels.embedding_bag.ref`` with the ops wrapper's ``mean``
combiner, ``repro/kernels/embedding_bag/ops.py:31-33``).

Every negative id is padding and adds nothing; an id >= V reads row
V - 1, as the TPU kernel's row gather clamps.  The gathered rows are
summed in fp32 whatever the table's type (fp32 or bf16), so the result
is fp32; ``mean`` divides by the bag's valid ids, at least 1, so an
all-padding bag gives 0.
"""

from __future__ import annotations

import torch

__all__ = ["embedding_bag_ref"]


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor, *, combiner: str = "sum") -> torch.Tensor:
    """table (V, D); ids (B, L) integer, negative = padding -> (B, D) fp32."""
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).clamp_(max=table.shape[0] - 1).long()
    rows = table[safe].to(torch.float32)                 # (B, L, D)
    out = rows.masked_fill_(~valid[..., None], 0.0).sum(dim=1)
    if combiner == "mean":
        out = out / valid.sum(dim=1, keepdim=True).clamp_(min=1)
    return out
