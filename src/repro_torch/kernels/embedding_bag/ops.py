"""Wrapper for the EmbeddingBag kernel (port of
``repro.kernels.embedding_bag.ops``).

``embedding_bag(table, ids, *, combiner)`` takes a (V, D) fp32 or bf16
table and (B, L) int32 ids, every negative id padding, and returns the
(B, D) fp32 bag sums (``"sum"``) or means over the valid ids
(``"mean"``).  A CPU table runs the plain version (``ref.py``); a CUDA
table launches ``csrc/embedding_bag.cu`` or raises.  The reference
wrapper's padding of B to the batch tile exists for the TPU's grid and
is left out: the kernel masks the ragged last block itself.

The CUDA launch is the operator ``repro_torch::embedding_bag``
(``torch.library.custom_op``; its real implementation is the raw launch
function ``_launch``): its fake implementation gives the (B, D) fp32
output, so a dispatch trace takes the launch path with no card (a fake
CUDA or a ``meta`` table), and its cost
(``kernels.cost.embedding_bag_cost``) is registered beside it.
"""

from __future__ import annotations

import torch

from ...obs import metrics as _metrics
from .. import _build
from ..cost import embedding_bag_cost, register_op
from .ref import embedding_bag_ref

__all__ = ["embedding_bag", "LAUNCHES", "COMBINERS"]

LAUNCHES = {"embedding_bag": "kernel.embedding_bag.launches"}
COMBINERS = ("sum", "mean")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(table, ids, combiner):
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got {combiner!r}")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"table must be (V, D) and ids (B, L), got {tuple(table.shape)}, {tuple(ids.shape)}")
    if table.shape[0] == 0:
        raise ValueError("the table has no rows")
    if table.dtype not in _DTYPES:
        raise TypeError(f"table must be one of {list(_DTYPES)}, got {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if table.device != ids.device:
        raise ValueError(f"table and ids lie on {table.device} and {ids.device}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")


def _launch(table, ids, combiner):
    (b, length), (v, d) = ids.shape, table.shape
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    err = _build.load("embedding_bag").embedding_bag_launch(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), _DTYPES[table.dtype],
        b, length, v, d, int(combiner == "mean"), torch.cuda.current_stream(table.device).cuda_stream,
    )
    _build.check(err, "embedding_bag")
    _metrics.counter(LAUNCHES["embedding_bag"]).inc()
    return out


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, *, combiner: str = "sum") -> torch.Tensor:
    """EmbeddingBag: (V, D) table, (B, L) int32 ids (negative = padding,
    >= V reads row V - 1) -> (B, D) fp32."""
    _check(table, ids, combiner)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, combiner=combiner)
    if table.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {table.device}")
    return _embedding_bag_op(table, ids, combiner == "mean")


@torch.library.custom_op("repro_torch::embedding_bag", mutates_args=(), device_types="cuda")
def _embedding_bag_op(table: torch.Tensor, ids: torch.Tensor, mean: bool) -> torch.Tensor:
    """One ``embedding_bag`` launch on checked operands: (B, D) fp32."""
    return _launch(table, ids, "mean" if mean else "sum")


@_embedding_bag_op.register_fake
def _(table, ids, mean):
    return table.new_empty((ids.shape[0], table.shape[1]), dtype=torch.float32)


register_op("repro_torch::embedding_bag", lambda table, ids, mean: LAUNCHES["embedding_bag"],
            lambda table, ids, mean: embedding_bag_cost(ids.shape[0], ids.shape[1], table.shape[1],
                                                        elem=table.element_size()))
