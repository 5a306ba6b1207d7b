"""Wrapper of the row popcount kernel (``csrc/popcount.cu``).

``row_popcount(words)`` returns the set bits of each row of an (R, W)
int32 slab of packed LSB-first words as (R,) int32: pass 2's exact
neighbor counts (the reference's ``jnp.sum(lax.population_count(
bitmap), axis=1)``, ``repro/kernels/label_prop/ops.py:174``).  With
``lo``/``hi`` ((R,) int32) it counts only bits lo_r <= b < hi_r of row
r: KNN-BLOCK's candidate windows (``core/baselines.py``).  A CPU tensor
runs the plain version (``ref.py``); a CUDA tensor launches the kernel
(the operator ``repro_torch::row_popcount``, its fake implementation and
its cost ``kernels.cost.row_popcount_cost`` beside it) or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...obs import metrics as _metrics
from .. import _build
from ..cost import register_op, row_popcount_cost
from .ref import row_popcount_ref

__all__ = ["row_popcount", "LAUNCHES"]

LAUNCHES = {"row_popcount": "kernel.row_popcount.launches"}


def _check(words, lo, hi):
    if words.dtype != torch.int32 or words.dim() != 2 or not words.is_contiguous():
        raise ValueError("words must be a contiguous (R, W) int32 slab")
    if (lo is None) != (hi is None):
        raise ValueError("pass both lo and hi, or neither")
    for t in (lo, hi):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.shape != (words.shape[0],) or not t.is_contiguous():
            raise ValueError(f"lo and hi must be contiguous ({words.shape[0]},) int32 tensors")
        if t.device != words.device:
            raise ValueError("row_popcount operands must share one device")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {words.device}")


def row_popcount(words: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """(R,) int32 set bits of each row, within [lo_r, hi_r) when given."""
    _check(words, lo, hi)
    if words.device.type == "cpu":
        return row_popcount_ref(words, lo, hi)
    r, w = words.shape
    if r == 0:
        return torch.empty(r, dtype=torch.int32, device=words.device)
    if w == 0:
        return torch.zeros(r, dtype=torch.int32, device=words.device)
    return _row_popcount_op(words, lo, hi)


@torch.library.custom_op("repro_torch::row_popcount", mutates_args=(), device_types="cuda")
def _row_popcount_op(words: torch.Tensor, lo: Optional[torch.Tensor], hi: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of ``csrc/popcount.cu`` on checked operands."""
    r, w = words.shape
    out = torch.empty(r, dtype=torch.int32, device=words.device)
    err = _build.load("popcount").row_popcount_launch(
        words.data_ptr(), r, w, lo.data_ptr() if lo is not None else None,
        hi.data_ptr() if hi is not None else None, out.data_ptr(),
        torch.cuda.current_stream(words.device).cuda_stream,
    )
    _build.check(err, "row_popcount")
    _metrics.counter(LAUNCHES["row_popcount"]).inc()
    return out


@_row_popcount_op.register_fake
def _(words, lo, hi):
    return words.new_empty((words.shape[0],), dtype=torch.int32)


register_op("repro_torch::row_popcount", lambda words, lo, hi: LAUNCHES["row_popcount"],
            lambda words, lo, hi: row_popcount_cost(words.shape[0], words.shape[1]))
