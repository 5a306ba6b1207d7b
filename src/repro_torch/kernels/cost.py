"""What one kernel launch costs: its operations and bytes, and the least
time the H100 could take for them.

These functions are the one source of the bound column of the kernel
table (``PERF.md`` §6) and of the ``bound_ms`` that ``chip_smoke.py``
prints beside each kernel row, and they are what a dispatch trace
(``repro_torch.launch.trace_analysis``) charges for a kernel operator.
Bytes count each input read once and each output written once; the
operations are the ones that decide the kernel's work at the rate it
runs them (the Hamming filter's distances as int8 tensor-core
products, the RMI forward's fp32 multiply-adds).  Work that depends on
the data (a fixpoint's rounds) is a parameter.

Constants: the NVIDIA H100 SXM 80GB data sheet, 700 W: dense tensor-core
rates, the fp32 rate outside the tensor cores, HBM3's bytes a second and
NVLink's bytes a second in each direction.

Each kernel operator (``torch.library.custom_op``, namespace
``repro_torch``) registers here with :func:`register_op`: the launch
counter its real launch adds to and its cost, both read from the
operator's arguments (shapes only, so a fake tensor will do).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "HBM_BYTES_PER_S", "FP32_FLOPS", "TF32_FLOPS", "BF16_FLOPS", "INT8_OPS", "NVLINK_BYTES_PER_S",
    "KernelCost", "bound_ms", "register_op", "KERNEL_OPS", "KernelOp",
    "hamming_filter_cost", "rmi_mlp_cost", "rmi_predict_cost", "row_popcount_cost", "label_prop_rect_cost",
    "col_reduce_cost", "label_prop_update_cost", "label_prop_fixpoint_cost", "attention_span", "attention_cost",
    "attention_bwd_cost",
    "embedding_bag_cost",
]

HBM_BYTES_PER_S = 3.35e12    # HBM3
FP32_FLOPS = 67e12           # fp32 outside the tensor cores
TF32_FLOPS = 494.7e12        # tf32 tensor cores, dense
BF16_FLOPS = 989e12          # bf16 tensor cores, dense
INT8_OPS = 1979e12           # int8 tensor cores, dense
NVLINK_BYTES_PER_S = 450e9   # NVLink 4, each direction


@dataclass(frozen=True)
class KernelCost:
    """``ops`` operations at ``peak`` a second, ``bytes`` moved."""

    ops: float
    bytes: float
    peak: float = FP32_FLOPS

    def __add__(self, other: "KernelCost") -> "KernelCost":
        if self.ops and other.ops and self.peak != other.peak:
            raise ValueError("costs at two different peaks do not add")
        return KernelCost(self.ops + other.ops, self.bytes + other.bytes,
                          self.peak if self.ops else other.peak)

    def scaled(self, k: float) -> "KernelCost":
        return KernelCost(self.ops * k, self.bytes * k, self.peak)

    def bound_ms(self) -> Tuple[float, str]:
        return bound_ms(self.bytes, self.ops, self.peak)


def bound_ms(n_bytes: float, ops: float = 0.0, peak: float = FP32_FLOPS) -> Tuple[float, str]:
    """(ms, "bytes" | "operations"): the larger of the two times."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def hamming_filter_cost(nq: int, nd: int, d: int, w: int, *, bitmap: bool, stats_chunks: int = 0) -> KernelCost:
    """K1: q, db and both signature tables read, the counts (and the hit
    words, and the ``[accept, band, reject]`` triples) written; the
    Hamming distances as ±1 int8 products, 2·nq·nd·n_bits operations."""
    words_out = -(-nd // 32) if bitmap else 0
    n_bytes = 4 * (nq * d + nd * d + (nq + nd) * w + nq * (1 + words_out)) + 12 * stats_chunks
    return KernelCost(2.0 * nq * nd * 32 * w, n_bytes, INT8_OPS)


def rmi_mlp_cost(n: int, d_in: int, widths: Sequence[int], experts: int) -> KernelCost:
    """One stage launch: x read, every expert's weights and biases read,
    the (E, n) outputs written; 2·n·E·Σ in·out fp32 multiply-adds over
    the hidden layers and the head."""
    dims = [d_in, *widths, 1]
    pairs = list(zip(dims, dims[1:]))
    params = experts * sum(a * b + b for a, b in pairs)
    return KernelCost(2.0 * n * experts * sum(a * b for a, b in pairs), 4 * (n * d_in + params + n * experts),
                      FP32_FLOPS)


def rmi_predict_cost(n: int, d_in: int, widths: Sequence[int], stage_sizes: Sequence[int]) -> KernelCost:
    """A predict: one :func:`rmi_mlp_cost` a stage."""
    total = KernelCost(0.0, 0.0, FP32_FLOPS)
    for e in stage_sizes:
        total = total + rmi_mlp_cost(n, d_in, widths, e)
    return total


def row_popcount_cost(r: int, w: int) -> KernelCost:
    """The slab read once, one count a row written."""
    return KernelCost(0.0, 4 * (r * w + r))


def label_prop_rect_cost(r: int, w: int) -> KernelCost:
    """K2: the slab, the column labels and the row labels read, the row
    minima written."""
    return KernelCost(0.0, 4 * (r * w + 32 * w + 2 * r))


def col_reduce_cost(r: int, w: int) -> KernelCost:
    """K3: the slab and two row vectors read, two column vectors written."""
    return KernelCost(0.0, 4 * (r * w + 2 * r + 64 * w))


def label_prop_update_cost(cap: int, r: int) -> KernelCost:
    """The update: labels and positions read, the next labels written,
    the row minima read."""
    return KernelCost(0.0, 4 * (3 * cap + r))


def label_prop_fixpoint_cost(r: int, w: int, rounds: int) -> KernelCost:
    """A fixpoint of ``rounds`` rounds, each K2's bytes and the update's."""
    return (label_prop_rect_cost(r, w) + label_prop_update_cost(32 * w, r)).scaled(rounds)


@lru_cache(maxsize=4096)
def attention_span(sq: int, sk: int, causal: bool, window: Optional[int] = None,
                   q_offset: Optional[int] = None) -> Tuple[int, int]:
    """(pairs, keys) of one (batch row, query head) of a call: the
    (query, key) pairs the mask keeps and the keys some query reads.
    Query ``i`` sits at ``q_offset + i`` (``Sk - Sq`` unless given) and
    keeps key ``j`` where ``j <= q_offset + i`` when causal and ``j >
    q_offset + i - window`` when windowed, the kernel's own mask (the
    tiles it skips hold no kept pair)."""
    off = sk - sq if q_offset is None else int(q_offset)
    pos = np.arange(off, off + sq, dtype=np.int64)
    hi = np.minimum(sk - 1, pos) if causal else np.full(sq, sk - 1, dtype=np.int64)
    lo = np.maximum(0, pos - int(window) + 1) if window is not None else np.zeros(sq, dtype=np.int64)
    n = np.maximum(0, hi - lo + 1)
    live = n > 0
    keys = int(hi[live].max() - lo[live].min() + 1) if live.any() else 0
    return int(n.sum()), keys


def attention_cost(b: int, hq: int, hkv: int, sq: int, sk: int, d: int, dv: int, *, causal: bool,
                   window: Optional[int] = None, q_offset: Optional[int] = None, elem: int = 2,
                   lse: bool = False) -> KernelCost:
    """``flash_attention``: q read once, the keys and values some query
    reads read once, the output (and the fp32 log-sum-exp) written once;
    2·pairs·(D + Dv) operations on the bf16 tensor cores (fp32 operands:
    the fp32 rate), pairs = B·Hq times the pairs the causal and window
    mask keeps at ``q_offset`` (:func:`attention_span`; prefill at D =
    Dv, causal, no window: 4·B·Hq·S(S + 1)/2·D).  A decode call (Sq = 1)
    is bound by its bytes."""
    pairs, keys = attention_span(sq, sk, causal, window, q_offset)
    n_bytes = elem * (b * hq * sq * d + b * hkv * keys * (d + dv) + b * hq * sq * dv) + (4 * b * hq * sq if lse else 0)
    return KernelCost(2.0 * b * hq * pairs * (d + dv), n_bytes, BF16_FLOPS if elem == 2 else FP32_FLOPS)


def attention_bwd_cost(b: int, hq: int, hkv: int, sq: int, sk: int, d: int, dv: int, *, causal: bool,
                       window: Optional[int] = None, q_offset: Optional[int] = None,
                       elem: int = 2) -> KernelCost:
    """``flash_attention_bwd``: q, the output, dO and the fp32 log-sum-exp
    read once, the keys and values some query reads read once, dQ, dK, dV
    written once; 2·pairs·(3D + 2Dv) operations over the pairs the mask
    keeps, as :func:`attention_cost` counts them (S = QKᵀ again, dV = Pᵀ
    dO, dP = dO Vᵀ, dQ = dS K, dK = dSᵀ Q: 2.5 x the forward's at D =
    Dv)."""
    pairs, keys = attention_span(sq, sk, causal, window, q_offset)
    q, o = b * hq * sq * d, b * hq * sq * dv
    n_bytes = elem * (2 * q + 2 * o + b * hkv * (keys + sk) * (d + dv)) + 4 * b * hq * sq
    return KernelCost(2.0 * b * hq * pairs * (3 * d + 2 * dv), n_bytes, BF16_FLOPS if elem == 2 else FP32_FLOPS)


def embedding_bag_cost(b: int, length: int, d: int, *, rows: int = None, elem: int = 4) -> KernelCost:
    """``embedding_bag``: the table rows the ids name read once, the ids
    read, the (B, D) fp32 output written: elem·rows·D + 4·B·L + 4·B·D.
    ``rows`` defaults to B·L, every id a row of its own: an upper bound,
    since a cost function reads shapes only and cannot count the distinct
    rows the ids name (a repeated row is read once from L2)."""
    rows = b * length if rows is None else rows
    return KernelCost(0.0, elem * rows * d + 4 * b * length + 4 * b * d)


@dataclass(frozen=True)
class KernelOp:
    """A kernel operator's launch counter and cost, each a function of
    the operator's arguments as the dispatcher passes them."""

    counter: Callable[..., str]
    cost: Callable[..., KernelCost]


KERNEL_OPS: Dict[str, KernelOp] = {}


def register_op(qualname: str, counter: Callable[..., str], cost: Callable[..., KernelCost]) -> None:
    """Register ``repro_torch::<name>`` (``qualname``)."""
    KERNEL_OPS[qualname] = KernelOp(counter, cost)
