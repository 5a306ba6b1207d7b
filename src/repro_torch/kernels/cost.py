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
from typing import Callable, Dict, Sequence, Tuple

__all__ = [
    "HBM_BYTES_PER_S", "FP32_FLOPS", "TF32_FLOPS", "BF16_FLOPS", "INT8_OPS", "NVLINK_BYTES_PER_S",
    "KernelCost", "bound_ms", "register_op", "KERNEL_OPS", "KernelOp",
    "hamming_filter_cost", "rmi_mlp_cost", "rmi_predict_cost", "row_popcount_cost", "label_prop_rect_cost",
    "col_reduce_cost", "label_prop_update_cost", "label_prop_fixpoint_cost",
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
