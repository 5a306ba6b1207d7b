"""Kernel wrappers and the one-sync cluster fixpoint over a packed sweep
slab (port of ``repro.kernels.label_prop.ops``).

``label_prop_round`` / ``label_propagation_pallas`` are the square
connected-components pair over a packed symmetric (N, W) adjacency: one
round is K2 (``label_prop_rect``'s kernel) with the labels as both its
row and its column labels, counted as ``kernel.label_prop_round``; the
fixpoint runs its rounds in ``label_prop_fixpoint``'s one launch, as
below.

``packed_cluster_labels`` takes the sweep engine's rectangular packed
slab (R executed rows x W words of database columns) and computes,
without unpacking and without reading anything on the host: the exact
neighbor counts (popcount), the tau core test, the min-label connected
components of the core-core graph (min propagation with pointer
jumping), the min-core-neighbor border owner per column and the
transposed partial-count sums.

The reference keeps its ``changed`` flag inside a ``lax.while_loop``.
Here both fixpoints are one cooperative launch, ``label_prop_fixpoint``
(counted as ``kernel.label_prop_fixpoint``): its blocks loop over the
rounds on the device, K2 and the update separated by grid barriers;
round ``it`` sets ``flags[it + 1]`` when a label changed, and the loop
ends at a clear flag.  Round ``it`` reads one label buffer and writes
the other, so after ``rounds = sum(flags[:max_iters])`` rounds the
labels sit in buffer ``rounds % 2``, chosen on the device.  Nothing
syncs.  ``label_prop_rect`` and ``label_prop_update`` stay public, one
round step a launch, behind the same flags.

``telemetry=True`` (default: the ``obs`` device switch) adds the
reference's four per-round counts, ``obs.device.CLUSTER_ROUND_FIELDS``,
into an int32 ``(4, max_iters)`` device tensor from inside the
fixpoint's update step, returned as a sixth output for the caller's one
host copy.

``packed_cluster_fixpoint(col_off=, group=)`` is the sharded mode of the
index plane (``distributed.index_plane.sharded_cluster_labels``): the
slab is this rank's words of a column-sharded slab, the labels are the
global ``cap`` columns on every rank.  A collective cannot run inside
the cooperative launch, so on a group of several ranks each round is
three launches: ``label_prop_rect`` over the rank's label slice, a MIN
all-reduce of the row minima, ``label_prop_update``.  All ``max_iters``
rounds are enqueued, gated by the flags on the device, with no host
read; the ranks hold the same labels and flags, so they stay in step.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...obs import device as _obs_device
from ...obs import metrics as _metrics
from ...obs import loop_scope as _loop_scope
from .. import _build
from ..cost import (
    col_reduce_cost, label_prop_fixpoint_cost, label_prop_rect_cost, label_prop_update_cost, register_op,
)
from ..hamming_filter.ops import _tail_word_mask
from ..popcount import row_popcount
from .ref import (
    BIG, col_reduce_ref, label_prop_fixpoint_ref, label_prop_rect_ref, label_prop_round_ref,
    label_prop_update_ref, packed_connectivity_ref,
)

__all__ = [
    "label_prop_round",
    "label_propagation_pallas",
    "label_prop_rect",
    "col_reduce",
    "label_prop_update",
    "label_prop_fixpoint",
    "fixpoint_inputs",
    "packed_cluster_fixpoint",
    "packed_cluster_labels",
    "packed_connectivity",
    "connectivity_grid",
    "LAUNCHES",
]

LAUNCHES = {
    "label_prop_round": "kernel.label_prop_round.launches",
    "label_prop_rect": "kernel.label_prop_rect.launches",
    "col_reduce": "kernel.col_reduce.launches",
    "label_prop_update": "kernel.label_prop_update.launches",
    "label_prop_fixpoint": "kernel.label_prop_fixpoint.launches",
    "packed_connectivity": "kernel.packed_connectivity.launches",
}


def _int32_vec(t, n, what):
    if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous ({n},) int32 tensor")


def _check_slab(bitmap):
    if bitmap.dtype != torch.int32 or bitmap.dim() != 2 or not bitmap.is_contiguous():
        raise ValueError("bitmap must be a contiguous (R, W) int32 slab")


def _cuda(tensors, what):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: every operand must be on one CUDA device")


def label_prop_rect(row_labels, col_labels, bitmap, *, out=None, flag=None):
    """``out[i] = min(row_labels[i], min over set bits j of bitmap[i] of
    col_labels[j])`` for an (R, W) slab and (W*32,) column labels.
    ``flag`` (a one-element int32 tensor) makes the call a no-op when it
    holds 0 — read on the device by the kernel."""
    _check_slab(bitmap)
    r, w = bitmap.shape
    _int32_vec(row_labels, r, "row_labels")
    _int32_vec(col_labels, w * 32, "col_labels")
    if out is None:
        out = torch.empty(r, dtype=torch.int32, device=bitmap.device)
    _int32_vec(out, r, "out")
    if bitmap.device.type == "cpu":
        if flag is None or int(flag[0]) != 0:
            out.copy_(label_prop_rect_ref(row_labels, col_labels, bitmap))
        return out
    return _launch_rect(row_labels, col_labels, bitmap, out, flag, "label_prop_rect")


def _launch_rect(row_labels, col_labels, bitmap, out, flag, name):
    operands = [bitmap, row_labels, col_labels, out] + ([flag] if flag is not None else [])
    _cuda(operands, name)
    _label_prop_rect_op(row_labels, col_labels, bitmap, out, flag, name == "label_prop_round")
    return out


@torch.library.custom_op("repro_torch::label_prop_rect", mutates_args=("out",), device_types="cuda")
def _label_prop_rect_op(row_labels: torch.Tensor, col_labels: torch.Tensor, bitmap: torch.Tensor,
                        out: torch.Tensor, flag: Optional[torch.Tensor], square: bool) -> None:
    """One K2 launch on checked operands (``square``: counted as
    ``label_prop_round``)."""
    r, w = bitmap.shape
    name = "label_prop_round" if square else "label_prop_rect"
    err = _build.load("label_prop").label_prop_rect_launch(
        row_labels.data_ptr(), col_labels.data_ptr(), bitmap.data_ptr(), r, w,
        out.data_ptr(), flag.data_ptr() if flag is not None else None,
        torch.cuda.current_stream(bitmap.device).cuda_stream,
    )
    _build.check(err, name)
    _metrics.counter(LAUNCHES[name]).inc()


@_label_prop_rect_op.register_fake
def _(row_labels, col_labels, bitmap, out, flag, square) -> None:
    return None


register_op("repro_torch::label_prop_rect",
            lambda row_labels, col_labels, bitmap, out, flag, square:
            LAUNCHES["label_prop_round" if square else "label_prop_rect"],
            lambda row_labels, col_labels, bitmap, out, flag, square: label_prop_rect_cost(*bitmap.shape))


def _square(bitmap, n):
    _check_slab(bitmap)
    if bitmap.shape[0] != n:
        raise ValueError(f"a square adjacency needs {n} rows, got {bitmap.shape[0]}")
    if bitmap.shape[1] * 32 < n:
        raise ValueError(f"{bitmap.shape[1]} words cannot cover {n} columns")


def _round_into(col_labels, bitmap, out):
    """One square round from the (W*32,) labels padded with INT32_MAX
    past N (so bits of columns >= N meet INT32_MAX and change nothing,
    as the reference's ``_pad`` makes them) into ``out`` (N,); rows read
    ``col_labels[:N]``."""
    n = bitmap.shape[0]
    if bitmap.device.type == "cpu":
        out.copy_(label_prop_round_ref(col_labels[:n], bitmap))
        return out
    return _launch_rect(col_labels, col_labels, bitmap, out, None, "label_prop_round")


def label_prop_round(labels, bitmap):
    """One min-propagation round over a square packed adjacency:
    ``out[i] = min(labels[i], min over set bits j < N of row i of
    labels[j])`` for (N,) int32 labels and an (N, W) int32 slab with
    W*32 >= N; bits of columns >= N are never read (their labels are
    padded with INT32_MAX, as the reference pads them)."""
    n = labels.shape[0]
    _square(bitmap, n)
    _int32_vec(labels, n, "labels")
    col = torch.full((bitmap.shape[1] * 32,), BIG, dtype=torch.int32, device=bitmap.device)
    col[:n] = labels
    return _round_into(col, bitmap, torch.empty(n, dtype=torch.int32, device=bitmap.device))


def col_reduce(bitmap, row_vals, row_weights):
    """(col_min, col_sum), each (W*32,) int32, in one launch: per column
    the min of ``row_vals`` over rows with the bit set (INT32_MAX where
    none) and the sum of ``row_weights`` over those rows."""
    _check_slab(bitmap)
    r, w = bitmap.shape
    _int32_vec(row_vals, r, "row_vals")
    _int32_vec(row_weights, r, "row_weights")
    if bitmap.device.type == "cpu":
        return col_reduce_ref(bitmap, row_vals, row_weights)
    _cuda([bitmap, row_vals, row_weights], "col_reduce")
    return _col_reduce_op(bitmap, row_vals, row_weights)


@torch.library.custom_op("repro_torch::col_reduce", mutates_args=(), device_types="cuda")
def _col_reduce_op(bitmap: torch.Tensor, row_vals: torch.Tensor,
                   row_weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K3 launch on checked operands: (col_min, col_sum)."""
    r, w = bitmap.shape
    col_min = torch.full((w * 32,), BIG, dtype=torch.int32, device=bitmap.device)
    col_sum = torch.zeros(w * 32, dtype=torch.int32, device=bitmap.device)
    err = _build.load("label_prop").col_reduce_launch(
        bitmap.data_ptr(), row_vals.data_ptr(), row_weights.data_ptr(), r, w,
        col_min.data_ptr(), col_sum.data_ptr(), torch.cuda.current_stream(bitmap.device).cuda_stream,
    )
    _build.check(err, "col_reduce")
    _metrics.counter(LAUNCHES["col_reduce"]).inc()
    return col_min, col_sum


@_col_reduce_op.register_fake
def _(bitmap, row_vals, row_weights):
    cap = bitmap.shape[1] * 32
    return bitmap.new_empty((cap,), dtype=torch.int32), bitmap.new_empty((cap,), dtype=torch.int32)


register_op("repro_torch::col_reduce", lambda bitmap, row_vals, row_weights: LAUNCHES["col_reduce"],
            lambda bitmap, row_vals, row_weights: col_reduce_cost(*bitmap.shape))


def label_prop_update(lab, m, pos, out, flags, it: int, *, tele=None) -> None:
    """Round ``it``'s scatter-min + pointer jump from ``lab`` into
    ``out`` (see ``csrc/label_prop.cu``); a no-op when ``flags[it]`` is
    0, sets ``flags[it + 1]`` when a label changed.  ``tele`` (a
    contiguous int32 (4, T) tensor, T > it) gets the round's four
    telemetry counts added into column ``it``."""
    cap = lab.shape[0]
    _int32_vec(lab, cap, "lab")
    _int32_vec(pos, cap, "pos")
    _int32_vec(out, cap, "out")
    if m.dtype != torch.int32 or m.dim() != 1 or not m.is_contiguous():
        raise ValueError("m must be a contiguous 1-d int32 tensor")
    if flags.dtype != torch.int32 or flags.dim() != 1 or not 0 <= it < flags.shape[0] - 1:
        raise ValueError("flags must be an int32 vector with room for round it + 1")
    _check_tele(tele, it + 1)
    if lab.device.type == "cpu":
        if int(flags[it]) != 0:
            if tele is None:
                out.copy_(label_prop_update_ref(lab, m, pos))
            else:
                nxt, counts = label_prop_update_ref(lab, m, pos, with_counts=True)
                out.copy_(nxt)
                tele[:, it] += counts
            if bool((out != lab).any()):
                flags[it + 1] = 1
        return
    _cuda([lab, m, pos, out, flags] + ([tele] if tele is not None else []), "label_prop_update")
    _label_prop_update_op(lab, m, pos, out, flags, int(it), tele)


@torch.library.custom_op("repro_torch::label_prop_update", mutates_args=("out", "flags", "tele"),
                         device_types="cuda")
def _label_prop_update_op(lab: torch.Tensor, m: torch.Tensor, pos: torch.Tensor, out: torch.Tensor,
                          flags: torch.Tensor, it: int, tele: Optional[torch.Tensor]) -> None:
    """One update launch on checked operands."""
    err = _build.load("label_prop").label_prop_update_launch(
        lab.data_ptr(), m.data_ptr(), pos.data_ptr(), lab.shape[0], out.data_ptr(),
        flags.data_ptr(), it, tele.data_ptr() if tele is not None else None,
        tele.shape[1] if tele is not None else 0, torch.cuda.current_stream(lab.device).cuda_stream,
    )
    _build.check(err, "label_prop_update")
    _metrics.counter(LAUNCHES["label_prop_update"]).inc()


@_label_prop_update_op.register_fake
def _(lab, m, pos, out, flags, it, tele) -> None:
    return None


register_op("repro_torch::label_prop_update", lambda lab, m, pos, out, flags, it, tele: LAUNCHES["label_prop_update"],
            lambda lab, m, pos, out, flags, it, tele: label_prop_update_cost(lab.shape[0], m.shape[0]))


def _check_tele(tele, rounds):
    if tele is not None and (
        tele.dtype != torch.int32 or tele.dim() != 2 or tele.shape[0] != 4
        or not rounds <= tele.shape[1] or not tele.is_contiguous()
    ):
        raise ValueError(f"tele must be a contiguous (4, >= {rounds}) int32 tensor")


def label_prop_fixpoint(bitmap, bufs, m, pos, flags, *, square: bool = False, tele=None) -> None:
    """Every round of a fixpoint over an (R, W) slab in one launch, in
    place (see ``csrc/label_prop.cu``): round ``it``, while ``flags[it]``
    is 1 and for at most ``max_iters = len(flags) - 1`` rounds, is K2
    from ``bufs[it % 2]`` into ``m`` (R,) — INT32_MAX row labels, or with
    ``square`` the labels' first R — then the update into the other
    buffer, setting ``flags[it + 1]`` when a label changed.  ``bufs`` are
    two (W*32,) int32 label buffers, ``pos`` the (W*32,) slab row of each
    core column (-1 elsewhere); ``tele`` (int32 (4, >= max_iters)) gets
    each round's four counts in its column.  The caller sets
    ``flags[0]`` and zeroes the rest.  A CPU slab runs
    ``label_prop_fixpoint_ref``; a CUDA slab launches the kernel (one
    cooperative launch) or raises."""
    _check_slab(bitmap)
    r, w = bitmap.shape
    cap = w * 32
    for b, what in ((bufs[0], "bufs[0]"), (bufs[1], "bufs[1]"), (pos, "pos")):
        _int32_vec(b, cap, what)
    if bufs[0] is bufs[1] or (bufs[0].untyped_storage()._cdata == bufs[1].untyped_storage()._cdata
                              and bufs[0].storage_offset() == bufs[1].storage_offset()):
        raise ValueError("the two label buffers must be distinct")
    _int32_vec(m, r, "m")
    if square and r > cap:
        raise ValueError(f"a square slab of {r} rows needs {r} <= {cap} columns")
    if flags.dtype != torch.int32 or flags.dim() != 1 or flags.shape[0] < 1 or not flags.is_contiguous():
        raise ValueError("flags must be a contiguous int32 vector of max_iters + 1")
    max_iters = flags.shape[0] - 1
    _check_tele(tele, max_iters)
    if bitmap.device.type == "cpu":
        label_prop_fixpoint_ref(bitmap, bufs, m, pos, flags, square=square, tele=tele)
        return
    operands = [bitmap, bufs[0], bufs[1], m, pos, flags] + ([tele] if tele is not None else [])
    _cuda(operands, "label_prop_fixpoint")
    _label_prop_fixpoint_op(bitmap, bufs[0], bufs[1], m, pos, flags, bool(square), tele)


@torch.library.custom_op("repro_torch::label_prop_fixpoint", mutates_args=("buf0", "buf1", "m", "flags", "tele"),
                         device_types="cuda")
def _label_prop_fixpoint_op(bitmap: torch.Tensor, buf0: torch.Tensor, buf1: torch.Tensor, m: torch.Tensor,
                            pos: torch.Tensor, flags: torch.Tensor, square: bool,
                            tele: Optional[torch.Tensor]) -> None:
    """One cooperative fixpoint launch on checked operands."""
    r, w = bitmap.shape
    err = _build.load("label_prop").label_prop_fixpoint_launch(
        bitmap.data_ptr(), r, w, int(square), buf0.data_ptr(), buf1.data_ptr(), m.data_ptr(),
        pos.data_ptr(), w * 32, flags.data_ptr(), flags.shape[0] - 1,
        tele.data_ptr() if tele is not None else None, tele.shape[1] if tele is not None else 0,
        torch.cuda.current_stream(bitmap.device).cuda_stream,
    )
    _build.check(err, "label_prop_fixpoint")
    _metrics.counter(LAUNCHES["label_prop_fixpoint"]).inc()


@_label_prop_fixpoint_op.register_fake
def _(bitmap, buf0, buf1, m, pos, flags, square, tele) -> None:
    return None


# the rounds run are read on the device; a trace charges max_iters of them
register_op("repro_torch::label_prop_fixpoint",
            lambda bitmap, buf0, buf1, m, pos, flags, square, tele: LAUNCHES["label_prop_fixpoint"],
            lambda bitmap, buf0, buf1, m, pos, flags, square, tele: label_prop_fixpoint_cost(
                bitmap.shape[0], bitmap.shape[1], flags.shape[0] - 1))


def label_propagation_pallas(bitmap, active, *, max_iters: int = 64, with_rounds: bool = False, device=None):
    """Connected components over a packed symmetric (N, W) adjacency,
    the contract of ``core.union_find.label_propagation``: (N,) int32,
    the min active index of each node's component, ``N`` on inactive
    nodes.  Each round is ``new = where(active, min(labels, neigh), N)``
    then the pointer jump ``min(new, new[new])`` over the round's whole
    ``new``; it stops when nothing changed, or after ``max_iters``.

    The rounds run as ``packed_cluster_fixpoint``'s do, in one
    ``label_prop_fixpoint`` launch (square mode: K2 with the labels as
    row and column labels), reading one label buffer and writing the
    other, so nothing is read on the host.  The buffers hold the masked
    labels (INT32_MAX on inactive nodes and past N); ``pos`` maps each
    active column to its own row, so the update computes ``new`` at both
    ends of the jump.
    ``with_rounds`` also returns the executed rounds, a device scalar.
    An array ``bitmap`` goes to ``device`` (default cuda); a tensor
    stays on its device."""
    from ...core.union_find import as_device_operands

    if not torch.is_tensor(bitmap):
        bitmap, active = as_device_operands(bitmap, active, torch.int32, device)
    n = int(active.shape[0])
    _square(bitmap, n)
    dev = bitmap.device
    cap = bitmap.shape[1] * 32
    act = torch.zeros(cap, dtype=torch.bool, device=dev)
    act[:n] = torch.as_tensor(active).to(device=dev, dtype=torch.bool)
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    bufs = (torch.where(act, idx, BIG), torch.empty(cap, dtype=torch.int32, device=dev))
    pos = torch.where(act, idx, -1)
    m = torch.empty(n, dtype=torch.int32, device=dev)
    flags = torch.zeros(max_iters + 1, dtype=torch.int32, device=dev)
    flags[:1].fill_(1)  # a fill on the device: `flags[0] = 1` would copy from the host and wait
    label_prop_fixpoint(bitmap, bufs, m, pos, flags, square=True)
    rounds = flags[:max_iters].sum(dtype=torch.int32)
    labels = torch.where(rounds % 2 == 0, bufs[0], bufs[1])[:n]
    labels = torch.where(act[:n], labels, n)
    return (labels, rounds) if with_rounds else labels


def fixpoint_inputs(bitmap, rows, tau, *, n: int, cap: int, group=None):
    """Loop-invariant inputs of the fixpoint, all on the slab's device:
    ``(rows int32, valid_r, counts, core_r, pos, init)`` — row validity,
    exact neighbor counts (``row_popcount``; with ``group`` the rank's
    words' counts summed over its ranks), the tau core test per row, the
    slab row of each core column (-1 elsewhere: the scatter target map)
    and the initial labels (own index on core columns, INT32_MAX else)."""
    dev = bitmap.device
    r = bitmap.shape[0]
    rows = rows.to(device=dev, dtype=torch.int32).contiguous()
    valid_r = rows < n
    counts = row_popcount(bitmap)
    if group is not None:
        from ...distributed.index_plane import plane_collective

        plane_collective("sum", counts, group)
    counts = torch.where(valid_r, counts, 0)
    # tau: an int, or a one-element int32 tensor on the slab's device (no host read)
    core_r = valid_r & (counts >= (tau.reshape(()) if torch.is_tensor(tau) else int(tau)))
    safe_rows = rows.clamp(max=cap - 1).long()
    core_c = torch.zeros(cap, dtype=torch.int32, device=dev).scatter_reduce_(
        0, safe_rows, core_r.to(torch.int32), "amax") > 0
    pos = torch.full((cap,), -1, dtype=torch.int32, device=dev).scatter_reduce_(
        0, safe_rows,
        torch.where(core_r, torch.arange(r, dtype=torch.int32, device=dev), -1), "amax")
    init = torch.where(core_c, torch.arange(cap, dtype=torch.int32, device=dev), BIG)
    return rows, valid_r, counts, core_r, pos, init


def packed_cluster_fixpoint(bitmap, rows, tau, *, n: int, cap: int, max_iters: int = 64,
                            telemetry=None, col_off: int = 0, group=None):
    """The cluster pass over an (R, W) slab with W*32 == cap whose bits
    for columns >= n are clear.

    Sharded mode (``group``, a process group of several ranks): the slab
    is this rank's words, columns ``[col_off, col_off + 32 W)`` of
    ``cap``; the counts are summed over the group, each round's row minima
    MIN-reduced (module docstring), and ``owner`` / ``col_sum`` cover the
    rank's columns only (``sharded_cluster_labels`` gathers them).  The
    per-round ``shard_wins`` are the rows whose rank-local minimum beats
    their label, summed over the group once after the loop (on one rank
    they equal the frontier).  A group of one rank, or none, is the one
    cooperative launch.

    ``rows`` (R,) holds the database index of each slab row (sentinel
    >= n on padding rows); every core point must be a slab row, which is
    what makes the gather + scatter round a full propagation round on
    the core-core graph.  Returns device tensors ``(labels (cap,),
    owner (cap,), col_sum (cap,), counts (R,), rounds ())``:
    labels[j] = min core index of j's core component (INT32_MAX on
    non-core columns), owner[j] = min executed core row adjacent to j,
    col_sum[j] = number of valid rows adjacent to j, counts = exact
    neighbor counts per slab row.  ``telemetry`` (default: the obs
    device switch) appends the int32 ``(4, max_iters)`` per-round
    counts, zero past the executed rounds.
    """
    _check_slab(bitmap)
    r, w = bitmap.shape
    if group is not None:
        import torch.distributed as dist

        group = group if dist.get_world_size(group) > 1 else None
    if group is None and w * 32 != cap:
        raise ValueError(f"slab width {w} words does not cover cap={cap}")
    if group is not None and (col_off % 32 or col_off < 0 or col_off + w * 32 > cap):
        raise ValueError(f"a {w}-word slab at column {col_off} does not fit cap={cap}")
    if telemetry is None:
        telemetry = _obs_device.device_enabled()
    dev = bitmap.device
    rows, valid_r, counts, core_r, pos, init = fixpoint_inputs(bitmap, rows, tau, n=n, cap=cap, group=group)
    bufs = (init, torch.empty(cap, dtype=torch.int32, device=dev))
    m = torch.empty(r, dtype=torch.int32, device=dev)
    flags = torch.zeros(max_iters + 1, dtype=torch.int32, device=dev)
    flags[:1].fill_(1)  # a fill on the device: `flags[0] = 1` would copy from the host and wait
    tele = _obs_device.cluster_telemetry_init(max_iters, dev) if telemetry else None
    if group is None:
        label_prop_fixpoint(bitmap, bufs, m, pos, flags, tele=tele)
    else:
        _sharded_rounds(bitmap, bufs, m, pos, flags, tele, rows, core_r, col_off, group)
    rounds = flags[:max_iters].sum(dtype=torch.int32)
    labels = torch.where(rounds % 2 == 0, bufs[0], bufs[1])
    owner, col_sum = col_reduce(
        bitmap, torch.where(core_r, rows, BIG), valid_r.to(torch.int32)
    )
    outs = (labels, owner, col_sum, counts, rounds)
    return outs + (tele,) if telemetry else outs


def _sharded_rounds(bitmap, bufs, m, pos, flags, tele, rows, core_r, col_off, group) -> None:
    """Every round of the sharded fixpoint, enqueued, gated by ``flags``
    on the device: K2 over the rank's label slice into ``m``, the MIN
    all-reduce of ``m``, the update into the other buffer (its fourth
    telemetry row is replaced by the summed gather wins)."""
    from ...distributed.index_plane import plane_collective

    r, w = bitmap.shape
    cap, max_iters = pos.shape[0], flags.shape[0] - 1
    big_rows = torch.full((r,), BIG, dtype=torch.int32, device=bitmap.device)
    safe_rows = rows.clamp(max=cap - 1).long()
    wins = torch.zeros(max_iters, dtype=torch.int32, device=bitmap.device) if tele is not None else None
    with _loop_scope("label_prop.rounds"):
        for it in range(max_iters):
            lab, nxt = bufs[it % 2], bufs[(it + 1) % 2]
            label_prop_rect(big_rows, lab[col_off : col_off + w * 32], bitmap, out=m, flag=flags[it : it + 1])
            if wins is not None:  # rows whose rank-local minimum beats their label (0 on a gated round)
                wins[it] = (core_r & (m < lab[safe_rows])).sum(dtype=torch.int32) * flags[it]
            plane_collective("min", m, group)
            label_prop_update(lab, m, pos, nxt, flags, it, tele=tele)
    if wins is not None:
        plane_collective("sum", wins, group)
        tele[3].copy_(wins)


def packed_cluster_labels(bitmap, rows, tau, *, n: int, max_iters: int = 64, telemetry=None):
    """One-sync cluster pass over a packed sweep slab: ``bitmap`` is the
    (R, W) int32 slab (W*32 >= n; bits past n are cleared here) and
    ``rows`` the (R,) database indices of its rows.  Returns device
    tensors ``(labels, owner, col_sum, counts, rounds)``, plus the
    per-round telemetry with ``telemetry`` — see
    :func:`packed_cluster_fixpoint`; nothing is read on the host."""
    _check_slab(bitmap)
    w = bitmap.shape[1]
    if w * 32 < n:
        raise ValueError(f"slab of {w} words cannot cover n={n} columns")
    bitmap = bitmap & _tail_word_mask(w, n, bitmap.device)[None, :]
    rows = torch.as_tensor(rows).to(device=bitmap.device, dtype=torch.int32)
    return packed_cluster_fixpoint(bitmap, rows, tau, n=n, cap=w * 32, max_iters=max_iters,
                                   telemetry=telemetry)


def connectivity_grid(r: int, w: int):
    """``(blocks, blocks an SM, K2's chunk rows, K3's chunk rows)`` of
    ``packed_connectivity``'s cooperative launch on an (r, w) slab, as
    the launcher sizes it on the current card."""
    out = (ctypes.c_int * 4)()
    err = _build.load("label_prop").packed_connectivity_grid(int(r), int(w), out)
    _build.check(err, "packed_connectivity_grid")
    return tuple(out)


def packed_connectivity(bitmap, rows, row_core, core_cols, *, max_iters: int = 64, stamps=None):
    """Connectivity of one packed hit block, bipartite propagation (the
    contract of ``repro.kernels.label_prop.packed_connectivity``).

    ``bitmap`` (R, W) int32 is a block of alive-masked adjacency rows
    whose database indices are ``rows`` (R,); ``row_core`` flags which of
    those rows are core; ``core_cols`` (n,), n <= W*32, flags the core
    columns.  Bits past n must be clear (the pack contract).

    Returns device tensors ``(comp (n,), owner (n,), row_first (R,),
    rounds ())``: ``comp[j]`` = min core column reachable from core
    column j through the block's core rows (INT32_MAX on non-core
    columns), ``owner[j]`` = min core row adjacent to column j,
    ``row_first[i]`` = min core column adjacent to row i.  Nothing is
    read on the host.

    A CPU slab runs ``packed_connectivity_ref``.  On a CUDA slab the
    whole block is one cooperative launch, the fixpoint's connectivity
    mode (``csrc/label_prop.cu``, counted as
    ``kernel.packed_connectivity``): K2's walk, K3's walk and the update
    split by grid barriers, both walks over (128-word tile, row chunk)
    work items claimed from a device counter, round ``it`` reading one
    label buffer and writing the other and setting ``flags[it + 1]`` when
    a label changed.  Round 0, which always runs (``max_iters`` >= 1),
    computes its labels (each core column its own index) and also yields
    the two loop-invariant outputs: its K2 walk is row_first, and its K3
    walk takes the owner in a second accumulator.  The launch leaves the
    labels in one buffer and the rounds it ran in its flags tensor, so
    the outputs are views.  A grid that cannot be resident raises.

    ``stamps``, for the probe (``scripts/connectivity_probe.py``), CUDA
    only, changes no output: a zeroed int64 ``(1 + 3 * max_iters,
    blocks)`` tensor (blocks from ``connectivity_grid``) that the
    kernel's probe build fills with ``%globaltimer`` (ns) as each
    block enters (row 0) and as it leaves each step of round ``it`` (rows
    ``1 + 3 it + step``, steps K2, K3, update; rounds that do not run
    stay 0)."""
    _check_slab(bitmap)
    if max_iters < 1:
        raise ValueError(f"max_iters must be >= 1, got {max_iters}")
    if bitmap.device.type == "cpu":
        return packed_connectivity_ref(bitmap, rows, row_core, core_cols, max_iters=max_iters)
    r, w = bitmap.shape
    n, cap, dev = int(core_cols.shape[0]), w * 32, bitmap.device
    if n > cap:
        raise ValueError(f"a slab of {w} words cannot cover n={n} columns")
    rows = torch.as_tensor(rows).to(device=dev, dtype=torch.int32).contiguous()
    row_core = torch.as_tensor(row_core).to(device=dev, dtype=torch.bool).contiguous()
    core_cols = torch.as_tensor(core_cols).to(device=dev, dtype=torch.bool).contiguous()
    if rows.shape != (r,) or row_core.shape != (r,):
        raise ValueError(f"rows and row_core must have the slab's {r} rows")
    labels = torch.empty((2, cap), dtype=torch.int32, device=dev)  # the result comes out in row 0
    m = torch.empty(r, dtype=torch.int32, device=dev)
    cmin = torch.empty(cap, dtype=torch.int32, device=dev)
    # round 0's K2 and K3 take their minima into these
    row_first = torch.full((r,), BIG, dtype=torch.int32, device=dev)
    owner = torch.full((cap,), BIG, dtype=torch.int32, device=dev)
    # the round flags, the two work-item counters, the rounds run
    flags = torch.zeros(max_iters + 4, dtype=torch.int32, device=dev)
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != dev or not stamps.is_contiguous()
                               or stamps.numel() < (1 + 3 * max_iters) * connectivity_grid(r, w)[0]):
        raise ValueError("stamps must be a contiguous int64 (1 + 3 max_iters, blocks) tensor on the slab's device")
    _cuda([bitmap, rows, row_core, core_cols, labels, m, cmin, flags, row_first, owner], "packed_connectivity")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.load("label_prop").packed_connectivity_launch(
        bitmap.data_ptr(), r, w, n, rows.data_ptr(), row_core.data_ptr(), core_cols.data_ptr(), labels[0].data_ptr(),
        labels[1].data_ptr(), m.data_ptr(), cmin.data_ptr(), flags.data_ptr(), row_first.data_ptr(), owner.data_ptr(),
        max_iters, None if stamps is None else stamps.data_ptr(), stream,
    )
    _build.check(err, "packed_connectivity")
    _metrics.counter(LAUNCHES["packed_connectivity"]).inc()
    if r == 0:  # no round runs: each core column keeps its own index, the one round the plain version counts
        comp = torch.where(core_cols, torch.arange(n, dtype=torch.int32, device=dev), BIG)
        return comp, owner[:n], row_first, torch.ones((), dtype=torch.int32, device=dev)
    return labels[0, :n], owner[:n], row_first, flags[max_iters + 3]
