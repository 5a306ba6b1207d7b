"""Plain PyTorch versions of the packed label-propagation kernels (the
port's counterpart of ``repro.kernels.label_prop.ref``): unpack-based,
blocked over rows so the unpacked tile stays bounded."""

from __future__ import annotations

import torch

from ...core.range_query import unpack_bitmap_t

__all__ = ["BIG", "label_prop_round_ref", "label_prop_rect_ref", "col_reduce_ref", "label_prop_update_ref",
           "label_prop_fixpoint_ref", "packed_connectivity_ref"]

BIG = torch.iinfo(torch.int32).max


def label_prop_round_ref(labels, bitmap, big=BIG, *, block: int = 1024):
    """new_labels[i] = min(labels[i], min_{j < N: bit ij set} labels[j])
    for (N,) labels and an (N, W) slab: ``label_prop_rect_ref`` with the
    labels as the column labels, padded with ``big`` past N (so bits of
    columns >= N change nothing while ``big`` bounds the labels)."""
    n = labels.shape[0]
    padded = torch.full((bitmap.shape[1] * 32,), big, dtype=labels.dtype, device=labels.device)
    padded[:n] = labels
    return label_prop_rect_ref(labels, padded, bitmap, big, block=block)


def label_prop_rect_ref(row_labels, col_labels, bitmap, big=BIG, *, block: int = 1024):
    """out[i] = min(row_labels[i], min over set bits j of col_labels[j])
    (``big`` where no bit is set)."""
    r, w = bitmap.shape
    out = torch.empty(r, dtype=torch.int32, device=bitmap.device)
    for s in range(0, r, block):
        bits = unpack_bitmap_t(bitmap[s : s + block], w * 32)
        neigh = torch.where(bits, col_labels[None, :], big).amin(dim=1)
        out[s : s + block] = torch.minimum(row_labels[s : s + block], neigh)
    return out


def col_reduce_ref(bitmap, row_vals, row_weights, *, block: int = 1024):
    """(col_min, col_sum), each (W*32,) int32: per column the min of
    ``row_vals`` over rows with the bit set (BIG where none) and the sum
    of ``row_weights`` over the same rows."""
    r, w = bitmap.shape
    cmin = torch.full((w * 32,), BIG, dtype=torch.int32, device=bitmap.device)
    csum = torch.zeros(w * 32, dtype=torch.int32, device=bitmap.device)
    for s in range(0, r, block):
        bits = unpack_bitmap_t(bitmap[s : s + block], w * 32)
        vals = row_vals[s : s + block, None]
        cmin = torch.minimum(cmin, torch.where(bits, vals, BIG).amin(dim=0))
        csum += torch.where(bits, row_weights[s : s + block, None], 0).sum(dim=0, dtype=torch.int32)
    return cmin, csum


def label_prop_update_ref(lab, m, pos, *, with_counts: bool = False):
    """One round's scatter-min + pointer jump (see ``csrc/label_prop.cu``):
    new[x] = min(lab[x], m[pos[x]]) on core columns (pos >= 0), then
    out[j] = min(new[j], new[new[j]]) where new[j] indexes a column.
    ``with_counts`` also returns the round's int32 telemetry
    ``[frontier, changed, hops, shard_wins]`` (``obs.device``)."""
    cap = lab.shape[0]
    gathered = m[pos.clamp(min=0).long()]
    new = torch.where(pos >= 0, torch.minimum(lab, gathered), lab)
    jump = torch.where(new < cap, new, 0).long()
    out = torch.where(new < cap, torch.minimum(new, new[jump]), new)
    if not with_counts:
        return out
    frontier = ((pos >= 0) & (gathered < lab)).sum()
    counts = torch.stack([frontier, (out != lab).sum(), (out < new).sum(), frontier])
    return out, counts.to(torch.int32)


def label_prop_fixpoint_ref(bitmap, bufs, m, pos, flags, *, square: bool = False, tele=None) -> None:
    """The fixpoint of ``csrc/label_prop.cu``'s ``label_prop_fixpoint``,
    in place, as a loop over the plain round functions that stops when
    nothing changed: round ``it`` (while ``flags[it]`` is 1, up to
    ``len(flags) - 1`` rounds) takes ``m`` = ``label_prop_rect_ref`` of
    ``bufs[it % 2]`` (INT32_MAX row labels, or with ``square`` the
    labels' first R), writes the update into the other buffer, adds its
    counts into ``tele[:, it]`` when given, and sets ``flags[it + 1]``
    when a label changed."""
    r = bitmap.shape[0]
    big_rows = None if square else torch.full((r,), BIG, dtype=torch.int32, device=bitmap.device)
    for it in range(flags.shape[0] - 1):
        if int(flags[it]) == 0:
            break
        lab, nxt = bufs[it % 2], bufs[(it + 1) % 2]
        m.copy_(label_prop_rect_ref(lab[:r] if square else big_rows, lab, bitmap))
        if tele is None:
            nxt.copy_(label_prop_update_ref(lab, m, pos))
        else:
            out, counts = label_prop_update_ref(lab, m, pos, with_counts=True)
            nxt.copy_(out)
            tele[:, it] += counts
        if bool((nxt != lab).any()):
            flags[it + 1] = 1


def connectivity_inputs(bitmap, rows, row_core, core_cols):
    """The operands of one connectivity block on the slab's device:
    ``(rows int32 (R,), row_core bool (R,), core_c bool (W*32,), init)``
    with ``core_c`` the core columns padded with False past n and
    ``init`` each core column's own index (INT32_MAX elsewhere)."""
    dev = bitmap.device
    r, w = bitmap.shape
    n = int(core_cols.shape[0])
    if n > w * 32:
        raise ValueError(f"a slab of {w} words cannot cover n={n} columns")
    rows = torch.as_tensor(rows).to(device=dev, dtype=torch.int32).contiguous()
    row_core = torch.as_tensor(row_core).to(device=dev, dtype=torch.bool)
    if rows.shape != (r,) or row_core.shape != (r,):
        raise ValueError(f"rows and row_core must have the slab's {r} rows")
    core_c = torch.zeros(w * 32, dtype=torch.bool, device=dev)
    core_c[:n] = torch.as_tensor(core_cols).to(device=dev, dtype=torch.bool)
    init = torch.where(core_c, torch.arange(w * 32, dtype=torch.int32, device=dev), BIG)
    return rows, row_core, core_c, init


def packed_connectivity_ref(bitmap, rows, row_core, core_cols, *, max_iters: int = 64):
    """Connectivity of one packed hit block, round by round as the
    reference's ``_packed_connectivity_jit`` (``repro/kernels/label_prop/
    ops.py:343-380``): each round K2 over INT32_MAX row labels and the
    column labels, masked to the core rows, then K3's column minimum,
    ``min(lab, cmin)`` on the core columns and one pointer jump; it stops
    when nothing changed, or after ``max_iters`` rounds.  Returns
    ``(comp (n,), owner (n,), row_first (R,), rounds)`` as tensors on the
    slab's device."""
    rows, row_core, core_c, init = connectivity_inputs(bitmap, rows, row_core, core_cols)
    r, w = bitmap.shape
    n, cap, dev = int(core_cols.shape[0]), w * 32, bitmap.device
    big_rows = torch.full((r,), BIG, dtype=torch.int32, device=dev)
    zeros = torch.zeros(r, dtype=torch.int32, device=dev)
    lab, rounds = init, 0
    while rounds < max_iters:
        m = label_prop_rect_ref(big_rows, lab, bitmap)
        cmin, _ = col_reduce_ref(bitmap, torch.where(row_core, m, BIG), zeros)
        new = torch.where(core_c, torch.minimum(lab, cmin), BIG)
        jump = torch.where(new < cap, new, 0).long()
        new = torch.where(new < cap, torch.minimum(new, new[jump]), new)
        rounds += 1
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            break
    owner, _ = col_reduce_ref(bitmap, torch.where(row_core, rows, BIG), zeros)
    row_first = label_prop_rect_ref(big_rows, init, bitmap)
    return lab[:n], owner[:n], row_first, torch.tensor(rounds, dtype=torch.int32, device=dev)
