"""Trace passes: invariants of the dispatch traces of the standard
targets (LAF101, 103, 106, 107, 201, 202, 203; the counterparts of the
reference's jaxpr and HLO passes).

Each check is a pure function of a ``launch.trace_analysis``
``TraceAnalysis`` (and the cell's meta), so the corpus twins, the live
targets and the dry run's records all go through the same code:

* LAF101 ``trace-live-slab``: the one-launch cell adds no slab-sized
  live buffer: its traced peak live bytes are at most its arguments,
  its outputs and the fixpoint's vector working set (the reference
  proves this by donating ``rows``; PyTorch has no donation); a model's
  train cell returns its parameters and optimizer state as its
  arguments' storage (the reference donates both), nothing fresh but
  its metrics;
* LAF103 ``trace-host-read-in-loop``: no host read inside the sweep's
  launch loop or the fixpoint's rounds (traced, a host read of a fake
  device value raises; on a card the probe also enqueues a sweep and
  pass 2 under ``torch.cuda.set_sync_debug_mode("error")``);
* LAF106 ``trace-packed-loop-write``: no op inside the round loop writes
  a 2-D int32 tensor as large as the slab (the slab is read-only there);
* LAF107 ``trace-loop-state``: what the round loop writes in place is
  1-D int32 vectors of bounded length (or one element of one), or the
  (4, max_iters) telemetry;
* LAF201 ``trace-bitmap-collective``: no collective of a sharded target
  moves packed words: words travel as int32, so the dtype cannot show
  it; every operand must be a 1-D vector with no words axis;
* LAF202 ``trace-loop-collective-allowlist``: inside the round loop only
  int32 MIN all-reduces (plus SUM for telemetry counts), inside a sweep
  loop only the int32 SUM count all-reduces;
* LAF203 ``trace-bytes-budget``: a target's traced bytes stay within its
  ceiling (``targets.BYTE_BUDGETS``).
"""

from __future__ import annotations

from typing import List, Optional

from .registry import Finding, register

__all__ = [
    "ROUNDS_LOOP", "fixpoint_slack_bytes",
    "check_live_slab", "check_host_reads", "check_packed_loop_write", "check_loop_state",
    "check_bitmap_collective", "check_loop_allowlist", "check_bytes_budget", "check_train_in_place", "check_trace",
]

ROUNDS_LOOP = "label_prop.rounds"


def fixpoint_slack_bytes(meta: dict) -> int:
    """The fixpoint's vector working set beyond its arguments and
    outputs: the second label buffer, the positions, the initial labels
    and the column core mask (4 int32 vectors of ``cap``), and its row
    vectors (validity, core test, minima, row labels, the clamped row
    indices: 4 vectors of ``frontier`` at 8 bytes)."""
    return 4 * 4 * meta["cap"] + 4 * 8 * meta["frontier"]


def check_live_slab(tr, meta: dict, label: str) -> List[Finding]:
    limit = tr.argument_bytes + tr.output_bytes + fixpoint_slack_bytes(meta)
    if tr.peak_live_bytes > limit:
        return [Finding(
            "trace-live-slab", label, 0,
            f"peak live bytes {tr.peak_live_bytes:,} exceed arguments {tr.argument_bytes:,} + outputs "
            f"{tr.output_bytes:,} + the fixpoint's vectors {fixpoint_slack_bytes(meta):,}: the cell holds a "
            f"slab-sized buffer the design does not",
            hint="read the slab in place: no mask, copy or unpack of the (R, W) words in the cluster pass",
        )]
    return []


def check_host_reads(tr, label: str) -> List[Finding]:
    out = []
    for op, loop in tr.host_reads:
        if loop is not None:
            out.append(Finding(
                "trace-host-read-in-loop", label, 0,
                f"host read `{op}` inside the `{loop}` loop: every iteration waits for the card",
                hint="keep the loop's decisions on the device (flags read by the kernels), read once after it",
            ))
    if tr.error and not out:
        out.append(Finding("trace-host-read-in-loop", label, 0,
                           f"the trace stopped at a host read ({tr.error.splitlines()[0][:100]})",
                           hint="a traced step reads nothing on the host"))
    return out


def check_packed_loop_write(tr, meta: dict, label: str) -> List[Finding]:
    slab = meta.get("frontier", 0) * meta.get("w_local", 0)
    out = []
    for w in tr.loop_writes:
        if w.loop == ROUNDS_LOOP and len(w.shape) == 2 and w.dtype == "int32" and w.shape[0] * w.shape[1] >= slab:
            out.append(Finding(
                "trace-packed-loop-write", label, 0,
                f"`{w.op}` writes a {list(w.shape)} int32 tensor inside the round loop: the packed slab "
                f"({meta.get('frontier')} x {meta.get('w_local')} words) is read-only there",
                hint="the rounds read the slab; only the label vectors, minima and flags change",
            ))
    return out


def check_loop_state(tr, meta: dict, label: str) -> List[Finding]:
    bound = max(meta.get("cap", 0), meta.get("frontier", 0), meta.get("max_iters", 64) + 1)
    tele = (4, meta.get("max_iters", 64))
    out = []
    for w in tr.loop_writes:
        if w.loop != ROUNDS_LOOP or not w.in_place:
            continue
        if w.dtype == "int32" and (len(w.shape) == 0 or (len(w.shape) == 1 and w.shape[0] <= bound)
                                   or w.shape == tele):
            continue
        out.append(Finding(
            "trace-loop-state", label, 0,
            f"`{w.op}` updates a {list(w.shape)} {w.dtype} tensor in place inside the round loop: the loop's "
            f"state is 1-D int32 vectors of at most {bound} (and the (4, {tele[1]}) telemetry)",
            hint="carry labels, minima and flags as int32 vectors; keep anything wider out of the loop",
        ))
    return out


def check_bitmap_collective(tr, label: str) -> List[Finding]:
    return [Finding(
        "trace-bitmap-collective", label, 0,
        f"{c.op} of a {list(c.shape)} {c.dtype} operand: a collective with a words axis moves packed "
        f"bitmap words across ranks",
        hint="reduce the words on their own rank (popcount, K2, K3) and send only per-row or per-query vectors",
    ) for c in tr.collectives if len(c.shape) != 1]


_ALLOWED = {ROUNDS_LOOP: {("all_reduce", "min", "int32"), ("all_reduce", "sum", "int32")},
            "sweep.launches": {("all_reduce", "sum", "int32")},
            "sweep.chunks": {("all_reduce", "sum", "int32")}}


def check_loop_allowlist(tr, label: str) -> List[Finding]:
    """The clustering loops' allowlists (a model cell's loops, its
    microbatches and loss chunks, carry DTensor's collectives by design)."""
    out = []
    for c in tr.collectives:
        if c.loop not in _ALLOWED:
            continue
        allowed = _ALLOWED.get(c.loop, set())
        if (c.op, c.reduce, c.dtype) not in allowed:
            out.append(Finding(
                "trace-loop-collective-allowlist", label, 0,
                f"{c.op}({c.reduce or '-'}) of {c.dtype}{list(c.shape)} inside the `{c.loop}` loop; allowed "
                f"there: {sorted(allowed)}",
                hint="a round crosses ranks with one int32 MIN of its row minima; move anything else out",
            ))
    return out


def check_bytes_budget(tr, budget: Optional[int], label: str) -> List[Finding]:
    if budget is None or tr.bytes_accessed <= budget:
        return []
    return [Finding(
        "trace-bytes-budget", label, 0,
        f"traced bytes {tr.bytes_accessed:,.0f} exceed the ceiling {budget:,} (about 6x the standard config's)",
        hint="look for a widened bitmap, a broadcast (nq, n) intermediate or a per-round copy",
    )]


def check_train_in_place(tr, meta: dict, label: str) -> List[Finding]:
    """LAF101's reading for a model's train cell: PyTorch has no buffer
    donation, so the step updates its parameters and optimizer state in
    place and returns them as the arguments' own storage; a fresh output
    beyond the step's scalar metrics is a second copy of them."""
    limit = 64 * 4  # the metrics: a few fp32 scalars
    if meta.get("kind") != "train" or tr.output_fresh_bytes <= limit:
        return []
    return [Finding(
        "trace-live-slab", label, 0,
        f"the train step returns {tr.output_fresh_bytes:,} bytes outside its arguments: a second copy of the "
        f"parameters or the optimizer state (arguments {tr.argument_bytes:,})",
        hint="update the parameters and the moments in place, leaf by leaf",
    )]


def check_trace(tr, label: str, *, meta: Optional[dict] = None, byte_budget: Optional[int] = None) -> List[Finding]:
    """Every trace check that applies to one trace (the dry run's lint):
    the packed-words and clustering-loop checks on the cluster cells, the
    in-place reading of LAF101 on the model families' train cells."""
    meta = meta or {}
    out = check_host_reads(tr, label) + check_loop_allowlist(tr, label)
    if str(meta.get("kind", "")).endswith("cluster"):
        out += check_bitmap_collective(tr, label)
    out += check_train_in_place(tr, meta, label)
    if meta.get("kind") == "one_launch_cluster":
        out += check_live_slab(tr, meta, label) + check_packed_loop_write(tr, meta, label)
        out += check_loop_state(tr, meta, label)
    return out + check_bytes_budget(tr, byte_budget, label)


def _targets(ctx, *, sharded_only: bool = False):
    return [t for t in ctx.targets.all() if t.sharded or not sharded_only]


@register("trace-live-slab", family="trace", code="LAF101", reference="jaxpr-donation-alias",
          description="the one-launch cell holds no slab-sized buffer beyond its arguments and outputs")
def _check_live_slab(ctx) -> List[Finding]:
    t = ctx.targets.get("one_launch_cluster")
    return check_live_slab(t.analysis, t.meta, t.label)


@register("trace-host-read-in-loop", family="trace", code="LAF103", reference="jaxpr-host-callback-in-loop",
          description="no host read inside the sweep's launch loop or the fixpoint's rounds")
def _check_host_reads(ctx) -> List[Finding]:
    out = []
    for t in _targets(ctx):
        out.extend(check_host_reads(t.analysis, t.label))
    if ctx.dynamic and ctx.device == "cuda":
        from .probe_checks import sync_debug_findings

        out.extend(sync_debug_findings())
    return out


@register("trace-packed-loop-write", family="trace", code="LAF106", reference="jaxpr-packed-while-carry",
          description="no op inside the round loop writes the packed slab")
def _check_packed_loop_write(ctx) -> List[Finding]:
    t = ctx.targets.get("one_launch_cluster")
    return check_packed_loop_write(t.analysis, t.meta, t.label)


@register("trace-loop-state", family="trace", code="LAF107", reference="jaxpr-telemetry-carry",
          description="the round loop's state is 1-D int32 vectors of bounded length")
def _check_loop_state(ctx) -> List[Finding]:
    t = ctx.targets.get("one_launch_cluster")
    return check_loop_state(t.analysis, t.meta, t.label)


@register("trace-bitmap-collective", family="trace", code="LAF201", reference="hlo-bitmap-collective",
          description="no collective of a sharded target moves packed words")
def _check_bitmap_collective(ctx) -> List[Finding]:
    out = []
    for t in _targets(ctx, sharded_only=True):
        out.extend(check_bitmap_collective(t.analysis, t.label))
    return out


@register("trace-loop-collective-allowlist", family="trace", code="LAF202",
          reference="hlo-loop-collective-allowlist",
          description="inside the round loop only int32 MIN (and telemetry SUM) all-reduces")
def _check_loop_allowlist(ctx) -> List[Finding]:
    out = []
    for t in _targets(ctx):
        out.extend(check_loop_allowlist(t.analysis, t.label))
    return out


@register("trace-bytes-budget", family="trace", code="LAF203", reference="hlo-fusion-bytes-budget",
          description="each target's traced bytes stay within its ceiling")
def _check_bytes_budget(ctx) -> List[Finding]:
    out = []
    for t in _targets(ctx):
        out.extend(check_bytes_budget(t.analysis, t.byte_budget, t.label))
    return out
