"""Probe passes: small real workloads (LAF104, 105, 108, and LAF103's
probe on a card; the counterparts of the reference's dynamic jaxpr
probes).

* LAF104 ``probe-plane-replication``: the outputs the plane declares
  replicated (the frontier round's summed counts and predictions, the
  sharded fixpoint's labels, counts and rounds) are equal on every rank:
  both cluster cells at the reduced config run on two gloo ranks on the
  CPU (``testing.ranks.run_ranks``);
* LAF105 ``probe-recompile-lattice``: the sweep engine's launch
  signatures over nq in [1, 4096] and the serving buckets are bounded
  lattices; over a steady-query-shape append workload each
  ``obs.PAIRED_COUNTERS`` pair moves in lockstep (``sweep.recompiles``
  with ``index.capacity_doublings``); no kernel source is built twice
  under one hash in this process (``kernels._build.BUILDS``);
* LAF108 ``probe-restore-replica``: a backend restored from
  ``state_export`` and re-running the pre-crash query shapes sees no new
  sweep signature and builds no kernel;
* LAF103's probe (on a card only, ``sync_debug_findings``): a sweep and
  pass 2 are enqueued under ``torch.cuda.set_sync_debug_mode("error")``.

The probes run on ``ctx.device`` (the card when there is one) and only
with ``ctx.dynamic``; the static lattice bounds always run.  Each
probe's geometry is its own (d 40, 48 and 64), so one process can run
them in any order.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List

from .registry import Finding, register

__all__ = ["check_replicated", "check_restore_signatures", "replication_rank", "sync_debug_findings",
           "REPLICATED_OUTPUTS"]

REPLICATED_OUTPUTS = ("frontier.counts", "frontier.pred", "one_launch.labels", "one_launch.counts",
                      "one_launch.rounds")


def check_replicated(per_rank: List[dict], names, label: str) -> List[Finding]:
    """Each output in ``names`` equal (as arrays) on every rank."""
    import numpy as np

    out = []
    for name in names:
        ref = np.asarray(per_rank[0][name])
        bad = [r for r, res in enumerate(per_rank[1:], 1) if not np.array_equal(np.asarray(res[name]), ref)]
        if bad:
            out.append(Finding(
                "probe-plane-replication", label, 0,
                f"`{name}` is declared replicated but differs on rank(s) {bad} from rank 0",
                hint="reduce it over the plane's group (SUM or MIN) before returning it, or declare it sharded",
            ))
    return out


def _probe_data(n: int, d: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def replication_rank(rank: int, world: int) -> dict:
    """One rank of the LAF104 probe: both reduced cluster cells on a
    ``("data",)`` CPU mesh of ``world`` ranks, outputs as arrays."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from ..configs.registry import ShapeSpec, get_arch
    from ..core.cardinality.rmi import RMI, RMIConfig
    from ..launch.dryrun import cluster_arch
    from ..launch.laf_cluster import build_laf_cluster, build_one_launch_cluster, frontier_inputs, slab_inputs

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    arch = cluster_arch(get_arch("laf_dbscan"), reduced=True, index_device=True, telemetry=False)
    n, d = 1000, 64
    shape = ShapeSpec("probe", "cluster", {"n_points": n, "dim": d})
    data = _probe_data(n, d, 7)
    cell = build_laf_cluster(arch, shape, mesh, device="cpu")
    rmi = RMI(RMIConfig(input_dim=d + 1), generator=torch.Generator().manual_seed(0))
    db, q, sig = frontier_inputs(cell, mesh, data, data[: cell.meta["frontier"]], device="cpu")
    counts, _, pred = cell.step_fn(rmi, db, q, sig)
    one = build_one_launch_cluster(arch, shape, mesh, device="cpu")
    rng = np.random.default_rng(3)
    r, w = one.meta["frontier"], -(-n // 32)
    slab = rng.integers(0, 2 ** 31, size=(r, w), dtype=np.int64).astype(np.int32) & rng.integers(
        0, 2 ** 31, size=(r, w), dtype=np.int64).astype(np.int32)
    slab[:, -1] &= np.int32((1 << (n - 32 * (w - 1))) - 1)
    rows = np.arange(r, dtype=np.int32)
    labels, _, _, counts1, rounds = one.step_fn(*slab_inputs(one, mesh, slab, rows, 5, device="cpu"))
    return {"frontier.counts": counts.numpy(), "frontier.pred": pred.numpy(), "one_launch.labels": labels.numpy(),
            "one_launch.counts": counts1.numpy(), "one_launch.rounds": int(rounds)}


@register("probe-plane-replication", family="probe", code="LAF104", reference="jaxpr-shardmap-replication",
          description="outputs the plane declares replicated are equal on every rank (2 gloo ranks)")
def _check_replication(ctx) -> List[Finding]:
    if not ctx.dynamic:
        return []
    from ..testing.ranks import run_ranks

    per_rank = run_ranks(replication_rank, 2, backend="gloo", timeout=180.0, threads=1)
    return check_replicated(per_rank, REPLICATED_OUTPUTS, "<probe:plane-replication>")


def _lattice_findings() -> List[Finding]:
    from ..index.sweep import DEFAULT_CHUNKS_PER_LAUNCH, plan_sweep
    from ..stream.serve import bucket_shape

    out = []
    sigs = {(p.rows_per_launch, p.chunk, p.cpl) for p in (plan_sweep(nq, 256) for nq in range(1, 4097))}
    bound = DEFAULT_CHUNKS_PER_LAUNCH + 2
    if len(sigs) > bound:
        out.append(Finding(
            "probe-recompile-lattice", "src/repro_torch/index/sweep.py", 0,
            f"plan_sweep emits {len(sigs)} launch signatures over nq in [1, 4096] at chunk 256 (bound {bound})",
            hint="launch shapes must quantize to the chunks_per_launch ladder"))
    buckets = {bucket_shape(nc, nb, db_tile=256, chunk=256, q_tile=128)
               for nc in range(1, 4097, 7) for nb in range(1, 257, 3)}
    b_bound = (int(math.log2(4096 // 256)) + 1) * (int(math.log2(256 // 128)) + 1)
    if len(buckets) > b_bound:
        out.append(Finding(
            "probe-recompile-lattice", "src/repro_torch/stream/serve.py", 0,
            f"bucket_shape's image has {len(buckets)} shapes (O(log n) bound {b_bound})",
            hint="bucket and chunk must both quantize to powers of two clamped to the tile bounds"))
    return out


class _Metrics:
    """The metrics switch on for a probe, as it was after."""

    def __enter__(self):
        from ..obs import metrics

        self.was = metrics.enabled()
        metrics.enable()
        return metrics

    def __exit__(self, *exc):
        from ..obs import metrics

        if not self.was:
            metrics.disable()


def _builds() -> dict:
    from ..kernels import _build

    return dict(_build.BUILDS)


def _paired_findings(device: str) -> List[Finding]:
    import numpy as np

    from .. import obs
    from ..index.random_projection import RandomProjectionBackend

    out = []
    with _Metrics() as metrics:
        obs.watch_recompiles("sweep.launch", "sweep.recompiles").reset()
        data = _probe_data(613, 40, 2)
        bk = RandomProjectionBackend(device=device, n_bits=64, margin=3.0, seed=3, chunk=64, q_tile=32, db_tile=64)
        bk.fit(data[:128])
        rows = np.arange(64)
        bk.query_counts(rows, 0.55)  # the first sweep's signature
        names = {n for pair in obs.PAIRED_COUNTERS for n in pair}
        base = {n: metrics.counter(n).value for n in names}
        for start in range(128, 613, 97):
            bk.partial_fit(data[start : start + 97])
            bk.query_counts(rows, 0.55)
        delta = {n: metrics.counter(n).value - base[n] for n in names}
    for left, right in obs.PAIRED_COUNTERS:
        if delta[left] != delta[right]:
            out.append(Finding(
                "probe-recompile-lattice", f"<probe:{left}>", 0,
                f"paired counters diverged over a steady-query-shape append workload: {left} moved "
                f"{delta[left]}, {right} moved {delta[right]}",
                hint="a launch operand other than the database capacity changed across appends"))
    twice = {k: v for k, v in _builds().items() if v > 1}
    if twice:
        out.append(Finding("probe-recompile-lattice", "src/repro_torch/kernels/_build.py", 0,
                           f"kernel sources built more than once under one hash in this process: {twice}",
                           hint="load() must find the library its first build wrote"))
    return out


@register("probe-recompile-lattice", family="probe", code="LAF105", reference="jaxpr-recompile-lattice",
          description="launch-signature lattices are bounded; sweep.recompiles pairs 1:1 with capacity "
          "doublings; one build per source hash")
def _check_recompile_lattice(ctx) -> List[Finding]:
    out = _lattice_findings()
    if ctx.dynamic:
        out.extend(_paired_findings(ctx.device))
    return out


def check_restore_signatures(pre, post, label: str) -> List[Finding]:
    """The restore contract as a predicate: every launch signature seen
    after a restore was already seen before the crash."""
    pre_set = set(pre)
    fresh = sorted({s for s in post if s not in pre_set}, key=repr)
    if fresh:
        return [Finding(
            "probe-restore-replica", label, 0,
            f"the restore introduced {len(fresh)} launch signature(s) absent before the crash: {fresh[:3]!r}",
            hint="state_import must rebuild the capacity-shaped buffers (append slack included), not trim them "
            "to the live rows")]
    return []


def _restore_findings(device: str) -> List[Finding]:
    import numpy as np

    from .. import obs
    from ..index.random_projection import RandomProjectionBackend

    kw = dict(device=device, n_bits=128, margin=3.0, seed=3, chunk=64, q_tile=32, db_tile=64)
    watcher = obs.watch_recompiles("sweep.launch", "sweep.recompiles")
    with _Metrics():
        data = _probe_data(400, 48, 5)
        bk = RandomProjectionBackend(**kw)
        bk.fit(data[:256])
        bk.partial_fit(data[256:])  # capacity doubles: append slack on board
        rows = np.arange(48)
        bk.query_counts(rows, 0.55)
        bk.query_hits(rows, 0.55)
        state = bk.state_export()
        pre, builds = watcher.signatures, sum(_builds().values())
        bk2 = RandomProjectionBackend(**kw).state_import(state)
        bk2.query_counts(rows, 0.55)
        bk2.query_hits(rows, 0.55)
        post = watcher.signatures
    out = check_restore_signatures(pre, post, "src/repro_torch/index/random_projection.py")
    if sum(_builds().values()) != builds:
        out.append(Finding("probe-restore-replica", "src/repro_torch/kernels/_build.py", 0,
                           "the restored replica built a kernel library re-running the pre-crash shapes",
                           hint="a restore reuses the process's loaded libraries"))
    return out


@register("probe-restore-replica", family="probe", code="LAF108", reference="jaxpr-restore-replica",
          description="a restored replica reuses the pre-crash launch signatures and builds nothing")
def _check_restore(ctx) -> List[Finding]:
    return _restore_findings(ctx.device) if ctx.dynamic else []


def sync_debug_findings() -> List[Finding]:
    """LAF103 on a card: a sweep (``query_bitmap_device``) and pass 2
    (``packed_cluster_labels``) enqueued, each under
    ``torch.cuda.set_sync_debug_mode("error")``, operands already on the
    card; a finding names the stage and the port's frames of the call
    that synchronized."""
    import traceback

    import torch

    from ..index.random_projection import RandomProjectionBackend
    from ..kernels.label_prop import packed_cluster_labels

    data = _probe_data(4096, 64, 11)
    bk = RandomProjectionBackend(device="cuda", n_bits=128).fit(data)
    rows = torch.arange(1024, device="cuda")
    rows32 = rows.to(torch.int32)
    bk.band(0.55)
    slab, _ = bk.query_bitmap_device(rows, 0.55)  # warm: the first call loads the libraries
    packed_cluster_labels(slab[:1024], rows32, 5, n=4096)
    torch.cuda.synchronize()
    stages = {"sweep": lambda: bk.query_bitmap_device(rows, 0.55),
              "pass 2": lambda: packed_cluster_labels(slab[:1024], rows32, 5, n=4096)}
    out = []
    prev = torch.cuda.get_sync_debug_mode()
    for stage, fn in stages.items():
        try:
            torch.cuda.set_sync_debug_mode("error")
            fn()
        except RuntimeError as exc:
            frames = [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                      for f in traceback.extract_tb(exc.__traceback__) if "repro_torch" in f.filename][-3:]
            out.append(Finding("trace-host-read-in-loop", f"<probe:sync-debug:{stage}>", 0,
                               f"the {stage} synchronized with the host at {' <- '.join(reversed(frames))}: "
                               f"{str(exc).splitlines()[0][:120]}",
                               hint="keep every decision of the enqueue on the device"))
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize()
    return out
