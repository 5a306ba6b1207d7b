"""LAF-DBSCAN — Algorithm 1 of the paper (port of ``repro.core.laf_dbscan``).

* ``laf_dbscan_sequential`` — the line-by-line transcription of the
  pseudocode, used for validation: a host loop whose range queries run
  one at a time on the exact backend.
* ``laf_dbscan`` — the batch engine: every predicted-core point runs one
  range query (pass 1), cluster formation runs over the packed adjacency
  (pass 2), and the post-processing rescue (Algorithm 3) merges the
  clusters a false-negative core prediction separated.

Pass 1 + 2 on the device (``cluster_device`` true, or ``"auto"`` with a
backend that packs natively): the sweep's packed slab stays on the
device and feeds the packed label propagation; the host reads labels,
owners, partial counts, neighbor counts and rounds in ONE copy
(``laf.cluster.host_syncs``).  ``cluster_device=False`` runs the host
unpack -> union-find pass over the same hits, the parity oracle.  A
device failure of the cluster pass (a refused launch, among them
``label_prop_fixpoint``'s cooperative launch when its grid cannot be
resident, or a ``testing.faults`` plan firing at ``cluster.launch``)
raises; the host pass never stands in for it.  A backend sharded over
a ``DeviceMesh`` (``RandomProjectionBackend(mesh=)``) runs the pass on
the index plane (``distributed.index_plane.sharded_cluster_labels``):
every rank sweeps its columns, runs the fixpoint and makes the one host
copy; the results are the same on every rank.

Spans (``obs.enable(trace=True)``) follow the reference's:
``laf.cluster`` around the engine, ``laf.fit_index``, ``laf.pass1`` ⊃
``laf.sweep``, ``laf.label_prop`` (device pass; with device telemetry
its per-round counts ride the pass's one host copy and become
``laf.cluster.round`` child spans), ``laf.union_find`` ⊃ ``laf.unpack``
(host pass) and ``laf.postprocess``.  No span syncs: each closes on the
host clock, after whatever sync its work already makes.
"""

from __future__ import annotations

from collections import deque
from typing import Callable

import numpy as np
import torch

from ..obs import device as _obs_device
from ..obs import metrics as _metrics
from ..obs import span as _span
from ..obs.metrics import PhaseClock
from .dbscan import NOISE, UNDEFINED, DBSCANResult
from .postprocess import PartialNeighborMap, post_processing, update_partial_neighbors
from .range_query import pack_bitmap, unpack_bitmap
from .union_find import compact_labels, compact_labels_from_parent, union_star

__all__ = ["laf_dbscan_sequential", "laf_dbscan", "labels_from_reps"]

_compact = compact_labels


def laf_dbscan_sequential(
    data: np.ndarray,
    eps: float,
    tau: int,
    alpha: float,
    card_est: Callable[[int], float],
    *,
    seed: int = 0,
    device=None,
) -> DBSCANResult:
    """Algorithm 1, faithful transcription; ``card_est(i)`` returns the
    predicted cardinality of point i.  Each range query is one row of
    the exact backend on ``device`` (``None`` = cuda): predicted-stop
    points are never queried."""
    from ..index import as_fitted

    data = np.asarray(data, dtype=np.float32)
    n = data.shape[0]
    labels = np.full(n, UNDEFINED, dtype=np.int64)
    core = np.zeros(n, dtype=bool)
    queries = 0
    emap = PartialNeighborMap()                        # LAF: map 𝓔 (line 2)
    bk = as_fitted("exact", data, device=device)

    def range_query(i: int) -> np.ndarray:
        nonlocal queries
        queries += 1
        return np.nonzero(bk.query_hits(np.array([i]), eps)[0])[0]

    c = 0
    for p in range(n):
        if labels[p] != UNDEFINED:                     # line 5
            continue
        if card_est(p) < alpha * tau:                  # LAF: line 6
            labels[p] = NOISE                          # line 7
            emap.register(p)                           # LAF: line 8
            continue                                   # line 9
        nbrs = range_query(p)                          # line 10
        update_partial_neighbors(p, nbrs, emap)        # LAF: line 11
        if len(nbrs) < tau:                            # line 12
            labels[p] = NOISE                          # line 13
            continue                                   # line 14
        core[p] = True
        labels[p] = c                                  # line 15
        seeds = deque(int(q) for q in nbrs if q != p)  # line 16: S := N - {P}
        while seeds:                                   # line 17
            q = seeds.popleft()
            if labels[q] == NOISE:                     # line 18
                labels[q] = c
            if labels[q] != UNDEFINED:                 # line 19
                continue
            labels[q] = c                              # line 21
            if card_est(q) >= alpha * tau:             # LAF: line 22
                qn = range_query(q)                    # line 23
                update_partial_neighbors(q, qn, emap)  # LAF: line 24
                if len(qn) >= tau:                     # line 25
                    core[q] = True
                    seeds.extend(int(x) for x in qn)
            else:
                emap.register(q)                       # LAF: line 26-27
        c += 1
    labels = post_processing(                          # LAF: line 28
        labels, emap, tau, rng=np.random.default_rng(seed)
    )
    labels = _compact(labels)
    n_clusters = int(labels.max()) + 1 if labels.max() >= 0 else 0
    return DBSCANResult(labels, core, n_clusters, queries, {"n_registered": len(emap)})


def laf_dbscan(
    data: np.ndarray,
    eps: float,
    tau: int,
    alpha: float,
    predicted_counts: np.ndarray,
    *,
    block_size: int = 2048,
    seed: int = 0,
    backend="exact",
    device=None,
    cluster_device="auto",
) -> DBSCANResult:
    """Batch-parallel LAF-DBSCAN engine.

    Args:
      predicted_counts: (n,) estimator predictions for every point at
        this eps.
      backend: range-query backend (registry name or constructed
        instance, ``repro_torch.index``).
      device: torch device of a backend built from a name (``None`` =
        cuda, raising without a card; ``"cpu"`` runs the plain versions);
        a constructed instance keeps its own.
      cluster_device: ``"auto"`` runs the device cluster pass when the
        backend packs natively, ``True`` forces it (the backend's packed
        blocks come from ``query_packed_device``), ``False`` runs the
        host union-find pass.
    """
    data = np.asarray(data, dtype=np.float32)
    with _span("laf.cluster", n=data.shape[0], eps=float(eps), tau=int(tau)):
        return _laf_dbscan_body(data, eps, tau, alpha, predicted_counts, block_size=block_size,
                                seed=seed, backend=backend, device=device,
                                cluster_device=cluster_device)


def _laf_dbscan_body(data, eps, tau, alpha, predicted_counts, *, block_size, seed, backend,
                     device, cluster_device):
    from ..index import as_fitted

    n = data.shape[0]
    clock = PhaseClock.for_engine(backend, device)
    with _span("laf.fit_index", backend=str(backend)):
        bk = as_fitted(backend, data, block_size=block_size, device=device)
    clock.mark("fit_index")
    predicted_core = np.asarray(predicted_counts) >= alpha * tau  # LAF skip rule
    exec_idx = np.nonzero(predicted_core)[0]
    n_exec = len(exec_idx)
    _metrics.counter("laf.runs").inc()
    _metrics.counter("laf.predicted_core").inc(int(n_exec))
    _metrics.counter("laf.skipped").inc(int(n - n_exec))

    native = bool(bk.packs_natively)
    use_device = native if cluster_device == "auto" else bool(cluster_device)
    if use_device and n_exec:
        labels, core, partial_counts = _cluster_pass_device(
            bk, eps, tau, exec_idx, n, native, block_size, clock
        )
    else:
        labels, core, partial_counts = _cluster_pass_host(
            bk, eps, tau, exec_idx, n, block_size, clock
        )
    partial_counts[predicted_core] = 0  # 𝓔 keys are predicted-stop points only
    res = _rescue_and_finish(
        bk, eps, tau, seed, block_size, n, exec_idx, predicted_core,
        labels, core, partial_counts,
    )
    clock.mark("rescue")
    clock.publish("laf.phase")
    return res


def _cluster_pass_device(bk, eps, tau, exec_idx, n, native, block_size, clock):
    """Device pass 1 + pass 2 with one host copy of the results.

    Returns ``(labels, core, partial_counts)`` with values identical to
    the host pass (min-core-index component representatives are what
    ``union_star``'s min-root merging produces).
    """
    from ..kernels.label_prop import packed_cluster_labels
    from ..testing import faults as _faults

    _faults.maybe_fail("cluster.launch", n=int(n), n_exec=int(len(exec_idx)))
    n_exec = len(exec_idx)
    mesh = getattr(bk, "mesh", None) if native else None
    with _span("laf.pass1", n=n, n_exec=int(n_exec), block_size=block_size, device=True):
        # uploaded before the sweep: a host->device copy waits for the stream
        exec_t = torch.from_numpy(exec_idx).to(device=bk.device, dtype=torch.int32)
        if native:
            with _span("laf.sweep", rows=int(n_exec), synced=False):
                # a sharded backend gathers its queries on the host
                slab, plan = bk.query_bitmap_device(exec_t if mesh is None else exec_idx, eps)
            rows = torch.full((plan.nq_padded,), n, dtype=torch.int32, device=bk.device)
            rows[:n_exec] = exec_t
        else:
            blocks = []
            for s in range(0, n_exec, block_size):
                blk = exec_idx[s : s + block_size]
                with _span("laf.sweep", block=s // block_size, rows=len(blk)):
                    blocks.append(bk.query_packed_device(blk, eps))
            slab = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
            rows = exec_t
    clock.mark("sweep")
    telemetry = _obs_device.device_enabled()
    lp_span = _span("laf.label_prop", rows=int(rows.shape[0]), n=n, telemetry=telemetry)
    with lp_span:
        if mesh is not None:
            from ..distributed.index_plane import sharded_cluster_labels

            outs = sharded_cluster_labels(slab, rows, tau, mesh=mesh, axes=bk._plan.axes, n=n,
                                          telemetry=telemetry)
        else:
            outs = packed_cluster_labels(slab, rows, tau, n=n, telemetry=telemetry)
        labels_d, owner_d, col_sum_d, counts_d, rounds_d = outs[:5]
        clock.mark("label_prop")
        parts = [labels_d[:n], owner_d[:n], col_sum_d[:n], counts_d[:n_exec], rounds_d.view(1)]
        sweep_stats = _obs_device.take_deferred_sweep_stats() if telemetry else None
        if telemetry:
            parts.append(outs[5].view(-1))  # the per-round counts ride the same copy
        if sweep_stats is not None:
            parts.append(sweep_stats.view(-1))  # and the plane sweep's occupancy
        # THE host sync of the cluster pass: every result in one copy
        flat = torch.cat(parts).cpu().numpy()
        _metrics.counter("laf.cluster.host_syncs").inc()
    rep, owner, col_sum = flat[:n], flat[n : 2 * n].astype(np.int64), flat[2 * n : 3 * n]
    counts = flat[3 * n : 3 * n + n_exec]
    rounds = int(flat[3 * n + n_exec])
    _metrics.gauge("laf.cluster.last_rounds").set(rounds)
    _metrics.counter("laf.cluster.rounds").inc(rounds)
    if telemetry:
        t0 = 3 * n + n_exec + 1
        t1 = t0 + outs[5].numel()
        tele = flat[t0:t1].reshape(len(_obs_device.CLUSTER_ROUND_FIELDS), -1)
        if sweep_stats is not None:
            _obs_device.harvest_sweep_telemetry(flat[t1:].reshape(-1, 3))
        per_round = _obs_device.harvest_cluster_telemetry(tele, rounds)
        _obs_device.emit_round_spans(getattr(lp_span, "_rec", None), per_round)

    core = np.zeros(n, dtype=bool)
    core[exec_idx] = counts >= tau
    return labels_from_reps(rep, owner, core), core, col_sum.astype(np.int64)


def labels_from_reps(rep: np.ndarray, owner: np.ndarray, core: np.ndarray) -> np.ndarray:
    """Cluster labels 0..k-1 from the device pass's per-column component
    representatives (min core index: the union-find root the host pass
    produces, so label numbers match after ``np.unique``) and border
    owners (a core row index, or >= n for none); -1 is noise."""
    n = len(core)
    labels = np.full(n, -1, dtype=np.int64)
    ci = np.nonzero(core)[0]
    if len(ci):
        _, inv = np.unique(rep[ci], return_inverse=True)
        labels[ci] = inv
    owner = np.asarray(owner, dtype=np.int64)
    borders = np.nonzero(~core & (owner < n))[0]
    labels[borders] = labels[owner[borders]]
    return labels


def _cluster_pass_host(bk, eps, tau, exec_idx, n, block_size, clock):
    """Pass 1 through ``query_hits`` + the host unpack -> union-find pass
    (the parity oracle of the device pass)."""
    exact_counts = np.zeros(n, dtype=np.int64)
    partial_counts = np.zeros(n, dtype=np.int64)  # |𝓔(q)| for predicted-stop q
    packed_blocks = []
    with _span("laf.pass1", n=n, n_exec=int(len(exec_idx)), block_size=block_size):
        for start in range(0, len(exec_idx), block_size):
            rows = exec_idx[start : start + block_size]
            with _span("laf.sweep", block=start // block_size, rows=len(rows)):
                hit = bk.query_hits(rows, eps)  # (b, n)
            exact_counts[rows] = hit.sum(axis=1)
            # Alg. 2 superset: every predicted-stop neighbor of an executed
            # query gains one partial neighbor
            partial_counts += hit.sum(axis=0)
            packed_blocks.append((rows, pack_bitmap(hit)))
    clock.mark("sweep")

    core = np.zeros(n, dtype=bool)
    core[exec_idx] = exact_counts[exec_idx] >= tau
    parent = np.arange(n, dtype=np.int64)
    owner = np.full(n, -1, dtype=np.int64)
    with _span("laf.union_find", blocks=len(packed_blocks)):
        for rows, packed in packed_blocks:
            with _span("laf.unpack", rows=len(rows)):
                hit = unpack_bitmap(packed, n)
            row_is_core = core[rows]
            hit_core = hit & core[None, :]
            for bi in np.nonzero(row_is_core)[0]:
                union_star(parent, np.nonzero(hit_core[bi])[0])
            if row_is_core.any():
                sub = hit[row_is_core]
                subrows = rows[row_is_core]
                claimed = sub.any(axis=0)
                todo = claimed & (owner < 0) & ~core
                if todo.any():
                    first = sub[:, todo].argmax(axis=0)
                    owner[todo] = subrows[first]
        labels = compact_labels_from_parent(parent, core)
        borders = np.nonzero(~core & (owner >= 0))[0]
        labels[borders] = labels[owner[borders]]
    clock.mark("union_find")
    return labels, core, partial_counts


def _rescue_and_finish(
    bk, eps, tau, seed, block_size, n, exec_idx, predicted_core,
    labels, core, partial_counts,
):
    """Post-processing rescue (Algorithm 3) + result assembly, shared by
    the host and device cluster passes."""
    n_exec = len(exec_idx)
    n_pre_clusters = int(labels.max()) + 1 if labels.max() >= 0 else 0
    rescue_idx = np.nonzero(~predicted_core & (partial_counts >= tau))[0]
    _metrics.counter("laf.rescued").inc(int(len(rescue_idx)))
    with _span("laf.postprocess", n_rescue=int(len(rescue_idx))):
        emap = PartialNeighborMap()
        if len(rescue_idx) > 0:
            for start in range(0, n_exec, block_size):
                rows = exec_idx[start : start + block_size]
                hit = bk.query_hits_subset(rows, rescue_idx, eps)  # (b, n_rescue)
                for ri in np.nonzero(hit.any(axis=0))[0]:
                    r = int(rescue_idx[ri])
                    emap.register(r)
                    emap[r].update(int(f) for f in rows[hit[:, ri]])
        labels = post_processing(labels, emap, tau, rng=np.random.default_rng(seed))
        labels = _compact(labels)

    extras = {
        "n_predicted_core": int(n_exec),
        "n_skipped": int(n - n_exec),
        "n_rescued": int(len(rescue_idx)),
        "n_pre_merge_clusters": n_pre_clusters,
        "false_negative_core": int(np.sum(~predicted_core & (partial_counts >= tau))),
    }
    n_clusters = int(labels.max()) + 1 if labels.max() >= 0 else 0
    return DBSCANResult(labels, core, n_clusters, n_exec, extras)
