"""LAF clustering lowerings, the paper's workload, on the sharded index
plane (port of ``repro.launch.laf_cluster``).

:func:`build_laf_cluster` lowers one frontier round: the RMI predicts
the frontier's cardinalities (``rmi_mlp``, one launch a stage), the skip
gate keeps the rows predicted at or above ``alpha * tau``, and the whole
frontier is range-counted against the database, whose rows are sharded
over ``index_axes`` (``"auto"``: every mesh axis).  With
``backend="random_projection"`` the packed sign-signature table rides
co-sharded with the rows (``repro_torch.distributed.index_plane``), the
frontier's signatures are packed once a step, and hits follow the
backend's band contract (sure-accept at or below ``t_lo``, the band
verified exactly).  ``index_device`` picks the evaluator:

* ``True``: the Hamming-filter kernel on each rank's block, one launch a
  chunk (``index_plane.sweep_marginals_local``); only the per-query count
  all-reduces cross ranks, pipelined at ``index_pipeline``; the per-row
  partial counts stay where the rows live;
* ``False``: the plain dataflow of ``index.signatures.band_hits`` (a
  product, the Hamming distances, the predicate), one count all-reduce
  after the chunks: an option the caller names, not a fallback;
* ``"auto"``: the kernel on a CUDA database, the port's device policy.

The database is padded with zero rows to a rank multiple; a zero row's
signature is all zeros, and the evaluators mask every all-zero row
exactly.  ``web_1b`` keeps the reference's bf16 database above 10^7
rows; the Hamming kernel and the plain product read fp32, so a bf16
block is widened once a step (a rank's 6.4 GB of bf16 at ``web_1b`` on
256 ranks becomes 12.9 GB of fp32 beside it, which the dry run's
memory shows).

:func:`build_one_launch_cluster` lowers cluster formation over the
sweep's packed slab, column-sharded over ``index_axes``: exact counts
(``row_popcount``, summed over the ranks once), the tau core test,
label propagation to its fixpoint and the border owner (``col_reduce``),
as ``kernels.label_prop.packed_cluster_fixpoint`` documents.  On one
rank the fixpoint is one cooperative ``label_prop_fixpoint`` launch; on
several each round is ``label_prop_rect``, a MIN all-reduce of the (R,)
row minima and ``label_prop_update``, and the packed words never cross
ranks.  ``cap`` is ``n`` rounded up so every shard holds whole words.
The reference donates ``rows`` into the counts output; PyTorch has no
donation, and laf-lint's LAF101 instead holds the traced peak of this
cell to its arguments, outputs and one set of row vectors.

A cell's ``args`` are one rank's arguments as fake tensors
(``launch.cell``); ``step_fn`` runs on real tensors of the same shapes
too.  Every rank builds its cells at the same point of its program (the
plane's process groups are made then).
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs.registry import ArchSpec, ShapeSpec
from ..distributed.index_plane import ShardPlan, plane_collective, sweep_marginals_local
from ..distributed.sharding import axis_size, plane_axes
from .cell import LoweredCell, placements

__all__ = ["build_laf_cluster", "build_one_launch_cluster", "frontier_inputs", "slab_inputs"]


def _axes(base, mesh):
    return tuple(mesh.mesh_dim_names) if base.index_axes == "auto" else (
        (base.index_axes,) if isinstance(base.index_axes, str) else tuple(base.index_axes))


def _chunks(frontier: int, n_local: int, use_rp: bool) -> int:
    """The reference's chunk count: the live (chunk, n_local) score tile
    bounded to about 0.5 GiB (half of it on the index path)."""
    rows_budget = max(32, int((0.625e8 if use_rp else 1.25e8) / max(n_local, 1)))
    n_chunks = 1
    while frontier // n_chunks > rows_budget and n_chunks < frontier:
        n_chunks *= 2
    return n_chunks


def build_laf_cluster(arch: ArchSpec, shape: ShapeSpec, mesh, *, device="cuda") -> LoweredCell:
    """One frontier round (module docstring).  ``step_fn(rmi, db, queries,
    db_sig=None) -> (counts (frontier,) int32, partial (n_local,) int32,
    pred (frontier,) fp32)``: ``db`` / ``db_sig`` this rank's blocks,
    ``rmi`` the estimator (``core.cardinality.rmi.RMI``) and ``queries``
    the frontier, the same on every rank."""
    from ..core.cardinality.rmi import RMI, RMIConfig, rmi_predict_counts
    from ..index.signatures import band_hits, hamming_band, hamming_words, make_projection, pack_bits

    base = arch.make_config()
    n, d = shape.meta["n_points"], shape.meta["dim"]
    n_dev = mesh.size()
    n = -(-n // n_dev) * n_dev  # zero rows to a rank multiple
    dtype = torch.bfloat16 if n > 10_000_000 else torch.float32
    frontier = base.frontier
    rmi_cfg = RMIConfig(input_dim=d + 1)
    axes = _axes(base, mesh)
    n_shards = axis_size(mesh, axes)
    plan = ShardPlan(axes, n_shards, shape.meta["n_points"], n)
    ax = plane_axes(mesh, axes)
    thresh = 1.0 - base.eps
    use_rp = base.backend == "random_projection"
    dev_type = torch.device(device).type
    use_kernel = use_rp and (dev_type == "cuda" if base.index_device == "auto" else bool(base.index_device))
    n_chunks = _chunks(frontier, n // n_dev, use_rp)
    if use_rp:
        n_bits, words = base.index_bits, base.index_bits // 32
        proj_np = make_projection(d, n_bits, seed=base.index_seed)
        t_lo, t_hi = hamming_band(base.eps, n_bits, margin=base.index_margin)
        if base.index_verify == "full":
            t_lo = -1

    def cluster_step(rmi, db, queries, db_sig=None):
        """One frontier round: the RMI's predictions, the gate, the whole
        frontier counted against this rank's rows (partial counts stay
        here), the counts summed over the ranks."""
        from .. import exact_fp32

        exact_fp32()  # the signatures and the verify threshold fp32 products
        f, dev = queries.shape[0], queries.device
        feats = torch.cat([queries, torch.full((f, 1), base.eps, dtype=queries.dtype, device=dev)], dim=1)
        pred = rmi_predict_counts(rmi, feats.float())
        gate = (pred >= base.alpha * base.tau).to(torch.float32)  # the skip decisions
        db32 = db if db.dtype == torch.float32 else db.float()
        qs = queries.float().reshape(n_chunks, f // n_chunks, d)
        if use_rp:
            proj = torch.as_tensor(proj_np, device=dev)
            q_sigs = pack_bits((queries.float() @ proj) >= 0.0).reshape(n_chunks, f // n_chunks, words)
        if use_kernel:
            counts, partial = sweep_marginals_local(qs, db32, q_sigs, db_sig.contiguous(), base.eps, t_lo, t_hi, ax,
                                                    depth=base.index_pipeline)
            counts = counts.reshape(f)
        else:
            valid = (db32 != 0).any(dim=1)
            parts = []
            partial = torch.zeros(db.shape[0], dtype=torch.int32, device=dev)
            for k in range(n_chunks):
                dots = qs[k] @ db32.T
                if use_rp:
                    hit = band_hits(dots, hamming_words(q_sigs[k], db_sig), base.eps, t_lo, t_hi) & valid[None, :]
                else:
                    hit = dots > thresh
                parts.append(hit.sum(dim=1, dtype=torch.int32))
                partial += hit.sum(dim=0, dtype=torch.int32)
            counts = torch.cat(parts)
            plane_collective("sum", counts, ax.group)
        counts = (counts.to(torch.float32) * gate).to(torch.int32)
        return counts, partial, pred

    with torch.device("meta"):
        rmi = RMI(rmi_cfg)
    with FakeTensorMode(allow_non_fake_inputs=True), torch.device(device):
        rmi = rmi.to_empty(device=device)
        args = (rmi, torch.empty((plan.n_local, d), dtype=dtype), torch.empty((frontier, d), dtype=dtype))
        if use_rp:
            args = args + (torch.empty((plan.n_local, words), dtype=torch.int32),)
    pl = (placements(mesh), placements(mesh, axes, 0), placements(mesh))
    if use_rp:
        pl = pl + (placements(mesh, axes, 0),)
    meta = {
        "kind": "cluster", "n_points": n, "dim": d, "frontier": frontier, "dtype": str(dtype).split(".")[-1],
        "n_chunks": n_chunks, "plan": {"n": plan.n, "n_padded": plan.n_padded, "n_local": plan.n_local},
        "index_axes": axes, "n_shards": n_shards,
    }
    if use_rp:
        meta.update(
            index_bits=base.index_bits, index_seed=base.index_seed, index_margin=base.index_margin,
            index_verify=base.index_verify, index_band=(t_lo, t_hi), fused_kernel=use_kernel,
            sharded=use_kernel and n_shards > 1, index_pipeline=base.index_pipeline,
            db_widened=dtype != torch.float32,
        )
    return LoweredCell(f"{arch.name}:{shape.name}", cluster_step, args, pl, meta)


def build_one_launch_cluster(arch: ArchSpec, shape: ShapeSpec, mesh, *, device="cuda") -> LoweredCell:
    """Cluster formation over the sweep's packed slab (module docstring).
    ``step_fn(bitmap, rows, tau)``: ``bitmap`` this rank's (R, W_local)
    int32 words of the (R, cap/32) slab (bits past n clear), ``rows`` the
    (R,) int32 database index of each slab row (>= n on padding rows),
    ``tau`` a (1,) int32 tensor.  Returns ``(labels (cap,), owner
    (cap_local,), col_sum (cap_local,), counts (R,), rounds ())`` as
    ``packed_cluster_fixpoint`` documents, owner and col_sum this rank's
    columns, plus the (4, 64) per-round telemetry when it is on."""
    from ..kernels.label_prop import packed_cluster_fixpoint

    base = arch.make_config()
    n = shape.meta["n_points"]
    frontier = base.frontier
    axes = _axes(base, mesh)
    n_shards = axis_size(mesh, axes)
    cap = -(-n // (32 * n_shards)) * (32 * n_shards)
    w_loc = cap // 32 // n_shards
    ax = plane_axes(mesh, axes)
    if base.telemetry == "auto":
        from ..obs import device_enabled

        tele_on = device_enabled()
    else:
        tele_on = bool(base.telemetry)

    def cluster_one_launch(bitmap, rows, tau):
        return packed_cluster_fixpoint(bitmap, rows, tau, n=n, cap=cap, telemetry=tele_on,
                                       col_off=ax.index * w_loc * 32, group=ax.group)

    with FakeTensorMode(allow_non_fake_inputs=True), torch.device(device):
        args = (torch.empty((frontier, w_loc), dtype=torch.int32), torch.empty((frontier,), dtype=torch.int32),
                torch.empty((1,), dtype=torch.int32))
    meta = {
        "kind": "one_launch_cluster", "n_points": n, "cap": cap, "frontier": frontier, "index_axes": axes,
        "n_shards": n_shards, "w_local": w_loc, "telemetry": tele_on,
        "plan": {"n": n, "n_padded": cap, "n_local": cap // n_shards},
        "rounds_loop": "label_prop.rounds" if n_shards > 1 else None,
        "max_iters": 64,
    }
    pl = (placements(mesh, axes, 1), placements(mesh), placements(mesh))
    return LoweredCell(f"{arch.name}:{shape.name}:one_launch", cluster_one_launch, args, pl, meta)


def _rank_index(mesh, meta) -> int:
    return plane_axes(mesh, tuple(meta["index_axes"])).index


def frontier_inputs(cell: LoweredCell, mesh, data, queries, *, device):
    """This rank's ``(db, queries, db_sig)`` for a frontier cell: its
    block of the whole database ``data`` (n, d), zero rows past n, in the
    cell's dtype, the frontier rows ``queries``, and (random-projection
    cells) the block's signatures with the cell's projection (zero
    signatures on the zero rows).  ``db_sig`` is None otherwise."""
    import numpy as np

    from ..index.signatures import make_projection, sign_signatures

    meta = cell.meta
    n_local = meta["plan"]["n_local"]
    dtype = getattr(torch, meta["dtype"])
    data = torch.as_tensor(np.asarray(data, dtype=np.float32))
    lo = _rank_index(mesh, meta) * n_local
    real = data[lo : lo + n_local]
    block = torch.zeros((n_local, data.shape[1]), dtype=torch.float32)
    block[: real.shape[0]] = real
    db = block.to(device=device, dtype=dtype)
    q = torch.as_tensor(np.asarray(queries, dtype=np.float32)).to(device=device, dtype=dtype)
    if "index_bits" not in meta:
        return db, q, None
    proj = make_projection(data.shape[1], meta["index_bits"], seed=meta["index_seed"])
    sig = torch.zeros((n_local, meta["index_bits"] // 32), dtype=torch.int32, device=device)
    if real.shape[0]:
        sig[: real.shape[0]] = sign_signatures(real, proj, device=device)
    return db, q, sig


def slab_inputs(cell: LoweredCell, mesh, slab, rows, tau: int, *, device):
    """This rank's ``(bitmap, rows, tau)`` for a one-launch cell from the
    whole (R, <= cap/32) int32 slab (bits past n clear): its words, zero
    words past the slab; ``rows`` (R,) int32; ``tau`` as a (1,) tensor."""
    meta = cell.meta
    w_loc = meta["w_local"]
    slab = torch.as_tensor(slab).to(device=device, dtype=torch.int32)
    k = _rank_index(mesh, meta)
    words = torch.zeros((slab.shape[0], w_loc), dtype=torch.int32, device=device)
    part = slab[:, k * w_loc : (k + 1) * w_loc]
    words[:, : part.shape[1]] = part
    return (words, torch.as_tensor(rows).to(device=device, dtype=torch.int32),
            torch.tensor([int(tau)], dtype=torch.int32, device=device))
