#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full check, one card

Phases (each prints one JSON line; any failure exits nonzero):

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build: every CUDA source of the port, one ``nvcc`` per source;
3. main path at the paper's MS-150k operating point: seeded vMF data
   (152,185 x 768), ``LAFPipeline(backend="random_projection")
   .fit_split`` (estimator epochs cut to ``--epochs``), then
   ``cluster_laf_dbscan(test, eps=0.55, tau=5, alpha=1.5)`` on the
   30,437-row test split, with every kernel's launch count set to 0
   just before and read just after;
4. cluster-pass parity: the same sweep through the port's host
   union-find pass (``cluster_device=False``) gives identical labels;
   quality: ARI of the LAF labels against exact DBSCAN of the test split
   (exact fp32 adjacency through the same packed cluster pass);
5. each kernel against its plain PyTorch version on the card at the main
   path's shapes, with its time, the plain version's time and its bound.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the port's sources beside this file, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
KERNELS = {
    "hamming_filter": ("src/repro_torch/csrc/hamming_filter.cu",
                       "src/repro/kernels/hamming_filter/kernel.py:179"),
    "label_prop_rect": ("src/repro_torch/csrc/label_prop.cu",
                        "src/repro/kernels/label_prop/kernel.py:104"),
    "col_reduce": ("src/repro_torch/csrc/label_prop.cu",
                   "src/repro/kernels/label_prop/kernel.py:173"),
    "label_prop_update": ("src/repro_torch/csrc/label_prop.cu",
                          "src/repro/kernels/label_prop/ops.py:211 (jnp inside the fixpoint; no Pallas kernel)"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 1


def ari(a: np.ndarray, b: np.ndarray) -> float:
    """Adjusted Rand index (noise -1 is one label, as in the repo's metric)."""
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    m = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(m, (ai, bi), 1)
    c2 = lambda x: (x * (x - 1) / 2.0).sum()
    s, sa, sb = c2(m), c2(m.sum(1)), c2(m.sum(0))
    exp = sa * sb / c2(np.array([len(a)]))
    mx = 0.5 * (sa + sb)
    return 1.0 if mx == exp else float((s - exp) / (mx - exp))


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, flops: float = 0.0):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def device_busy(fn):
    """(wall s, device busy s) of one call under ``torch.profiler``: the
    summed durations of the trace's device events, every kernel and copy
    the call ran (one stream, so the intervals do not overlap).  The profiler's own cost
    lengthens the wall time, so the idle share it gives is an upper
    bound.  Busy is None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall, (busy_us / 1e6 if busy_us > 0 else None)


def exact_dbscan_labels(x, eps, tau, *, block=2048):
    """Exact DBSCAN of ``x`` (all rows queried, fp32 dot > 1 - eps) through
    the port's packed cluster pass: the ground truth LAF is scored on."""
    import torch

    from repro_torch import exact_fp32
    from repro_torch.core.laf_dbscan import labels_from_reps
    from repro_torch.core.range_query import pack_bitmap_t
    from repro_torch.kernels.label_prop import packed_cluster_labels

    exact_fp32()
    n = x.shape[0]
    slab = torch.empty((n, -(-n // 32)), dtype=torch.int32, device=x.device)
    for s in range(0, n, block):
        slab[s : s + block] = pack_bitmap_t(x[s : s + block] @ x.T > 1.0 - eps)
    rows = torch.arange(n, dtype=torch.int32, device=x.device)
    rep, owner, _, counts, _ = packed_cluster_labels(slab, rows, tau, n=n)
    flat = torch.cat([rep[:n], owner[:n], counts]).cpu().numpy()
    core = flat[2 * n :] >= tau
    return labels_from_reps(flat[:n], flat[n : 2 * n], core)


def check_hamming(bk, exec_idx, eps, k1_rows):
    """K1 vs its plain version: 4096 executed queries x the whole test db."""
    import torch

    from repro_torch.index.signatures import hamming_words, popcount32
    from repro_torch.kernels.hamming_filter import hamming_filter_bitmap, hamming_filter_count
    from repro_torch.kernels.hamming_filter.ref import hamming_filter_ref

    t_lo, t_hi = bk.band(eps)
    q, qs = bk._gather(exec_idx[:k1_rows])
    db, dbs = bk._data_dev, bk._sigs_dev
    nq, d, nd, w = q.shape[0], q.shape[1], db.shape[0], qs.shape[1]
    kc, kb = hamming_filter_bitmap(q, db, qs, dbs, eps, t_hi, t_lo=t_lo)
    pc, pb = hamming_filter_ref(q, db, qs, dbs, eps, t_lo, t_hi)
    # flipped pairs must sit within the fp32 summation-order bound of the
    # threshold: |dot - (1-eps)| <= 2 (d-1) 2^-24 for unit vectors
    tol = 2 * (d - 1) * 2.0 ** -24
    diff = kb ^ pb
    wi, wj = torch.nonzero(diff, as_tuple=True)
    pairs = []
    for i, c, word in zip(wi.tolist(), wj.tolist(), diff[wi, wj].tolist()):
        word &= 0xFFFFFFFF
        pairs += [(i, 32 * c + b) for b in range(32) if word >> b & 1]
    margin = 0.0
    if pairs:
        pi, pj = (torch.tensor(v, device=q.device) for v in zip(*pairs))
        dots = (q[pi].double() * db[pj].double()).sum(dim=1)
        margin = float((dots - (1.0 - eps)).abs().max())
    flips_per_row = popcount32(kb).sum(1) - popcount32(pb).sum(1)
    counts_ok = bool(torch.equal(kc - pc, flips_per_row))
    band = 0
    for s in range(0, nd, 1024):
        ham = hamming_words(qs, dbs[s : s + 1024])
        band += int(((ham > t_lo) & (ham <= t_hi)).sum())
    ms = time_ms(lambda: hamming_filter_bitmap(q, db, qs, dbs, eps, t_hi, t_lo=t_lo))
    count_ms = time_ms(lambda: hamming_filter_count(q, db, qs, dbs, eps, t_hi, t_lo=t_lo))
    counts_only_ok = bool(torch.equal(hamming_filter_count(q, db, qs, dbs, eps, t_hi, t_lo=t_lo), kc))
    plain = time_ms(lambda: hamming_filter_ref(q, db, qs, dbs, eps, t_lo, t_hi), reps=2, warmup=1)
    n_bytes = 4 * (nq * d + nd * d + (nq + nd) * w + nq * (1 + -(-nd // 32)))
    b_ms, b_by = bound_ms(n_bytes, 2 * d * band)
    ok = counts_ok and counts_only_ok and margin <= tol
    return ok, {
        "name": "hamming_filter", "shape": [nq, nd, d, w], "max_abs_err": int((kc - pc).abs().max()),
        "bit_flips": len(pairs), "flip_max_margin": margin, "tolerance": tol,
        "band_pairs": band, "popcount_ops": nq * nd * w,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "count_only_ms": count_ms,
    }


def check_label_prop(bk, exec_idx, eps, tau):
    """K2, the update step and K3 vs their plain versions on the main
    path's full slab (exact equality: integer results)."""
    import torch

    from repro_torch.kernels.label_prop import col_reduce, label_prop_rect, label_prop_update
    from repro_torch.kernels.label_prop.ops import fixpoint_inputs
    from repro_torch.kernels.label_prop.ref import (
        BIG, col_reduce_ref, label_prop_rect_ref, label_prop_update_ref,
    )

    n = bk.n_points
    slab, plan = bk.query_bitmap_device(exec_idx, eps)
    rows = np.full(plan.nq_padded, n, dtype=np.int64)
    rows[: len(exec_idx)] = exec_idx
    r, w = slab.shape
    cap = w * 32
    rows_t, valid_r, _, core_r, pos, init = fixpoint_inputs(
        slab, torch.from_numpy(rows), tau, n=n, cap=cap)
    big_rows = torch.full((r,), BIG, dtype=torch.int32, device=slab.device)
    vals, weights = torch.where(core_r, rows_t, BIG), valid_r.to(torch.int32)
    out = []

    m = label_prop_rect(big_rows, init, slab)
    m_ref = label_prop_rect_ref(big_rows, init, slab)
    b_ms, b_by = bound_ms(4 * (r * w + 32 * w + 2 * r))
    out.append({
        "name": "label_prop_rect", "shape": [r, w], "max_abs_err": int((m.long() - m_ref.long()).abs().max()),
        "ms": time_ms(lambda: label_prop_rect(big_rows, init, slab)),
        "plain_ms": time_ms(lambda: label_prop_rect_ref(big_rows, init, slab), reps=2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
    })

    flags = torch.tensor([1, 0], dtype=torch.int32, device=slab.device)
    u = torch.empty_like(init)

    def update():  # round 0 reads flags[0] == 1 and only ever sets flags[1]
        label_prop_update(init, m, pos, u, flags, 0)

    update()
    u_ref = label_prop_update_ref(init, m, pos)
    b_ms, b_by = bound_ms(4 * (3 * cap + r))
    out.append({
        "name": "label_prop_update", "shape": [cap], "max_abs_err": int((u.long() - u_ref.long()).abs().max()),
        "ms": time_ms(update), "plain_ms": time_ms(lambda: label_prop_update_ref(init, m, pos)),
        "bound_ms": b_ms, "bound_by": b_by,
    })

    cmin, csum = col_reduce(slab, vals, weights)
    rmin, rsum = col_reduce_ref(slab, vals, weights)
    err = max(int((cmin.long() - rmin.long()).abs().max()), int((csum - rsum).abs().max()))
    b_ms, b_by = bound_ms(4 * (r * w + 2 * r + 64 * w))
    out.append({
        "name": "col_reduce", "shape": [r, w], "max_abs_err": err,
        "ms": time_ms(lambda: col_reduce(slab, vals, weights)),
        "plain_ms": time_ms(lambda: col_reduce_ref(slab, vals, weights), reps=2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
    })
    return all(k["max_abs_err"] == 0 for k in out), out


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the port's kernels run only on the card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        return fail(f"the port's sources are not beside this script ({ROOT / 'src' / 'repro_torch'})")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.laf_dbscan import laf_dbscan
    from repro_torch.core.pipeline import LAFPipeline
    from repro_torch.data.synthetic import make_angular_clusters
    from repro_torch.index.random_projection import RandomProjectionBackend
    from repro_torch.kernels import _build
    from repro_torch.obs import metrics

    dev = torch.device("cuda")
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build (one nvcc per source, all at once)
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.load(name)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}", file=sys.stderr)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [str(p.relative_to(ROOT)) for p in libs.values()]})

    # 3. main path at the MS-150k operating point
    eps, tau, alpha = 0.55, 5, 1.5
    t0 = time.perf_counter()
    data, _ = make_angular_clusters(args.n, 768, 80, kappa=2560.0, noise_frac=0.40, seed=13)
    gen_s = time.perf_counter() - t0
    pipe = LAFPipeline(backend="random_projection", eps_grid=(0.3, 0.4, 0.5, 0.6),
                       epochs=args.epochs, seed=0, device=dev)
    t0 = time.perf_counter()
    test = pipe.fit_split(data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    emit({"phase": "fit", "n": args.n, "n_test": len(test), "epochs": args.epochs,
          "data_s": gen_s, "fit_s": fit_s, "training_set_s": pipe.estimator.set_seconds,
          "final_loss_stage0": pipe.estimator.history["stage0"][-1]})

    warm = pipe.cluster_laf_dbscan(test, eps, tau, alpha)  # first use: lazy loads, allocator
    metrics.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = pipe.cluster_laf_dbscan(test, eps, tau, alpha)
    counts = metrics.snapshot()
    launches = {k: counts["counters"].get(f"kernel.{k}.launches", 0) for k in KERNELS}
    host_syncs = counts["counters"].get("laf.cluster.host_syncs", 0)
    res = out.result
    g = counts["gauges"]
    emit({"phase": "main_path", "warmup_elapsed_s": warm.elapsed_s, "elapsed_s": out.elapsed_s, "predict_s": out.predict_s,
          "fit_index_s": g.get("laf.phase.fit_index_s"), "sweep_s": g.get("laf.phase.sweep_s"), "label_prop_s": g.get("laf.phase.label_prop_s"),
          "rescue_s": g.get("laf.phase.rescue_s"),
          "n_predicted_core": res.extras["n_predicted_core"], "n_rescued": res.extras["n_rescued"],
          "n_clusters": res.n_clusters, "noise_ratio": res.noise_ratio,
          "rounds": g.get("laf.cluster.last_rounds"), "launches": launches,
          "host_syncs": host_syncs, "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    ok = all(v > 0 for v in launches.values()) and host_syncs == 1
    ok &= res.labels.shape == (len(test),) and int(res.labels.min()) >= -1
    ok &= bool(np.array_equal(warm.result.labels, res.labels))

    # 4. cluster-pass parity (same sweep, host union-find) + quality
    pred = pipe.predict_counts(test, eps)
    bk = RandomProjectionBackend(device=dev).fit(test)
    host = laf_dbscan(test, eps, tau, alpha, pred, backend=bk, cluster_device=False)
    same = bool(np.array_equal(host.labels, res.labels) and np.array_equal(host.core, res.core)
                and host.extras == res.extras)
    x = torch.from_numpy(np.ascontiguousarray(test)).to(dev)
    quality = ari(res.labels, exact_dbscan_labels(x, eps, tau))
    emit({"phase": "parity", "host_union_find_identical": same, "ari_vs_exact_dbscan": quality})
    wall, busy = device_busy(lambda: pipe.cluster_laf_dbscan(test, eps, tau, alpha))
    emit({"phase": "trace", "wall_s": wall, "device_busy_s": busy,
          "idle_share": None if busy is None else 1.0 - busy / wall})
    ok &= same

    # 5. kernels vs plain versions at main-path shapes
    exec_idx = np.nonzero(pred >= alpha * tau)[0]
    k1_ok, k1 = check_hamming(bk, exec_idx, eps, args.k1_rows)
    lp_ok, lp = check_label_prop(bk, exec_idx, eps, tau)
    rows = []
    for k in [k1, *lp]:
        source, replaces = KERNELS[k["name"]]
        rows.append({"name": k["name"], "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[k["name"]], **{a: b for a, b in k.items() if a != "name"},
                     "library_ms": None})
    emit({"phase": "kernels", "hamming_filter_ok": k1_ok, "label_prop_ok": lp_ok})
    ok &= k1_ok and lp_ok
    if not ok:
        emit({"kernels": rows})
        return fail("a check failed (see the phase lines above)")
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=152185, help="dataset rows (MS-150k: 152185)")
    ap.add_argument("--epochs", type=int, default=10, help="estimator epochs (paper: 200)")
    ap.add_argument("--k1-rows", type=int, default=4096, help="queries in the K1 comparison")
    args = ap.parse_args()
    try:
        import torch  # noqa: F401
    except ImportError:
        return fail("PyTorch is not installed")
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
