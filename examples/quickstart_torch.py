"""Quickstart on the PyTorch/CUDA port: LAF-DBSCAN end to end on
synthetic angular data.

    PYTHONPATH=src python examples/quickstart_torch.py              # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --n 2000

The twin of ``examples/quickstart.py`` on ``repro_torch`` alone, with
the paper's protocol (§3.1): generate normalized high-dim vectors, 8:2
split, train the RMI cardinality estimator on the train split, cluster
the test split with LAF-DBSCAN, compare against exact DBSCAN (ground
truth) on quality AND speed.  ``--device cpu`` runs every kernel's plain
PyTorch version.
"""

import argparse

from repro_torch.core.metrics import adjusted_mutual_info, adjusted_rand_index
from repro_torch.core.pipeline import LAFPipeline
from repro_torch.data.synthetic import make_angular_clusters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=8000, help="vectors generated (the test split is a fifth)")
    args = ap.parse_args()

    print(f"generating {args.n} x 128-d vMF mixture (40 clusters + 30% noise)...")
    data, _ = make_angular_clusters(args.n, 128, 40, kappa=128 / 0.3, noise_frac=0.30, seed=0)
    eps, tau, alpha = 0.5, 5, 1.5

    pipe = LAFPipeline(eps_grid=(0.3, 0.4, 0.5, 0.6), epochs=5, seed=0, device=args.device)
    print(f"training the RMI cardinality estimator on the 80% split ({args.device})...")
    test = pipe.fit_split(data)
    print(f"  trained in {pipe.estimator.train_seconds:.1f}s "
          f"(excluded from clustering time, per the paper)")

    print(f"clustering the {len(test)}-point test split...")
    gt_out = pipe.cluster_dbscan(test, eps, tau)
    gt = gt_out.result
    out = pipe.cluster_laf_dbscan(test, eps, tau, alpha)
    res = out.result

    ari = adjusted_rand_index(res.labels, gt.labels)
    ami = adjusted_mutual_info(res.labels, gt.labels)
    print(f"\nDBSCAN (ground truth): {gt.n_clusters} clusters, "
          f"noise {gt.noise_ratio:.2f}, {gt_out.elapsed_s:.2f}s, {gt.n_range_queries} range queries")
    print(f"LAF-DBSCAN:            {res.n_clusters} clusters, "
          f"noise {res.noise_ratio:.2f}, {out.elapsed_s:.2f}s, {res.n_range_queries} range queries")
    print(f"  quality vs DBSCAN:   ARI={ari:.4f}  AMI={ami:.4f}")
    print(f"  speedup:             x{gt_out.elapsed_s / out.elapsed_s:.2f} "
          f"({res.extras['n_skipped']} queries skipped, "
          f"{res.extras['n_rescued']} false negatives rescued by post-processing)")


if __name__ == "__main__":
    main()
