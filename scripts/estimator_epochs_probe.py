#!/usr/bin/env python3
"""The estimator's epochs against the quality gates of ``chip_smoke.py``'s
main path, on the card.

    python3 scripts/estimator_epochs_probe.py 4 6     # one CUDA card, ~3 min

Draws the smoke's MS-150k set (152,185 x 768, seed 13), runs exact
DBSCAN of its test split as the truth, and for each epoch count given
fits ``LAFPipeline(backend="random_projection")`` at it, then clusters
the test split with LAF-DBSCAN on the random-projection and the exact
backend and LAF-DBSCAN++ (alpha 1.0) at eps 0.55, tau 5, alpha 1.5.
Prints one JSON line an epoch count: the fit's seconds, the last stage-0
loss, the predicted cores, the rescued points and each ARI against the
truth (the smoke holds LAF-DBSCAN to >= 0.99).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("estimator_epochs_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.dbscan import dbscan_parallel
    from repro_torch.core.dbscan_pp import auto_sample_fraction
    from repro_torch.core.metrics import adjusted_rand_index
    from repro_torch.core.pipeline import LAFPipeline
    from repro_torch.data.synthetic import make_angular_clusters

    dev = torch.device("cuda")
    eps, tau, alpha = 0.55, 5, 1.5
    data, _ = make_angular_clusters(152185, 768, 80, kappa=2560.0, noise_frac=0.40, seed=13)
    truth = None
    for epochs in [int(a) for a in sys.argv[1:]] or [5]:
        pipe = LAFPipeline(backend="random_projection", eps_grid=(0.3, 0.4, 0.5, 0.6), epochs=epochs, seed=0,
                           device=dev)
        t0 = time.perf_counter()
        test = pipe.fit_split(data)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        if truth is None:
            truth = dbscan_parallel(test, eps, tau, backend="exact", device=dev)
        rp = pipe.cluster_laf_dbscan(test, eps, tau, alpha).result
        exact = pipe.cluster_laf_dbscan(test, eps, tau, alpha, backend="exact").result
        p = auto_sample_fraction(pipe.predict_counts(test, eps), tau, alpha, 0.2)
        pp = pipe.cluster_laf_dbscan_pp(test, eps, tau, p=p, alpha=1.0, backend="exact").result
        print(json.dumps({"epochs": epochs, "fit_s": fit_s, "final_loss_stage0": pipe.estimator.history["stage0"][-1],
                          "n_predicted_core": rp.extras["n_predicted_core"], "n_rescued": rp.extras["n_rescued"],
                          "ari_rp": adjusted_rand_index(rp.labels, truth.labels),
                          "ari_exact": adjusted_rand_index(exact.labels, truth.labels),
                          "ari_laf_dbscan_pp": adjusted_rand_index(pp.labels, truth.labels)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
