#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` alone: the sharded index plane on the card.

    python3 scripts/plane_check.py            # one CUDA card, ~4 min with the estimator
    python3 scripts/plane_check.py --epochs 2 # a shorter estimator (other predictions)

Builds the port's kernels, makes the ms-150k dataset of the smoke's
phase 3 (152,185 x 768, seed 13), fits its ``LAFPipeline`` (estimator
epochs as ``--epochs``), predicts the whole set at eps 0.55 and runs
``chip_smoke.plane_phase``: the single-device run, world 1 over NCCL
and world 2 over gloo (two ranks on the one card), and min(cards, 4)
over NCCL on a machine with more cards, each held to the single-device
run; it prints the phase's lines, then the three plane kernel rows.
Exits nonzero if any check fails.  The first call after a change to
the plane's code.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=10, help="estimator epochs (the smoke's default)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("plane_check: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch import obs
    from repro_torch.core.pipeline import LAFPipeline
    from repro_torch.data.synthetic import make_angular_clusters
    from repro_torch.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    _build.build_all()  # once, before any rank is spawned
    obs.enable(trace=False, metrics_on=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    data, _ = make_angular_clusters(152185, 768, 80, kappa=2560.0, noise_frac=0.40, seed=13)
    pipe = LAFPipeline(backend="random_projection", eps_grid=(0.3, 0.4, 0.5, 0.6), epochs=args.epochs, seed=0,
                       device=dev)
    pipe.fit_split(data)
    pred = pipe.estimator.predict_counts(data, 0.55, reference_n=len(data))
    chip_smoke.emit({"phase": "fit", "seconds": time.perf_counter() - t0, "epochs": args.epochs})
    ok, rows, launches = chip_smoke.plane_phase(data, pred, 0.55, 5, 1.5, dev, clock_hz)
    for row in rows:
        print(json.dumps({"launches": launches[row["name"]], **row}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":  # the gloo ranks are spawned and import this module again
    sys.exit(main())
