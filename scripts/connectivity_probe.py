#!/usr/bin/env python3
"""Where ``packed_connectivity``'s time goes on the ms-150k RP stream.

    python3 scripts/connectivity_probe.py     # one CUDA card, ~1-2 min with the data

Builds the RP stream of ``chip_smoke.py``'s phase 12 (the ms-150k
dataset, seed 13; 512 bits, margin 3, warm-started from the 121,748
train rows, then the test split in 4,096-row batches), takes the same
block as its ``packed_connectivity`` row (the 7th batch's 4,096 rows
against all 152,185 columns), and prints one JSON line: the block's
shape and set bits, the kernel against ``packed_connectivity_ref``
(exact: comp, owner, row_first, rounds), the kernel's time back to back
and queued behind a sleep, its ptxas registers and spills, and the
phase split of its probe build (``chip_smoke.connectivity_split``: each
round's K2 walk, K3 walk and update, and how long blocks wait at each
grid barrier).  Exits nonzero if the kernel disagrees.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()

    if not torch.cuda.is_available():
        print("connectivity_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.data.synthetic import make_angular_clusters, train_test_split
    from repro_torch.index.random_projection import RandomProjectionBackend
    from repro_torch.kernels import _build
    from repro_torch.kernels.label_prop import packed_connectivity
    from repro_torch.kernels.label_prop.ref import packed_connectivity_ref
    from repro_torch.stream import StreamingLAF

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    eps, tau = 0.55, 5
    t0 = time.perf_counter()
    data, _ = make_angular_clusters(152185, 768, 80, kappa=2560.0, noise_frac=0.40, seed=13)
    train, test = train_test_split(data, 0.8, 0)
    batches = cs.stream_batches(test)
    rp = StreamingLAF(eps, tau, backend=RandomProjectionBackend(device=dev, n_bits=512, margin=3.0).fit(train))
    for b in batches:
        rp.partial_fit(b)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    end = rp.n_points - len(batches[-1])
    args = cs.connectivity_args(rp, np.arange(end - cs.STREAM_BATCH, end), eps)
    got = packed_connectivity(*args)
    want = packed_connectivity_ref(*args)
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    run = lambda: packed_connectivity(*args)  # noqa: E731
    row = {"probe": "packed_connectivity", "nvidia_smi": smi, "build_s": build_s, "stream_s": stream_s,
           "shape": list(args[0].shape), **cs.slab_stats(args[0]), "n_core_rows": int(args[2].sum()),
           "exact": exact, "rounds": int(got[3]),
           "ms_turns": [cs.time_ms(run), cs.time_ms(run)], "queued_ms_turns": [cs.queued_ms(run), cs.queued_ms(run)],
           "ptxas": cs.ptxas_entries("label_prop", "packed_connectivity_kernel"),
           **cs.connectivity_split(args)}
    print(json.dumps(row), flush=True)
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
