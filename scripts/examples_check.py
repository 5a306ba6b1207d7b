#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py`` alone: the paths of the port's example
twins on the card.

    python3 scripts/examples_check.py     # one CUDA card, ~1.5 min with the build

Builds every kernel, starts the recsys example's CPU twin in a spawned
process (as the smoke does before its phase 14; here it runs beside the
card's work and the phase waits for it) and calls
``chip_smoke.examples_phase``: the D 64 attention rows (prefill with the
log-sum-exp, decode, backward; fp32 and bf16; against the plain version,
the same call padded to D 128 and SDPA, with ptxas's ``<64>`` entries),
``train_lm_64`` (``examples/train_lm_torch.py``'s ~100M model: a step
held to a CPU copy, ``train_loop`` with a checkpoint, a resume) and
``recsys_serving`` (``examples/recsys_serving_torch.py`` at bst's full
width on 150,000 items, then at the example's sizes against the CPU
twin).  Prints the card's name and power limit, the phase lines, the
kernels' entries and an ``ok`` line; exits nonzero if a check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("examples_check: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch import obs
    from repro_torch.kernels import _build

    obs.enable(trace=False, metrics_on=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    pool, twin = chip_smoke.start_recsys_twin()
    try:
        for name in _build.build_all():
            _build.load(name)
        print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
        ok, rows, launches = chip_smoke.examples_phase(torch.device("cuda"), twin)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    print(json.dumps({"kernels": rows, "launches": launches}), flush=True)
    print(json.dumps({"ok": ok, "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
