#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` alone: the LM steps sharded over a
mesh's ranks on the card.

    python3 scripts/sharded_lm_check.py      # one CUDA card, ~3-5 min with the build

Builds the port's kernels, then runs ``chip_smoke.sharded_lm_phase``:
the single-device oracles (llama3-8b 2 of 32 layers, B 2 x 2,048;
deepseek-v2 2 of 60 layers, B 1 x 2,048; bf16), then llama3-8b at mesh
(1, 2) (train, prefill, decode) and deepseek-v2 at (1, 2) (train) over
two gloo ranks sharing the card, llama3-8b at (2, 1) (train) the same
way, and a llama3-8b train step at world 1 over NCCL, each held to the
single-device run.  Prints the phase's lines; exits nonzero if any
check fails.  The first call after a change to the sharded steps.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sharded_lm_check: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch import obs
    from repro_torch.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()  # once, before any rank is spawned
    obs.enable(trace=False, metrics_on=True)
    ok, _ = chip_smoke.sharded_lm_phase(torch.device("cuda"))
    return 0 if ok else 1


if __name__ == "__main__":  # the gloo ranks are spawned and import this module again
    sys.exit(main())
