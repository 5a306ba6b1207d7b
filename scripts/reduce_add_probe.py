#!/usr/bin/env python3
"""How fast the L2 takes fp32 adds from the SMs: builds
``scripts/reduce_add_probe.cu`` with nvcc (a standalone program, no
PyTorch) and runs it at 1, 2, 4 and 16 tiles a block (footprints of
6.3, 12.7, 25.3 and 101 MB), printing the card's name and power limit and
one JSON line a mode: bulk reduce-adds of rows, REDs from registers,
stores from registers, bulk stores, bulk tensor reduce-adds of boxes.

    python3 scripts/reduce_add_probe.py     # one CUDA card, ~10 s with the build

The build goes to ``build/probe/``.  Exits nonzero if nvcc or a run
fails.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        print("reduce_add_probe: nvcc not found", file=sys.stderr)
        return 1
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    exe = out / "reduce_add_probe"
    build = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-o", str(exe),
                            str(ROOT / "scripts" / "reduce_add_probe.cu")], capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for tiles in (1, 2, 4, 16):
        run = subprocess.run([str(exe), str(tiles)], capture_output=True, text=True)
        for line in run.stdout.splitlines():
            if line.startswith('{"mode"'):
                print(line.replace('{"mode"', f'{{"tiles": {tiles}, "mode"', 1), flush=True)
        if run.returncode != 0:
            print(run.stderr, file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
