#!/usr/bin/env python3
"""One registry cell's dry run on a small ``("data", "model")`` mesh of
fake ranks: what a rank would hold if the cell ran on a card or two.

    PYTHONPATH=src python3 scripts/dryrun_small_mesh.py gat-cora:ogb_products --mesh 1x2 --mesh 1x1

The production meshes of ``python -m repro_torch.launch.dryrun`` have 256
and 512 ranks; this runs the same ``launch.dryrun.run_cell`` (the cell
built by ``launch.steps.build_cell``, traced on ``meta`` shards under the
fake process group) on each ``--mesh`` given, records under ``--out``,
and prints one JSON line a mesh: the rank's argument, output, peak and
temporary bytes, the trace's seconds and the collectives' total.  CPU
only, no card.  Exits nonzero if a trace fails.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cell", help="ARCH:SHAPE[:VARIANT]")
    ap.add_argument("--mesh", action="append", default=None, help="DATAxMODEL, repeatable (default 1x2)")
    ap.add_argument("--out", default="artifacts/dryrun_small_mesh")
    args = ap.parse_args(argv)

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun

    name, shape, *variant = args.cell.split(":")
    arch = get_arch(name)
    rc = 0
    for spec in args.mesh or ["1x2"]:
        dims = tuple(int(x) for x in spec.split("x"))
        with dryrun.fake_group(dims[0] * dims[1]):
            mesh = init_device_mesh("cuda", dims, mesh_dim_names=("data", "model"))
            rec = dryrun.run_cell(arch, arch.shapes[shape], mesh, f"mesh{spec}", Path(args.out),
                                  variant=variant[0] if variant else "baseline", verbose=False)
        rc |= rec["status"] != "ok"
        print(json.dumps({"cell": args.cell, "mesh": spec, "status": rec["status"], "error": rec.get("error"),
                          "gib_per_rank": {k: v / 2**30 for k, v in rec.get("memory", {}).get("bytes_per_rank",
                                                                                             {}).items()},
                          "trace_s": rec.get("trace_s"), "collectives": rec.get("collectives", {}).get("total")}),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
