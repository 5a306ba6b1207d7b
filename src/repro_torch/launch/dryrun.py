"""Dry run at the production mesh sizes, shapes only, on fake ranks (port
of ``repro.launch.dryrun``, the ``cluster`` family).

    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
    python -m repro_torch.launch.dryrun --arch laf_dbscan --shape web_1b --mesh multi

The reference forces 512 host devices and compiles every cell.  Here the
fake process group (``torch.testing._internal.distributed.fake_pg``)
comes up at 256 (``pod16x16``) or 512 (``pod2x16x16``) ranks in this one
process, the production mesh is built on it, and each cluster cell
(``launch.laf_cluster``: the frontier round and the one-launch
formation, with the paper's random-projection index) runs once as rank
0 on fake CUDA tensors: no data, no card, every collective accepted by
the fake group.  Its dispatch trace (``launch.trace_analysis``) gives
each record:

* ``memory.bytes_per_rank``: argument, output and peak live bytes of
  rank 0 (``temp`` = peak - argument);
* ``trace_analysis``: FLOPs, the kernel operators' operations and
  launches, bytes accessed, the loop-aware collectives;
* ``analysis_findings``: laf-lint's trace checks over the trace
  (``repro_torch.analysis.trace_checks``), so the dry run doubles as a
  lint of every cell;
* ``status``, ``wall_s``, ``trace_s`` and, under ``--faults``, the
  fault plan (site ``dryrun.cell``, as the reference's ``run_cell``).

Records go to ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>
[__one_launch].json``.  The LM, recsys and GNN cells get a ``"skip"``
record: their builders are A12b's (the LM's sharding rules are in
``launch.steps``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import time
import traceback
from pathlib import Path

from ..obs import configure_logging, get_logger, log_event
from ..testing import faults as _faults

__all__ = ["fake_group", "run_cell", "cluster_arch", "iter_cells", "main", "MESHES", "FAMILY_SKIP"]

logger = get_logger("launch.dryrun")

MESHES = {False: ("pod16x16", 256), True: ("pod2x16x16", 512)}
VARIANTS = ("baseline", "one_launch")
FAMILY_SKIP = ("its cell builder (build_lm_train, build_lm_prefill, build_lm_decode, build_gnn_train, "
               "build_recsys_*) is not ported yet: A12b")
DRYRUN_BACKEND = "random_projection"


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A fake process group of ``world`` ranks, this process as ``rank``,
    torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def cluster_arch(arch, *, reduced: bool = False, **overrides):
    """``arch`` with its config (or reduced config) on the dry run's
    backend, telemetry off (as a fresh process builds it, whatever this
    process's device switch says), ``overrides`` applied."""
    base = arch.make_reduced_config() if reduced else arch.make_config()
    base = dataclasses.replace(base, **{"backend": DRYRUN_BACKEND, "telemetry": False, **overrides})
    return dataclasses.replace(arch, make_config=lambda: base)


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    return str(x)


def run_cell(arch, shape, mesh, mesh_name: str, out_dir: Path, *, variant: str = "baseline",
             device: str = "cuda", verbose: bool = True) -> dict:
    """Trace one cell (``variant``: the frontier round or ``one_launch``)
    on ``mesh`` and write its record."""
    from ..analysis.trace_checks import check_trace
    from .laf_cluster import build_laf_cluster, build_one_launch_cluster
    from .trace_analysis import analyze_trace

    suffix = "" if variant == "baseline" else f"__{variant}"
    out_path = Path(out_dir) / mesh_name / f"{arch.name}__{shape.name}{suffix}.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    record = {"arch": arch.name, "shape": shape.name, "mesh": mesh_name, "n_devices": mesh.size(),
              "variant": variant, "rank": 0}
    plan = _faults.active()
    if plan is not None:
        record["fault_plan"] = plan.summary()
    try:
        _faults.maybe_fail("dryrun.cell", arch=arch.name, shape=shape.name)
        build = build_laf_cluster if variant == "baseline" else build_one_launch_cluster
        cell = build(arch, shape, mesh, device=device)
        t1 = time.time()
        tr = analyze_trace(cell.step_fn, *cell.args)
        if tr.error:
            raise RuntimeError(f"the trace stopped: {tr.error}")
        findings = check_trace(tr, f"{arch.name}__{shape.name}{suffix}", meta=cell.meta)
        record.update(
            status="ok",
            cell=cell.name,
            meta=_jsonable(cell.meta),
            placements=[_jsonable(p) for p in cell.placements],
            trace_s=time.time() - t1,
            memory={"bytes_per_rank": {
                "argument": tr.argument_bytes, "output": tr.output_bytes, "peak": tr.peak_live_bytes,
                "temp": tr.peak_live_bytes - tr.argument_bytes,
            }},
            trace_analysis=tr.to_dict(),
            collectives=tr.collective_summary(),
            analysis_findings=[f.to_dict() for f in findings],
        )
        if verbose:
            log_event(logger, "cell_ok", arch=arch.name, shape=shape.name, mesh=mesh_name, variant=variant,
                      peak_gib=round(tr.peak_live_bytes / 2**30, 3), launches=tr.launches,
                      findings=len(findings))
    except Exception as exc:  # noqa: BLE001 - a failure is recorded: the table must be complete
        record.update(status="error", error=f"{type(exc).__name__}: {exc}",
                      traceback=traceback.format_exc()[-4000:])
        if verbose:
            log_event(logger, "cell_fail", logging.WARNING, arch=arch.name, shape=shape.name, mesh=mesh_name,
                      variant=variant, error=record["error"])
    record["wall_s"] = time.time() - t0
    out_path.write_text(json.dumps(record, indent=2))
    return record


def _skip_record(out_dir: Path, arch_name: str, shape_name: str, mesh_name: str, reason: str) -> dict:
    p = Path(out_dir) / mesh_name / f"{arch_name}__{shape_name}.json"
    p.parent.mkdir(parents=True, exist_ok=True)
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name, "status": "skip", "reason": reason}
    p.write_text(json.dumps(rec, indent=2))
    return rec


def iter_cells():
    """(arch, shape name, skip reason or None) over the registry."""
    from ..configs.registry import get_arch, list_archs

    for arch_name in list_archs():
        arch = get_arch(arch_name)
        for shape_name in arch.shapes:
            if shape_name in arch.skips:
                yield arch, shape_name, arch.skips[shape_name]
            elif arch.family != "cluster":
                yield arch, shape_name, FAMILY_SKIP
            else:
                yield arch, shape_name, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="install a seeded fault plan for this run, e.g. 'seed=7,dryrun.cell=0.5'; injected "
                    "cells are recorded as status=error with the plan summary")
    ap.add_argument("--quiet", action="store_true", help="no per-cell progress lines")
    args = ap.parse_args(argv)
    configure_logging(quiet=args.quiet)
    if args.faults:
        _faults.install(_faults.FaultPlan.parse(args.faults))
    from ..configs.registry import get_arch
    from .mesh import make_production_mesh

    out_dir = Path(args.out)
    if args.all:
        cells = list(iter_cells())
    else:
        arch = get_arch(args.arch)
        cells = [(arch, args.shape, None if arch.family == "cluster" else FAMILY_SKIP)]
    n_fail = n_ok = 0
    for multi in {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]:
        mesh_name, world = MESHES[multi]
        with fake_group(world):
            mesh = make_production_mesh(multi_pod=multi)
            for arch, shape_name, skip in cells:
                if skip is not None:
                    _skip_record(out_dir, arch.name, shape_name, mesh_name, skip)
                    continue
                for variant in VARIANTS:
                    rec = run_cell(cluster_arch(arch), arch.shapes[shape_name], mesh, mesh_name, out_dir,
                                   variant=variant, verbose=not args.quiet)
                    n_fail += rec["status"] == "error"
                    n_ok += rec["status"] == "ok"
    log_event(logger, "dryrun_done", logging.WARNING if n_fail else logging.INFO, ok=n_ok, failures=n_fail)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
