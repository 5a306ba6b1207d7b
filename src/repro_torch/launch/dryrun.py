"""Dry run at the production mesh sizes, shapes only, on fake ranks (port
of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--variant V] [--skip-existing]
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --cells llama3-8b:train_4k,gemma3-27b:long_500k:windowed --mesh single
    python -m repro_torch.launch.dryrun --cells laf_dbscan:nyt_150k,laf_dbscan:web_1b:one_launch

The reference forces 512 host devices and compiles every cell.  Here the
fake process group (``torch.testing._internal.distributed.fake_pg``)
comes up at 256 (``pod16x16``) or 512 (``pod2x16x16``) ranks in this one
process, the production mesh is built on it, and each registry cell
(``launch.steps.build_cell``) runs once as rank 0: no data, no card,
every collective accepted by the fake group.  The cluster cells
(``launch.laf_cluster``: the frontier round and the one-launch
formation, with the paper's random-projection index) trace on fake CUDA
tensors; the LM, recsys and GNN cells on ``meta`` tensors of rank 0's
shards (DTensor parameters, optimizer state, batch and caches; the
kernels through their operators).  Its dispatch trace
(``launch.trace_analysis``) gives each record:

* ``memory.bytes_per_rank``: argument, output and peak live bytes of
  rank 0 (``temp`` = peak - argument);
* ``trace_analysis``: FLOPs, the kernel operators' operations and
  launches, bytes accessed, the loop-aware collectives (DTensor's
  redistributions among them);
* ``analysis_findings``: laf-lint's trace checks over the trace
  (``repro_torch.analysis.trace_checks``), so the dry run doubles as a
  lint of every cell;
* ``whole_weights`` (the model cells): the parameters the rule splits
  whose whole the trace holds, as a collective's result or another op's;
* ``status``, ``wall_s``, ``trace_s``, ``trace_device`` and, under
  ``--faults``, the fault plan (site ``dryrun.cell``, as the reference's
  ``run_cell``).

Variants: with no ``--variant`` a cluster cell runs its frontier round
and its ``one_launch`` formation, every other cell its baseline; with
``--variant V`` only the cells that take V run it (``windowed``: the
decode cells of a local:global config, gemma3-27b's; ``one_launch``:
the cluster cells; ``baseline``: every cell's baseline).  The registry's
skips get a ``"skip"`` record.  Records go to
``artifacts/dryrun_torch/<mesh>/<arch>__<shape>[__<variant>].json``;
``--skip-existing`` keeps a record whose status is ``ok``.  A cell whose
build or trace fails is an ``error`` record and the run exits 1.
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

__all__ = ["fake_group", "run_cell", "cluster_arch", "iter_cells", "cell_variants", "main", "MESHES", "VARIANTS"]

logger = get_logger("launch.dryrun")

MESHES = {False: ("pod16x16", 256), True: ("pod2x16x16", 512)}
VARIANTS = ("baseline", "windowed", "one_launch")
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


def cell_variants(arch, shape, requested=None) -> tuple:
    """The variants the dry run traces for a cell (module docstring)."""
    if arch.family == "cluster":
        own = ("baseline", "one_launch")
        return own if requested is None else tuple(v for v in own if v == requested)
    own = ("baseline",)
    if arch.family == "lm" and shape.kind == "decode":
        cfg = arch.make_config()
        if cfg.window is not None and cfg.global_every > 0 and cfg.attention == "gqa":
            own = ("baseline", "windowed")
    if requested is None:
        return ("baseline",)
    return (requested,) if requested in own else ()


def run_cell(arch, shape, mesh, mesh_name: str, out_dir: Path, *, variant: str = "baseline",
             device: str = "cuda", verbose: bool = True) -> dict:
    """Trace one cell (``variant``: the baseline, ``windowed`` or the
    cluster's ``one_launch``) on ``mesh`` and write its record."""
    from ..analysis.trace_checks import check_trace
    from .steps import build_cell
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
        cell = build_cell(arch, shape, mesh, variant, device=device)
        t1 = time.time()
        tr = analyze_trace(cell.step_fn, *cell.args)
        if tr.error:
            raise RuntimeError(f"the trace stopped: {tr.error}")
        findings = check_trace(tr, f"{arch.name}__{shape.name}{suffix}", meta=cell.meta)
        if arch.family != "cluster":
            record["whole_weights"] = whole_weights(cell, mesh, tr)
        record.update(
            status="ok",
            cell=cell.name,
            meta=_jsonable(cell.meta),
            placements=[_jsonable(p) for p in cell.placements],
            trace_s=time.time() - t1,
            trace_device=device if arch.family == "cluster" else "meta",
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


def whole_weights(cell, mesh, tr) -> dict:
    """The parameters the cell's rule splits whose whole (global shape
    and dtype) the trace holds: ``by_collective``, a collective's result
    (a gather the rule implies), and ``by_op``, {name: the ops} of any
    other op's result of that shape (a cast of a gathered weight, a
    weight-shaped gradient before its reduce-scatter, or a tensor that
    only shares the shape)."""
    from .cell import global_shape, map_args

    found = {"by_collective": [], "by_op": {}}
    params, pls = cell.args[0], cell.placements[0]
    leaves = {}
    map_args(lambda t, pl: leaves.setdefault(id(t), (t, pl)), params, pls)
    names = {id(t): n for n, t in _named(params)}
    for key, (t, pl) in leaves.items():
        if not any(p.is_shard() for p in pl):
            continue
        whole = (global_shape(t.shape, mesh, pl), str(t.dtype).split(".")[-1])
        if whole in tr.collective_shapes:
            found["by_collective"].append(names[key])
        if whole in tr.op_shapes:
            found["by_op"][names[key]] = sorted(tr.op_shapes[whole])
    return found


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


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
            yield arch, shape_name, arch.skips.get(shape_name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--multi-pod", action="store_true", help="alias for --mesh multi")
    ap.add_argument("--variant", choices=VARIANTS, default=None,
                    help="trace only this variant, on the cells that take it (default: each cell's own)")
    ap.add_argument("--skip-existing", action="store_true", help="keep the records whose status is ok")
    ap.add_argument("--cells", default=None, metavar="ARCH:SHAPE[:VARIANT],...",
                    help="only these cells (a variant given runs that variant alone)")
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
    only = {}
    if args.cells:
        for item in args.cells.split(","):
            name, shape_name, *variant = item.strip().split(":")
            only.setdefault((name, shape_name), []).append(variant[0] if variant else None)
        cells = [(get_arch(n), s, get_arch(n).skips.get(s)) for n, s in only]
    elif args.all:
        cells = list(iter_cells())
    else:
        arch = get_arch(args.arch)
        cells = [(arch, args.shape, arch.skips.get(args.shape))]
    n_fail = n_ok = 0
    for multi in {"single": [False], "multi": [True], "both": [False, True]}["multi" if args.multi_pod else args.mesh]:
        mesh_name, world = MESHES[multi]
        with fake_group(world):
            mesh = make_production_mesh(multi_pod=multi)
            for arch, shape_name, skip in cells:
                if skip is not None:
                    if args.variant in (None, "baseline"):
                        _skip_record(out_dir, arch.name, shape_name, mesh_name, skip)
                    continue
                shape = arch.shapes[shape_name]
                asked = only.get((arch.name, shape_name), [args.variant])
                variants = [v for a in asked for v in cell_variants(arch, shape, a if a else args.variant)]
                for variant in dict.fromkeys(variants):
                    suffix = "" if variant == "baseline" else f"__{variant}"
                    path = out_dir / mesh_name / f"{arch.name}__{shape_name}{suffix}.json"
                    if args.skip_existing and path.exists() and json.loads(path.read_text()).get("status") == "ok":
                        log_event(logger, "cell_cached", arch=arch.name, shape=shape_name, mesh=mesh_name,
                                  variant=variant)
                        continue
                    rec = run_cell(cluster_arch(arch) if arch.family == "cluster" else arch, shape, mesh, mesh_name,
                                   out_dir, variant=variant, verbose=not args.quiet)
                    n_fail += rec["status"] == "error"
                    n_ok += rec["status"] == "ok"
    log_event(logger, "dryrun_done", logging.WARNING if n_fail else logging.INFO, ok=n_ok, failures=n_fail)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
