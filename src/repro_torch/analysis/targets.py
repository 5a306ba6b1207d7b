"""The standard launch surface the trace checks run over (port of
``repro.analysis.targets``).

A :class:`Target` is one real entry point of the port run once on fake
CUDA tensors under ``launch.trace_analysis`` at a pinned standard
config, the reference's, so the CUDA branch of every kernel wrapper is
what gets traced (no card needed):

* ``sweep_engine_counts`` / ``sweep_engine_bitmap``: the sweep engine's
  enqueue (``index.sweep._run``) with the per-chunk telemetry slab on,
  nq = 1024, d = 64, chunk = 256, two chunks a launch: two launches in
  the ``sweep.launches`` loop;
* ``sharded_plane``: the pipelined bitmap sweep on the plane, each
  launch's count all-reduce submitted to a depth-2 ``PlanePipeline``, on
  a fake 4-rank ``("data",)`` mesh: 1024 queries in 8 chunks of 128
  against 1024 database rows (256 a rank), telemetry on;
* ``laf_cluster``: ``build_laf_cluster`` at the reduced config with the
  random-projection index and ``index_device=True``, on the 4-rank mesh;
* ``one_launch_cluster``: ``build_one_launch_cluster`` at the same
  config with telemetry on, on the 4-rank mesh: 64 rounds of
  ``label_prop_rect``, a MIN all-reduce and ``label_prop_update``;
* ``serve_assign``: the serving verify sweep at the smallest
  ``bucket_shape`` bucket (200 candidates, a 100-query block: 256
  database rows, a 128-row chunk).

``BYTE_BUDGETS`` pins each target's traced bytes (``bytes_accessed``)
at about 6x the value measured on the standard config, as the reference
pins its own: a gate against an accidental fp32 bitmap or a broadcast
(nq, n) intermediate, not a performance target.

Everything here imports torch, so the CLI and the registry import this
module lazily (``--list-checks`` stays torch-free).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["Target", "Targets", "Context", "BYTE_BUDGETS", "STANDARD_WORLD", "STANDARD_MESH_AXES"]

STANDARD_WORLD = 4
STANDARD_MESH_AXES = ("data",)

# traced bytes_accessed ceilings, ~6x the value measured on the standard
# config (fake CUDA tensors, rank 0 of the fake 4-rank mesh); retune with
#   python -m repro_torch.analysis --only=trace-bytes-budget  (prints on fail)
BYTE_BUDGETS: Dict[str, int] = {
    "sweep_engine_counts": 6_600_000,      # measured 1.10 MB
    "sweep_engine_bitmap": 8_200_000,      # measured 1.36 MB
    "sharded_plane": 31_000_000,           # measured 5.18 MB (4-rank mesh)
    "laf_cluster": 2_010_000_000,          # measured 335.4 MB (4-rank mesh; the RMI's weights packed a stage)
    "one_launch_cluster": 25_000_000,      # measured 4.18 MB (4-rank mesh, 64 rounds)
    "serve_assign": 900_000,               # measured 0.15 MB
}


@dataclass
class Target:
    """One traced entry point: its trace analysis, the meta of its cell
    (``frontier``, ``cap``, ``w_local``, ``max_iters`` where it has them)
    and whether it ran on several ranks."""

    name: str
    analysis: object
    meta: dict = field(default_factory=dict)
    sharded: bool = False
    byte_budget: Optional[int] = None

    @property
    def label(self) -> str:
        return f"<target:{self.name}>"


def _band(eps: float, n_bits: int):
    from ..index.signatures import hamming_band

    return hamming_band(eps, n_bits, 3.0)


class Targets:
    """Build-once cache of the standard targets; the sharded ones are
    built on a fake process group of ``STANDARD_WORLD`` ranks brought up
    for the purpose (none may be up already)."""

    NAMES = ("sweep_engine_counts", "sweep_engine_bitmap", "sharded_plane", "laf_cluster", "one_launch_cluster",
             "serve_assign")

    def __init__(self):
        self._cache: Dict[str, Target] = {}

    def get(self, name: str) -> Target:
        if name not in self._cache:
            self._build_all()
        return self._cache[name]

    def all(self) -> List[Target]:
        return [self.get(n) for n in self.NAMES]

    def _build_all(self) -> None:
        from torch.distributed.device_mesh import init_device_mesh

        from ..launch.dryrun import fake_group

        with fake_group(STANDARD_WORLD):
            mesh = init_device_mesh("cpu", (STANDARD_WORLD,), mesh_dim_names=STANDARD_MESH_AXES)
            for name in self.NAMES:
                self._cache[name] = getattr(self, f"_build_{name}")(mesh)

    # -- the sweep engine ----------------------------------------------

    @staticmethod
    def _fake(mode, shapes):
        import torch

        with mode:
            return [torch.empty(s, dtype=dt, device="cuda") for s, dt in shapes]

    def _sweep(self, name, *, nq, n_db, chunk, cpl, bitmap, tele, pipe=None, world=1):
        import torch

        from ..index.sweep import _run, plan_sweep
        from torch._subclasses.fake_tensor import FakeTensorMode

        from ..launch.trace_analysis import analyze_trace

        mode = FakeTensorMode(allow_non_fake_inputs=True)
        q, q_sig, db, db_sig = self._fake(mode, [((nq, 64), torch.float32), ((nq, 2), torch.int32),
                                                 ((n_db, 64), torch.float32), ((n_db, 2), torch.int32)])
        plan = plan_sweep(nq, chunk, 128, cpl)
        t_lo, t_hi = _band(0.55, 64)
        slab = self._fake(mode, [((plan.n_launches * plan.cpl, 3), torch.int32)])[0] if tele else None
        tr = analyze_trace(lambda *a: _run(*a, 0.55, t_lo, t_hi, plan, bitmap=bitmap, tele=slab, pipe=pipe),
                           q, q_sig, db, db_sig)
        return Target(name, tr, {"frontier": nq}, sharded=world > 1, byte_budget=BYTE_BUDGETS.get(name))

    def _build_sweep_engine_counts(self, mesh) -> Target:
        return self._sweep("sweep_engine_counts", nq=1024, n_db=512, chunk=256, cpl=2, bitmap=False, tele=True)

    def _build_sweep_engine_bitmap(self, mesh) -> Target:
        return self._sweep("sweep_engine_bitmap", nq=1024, n_db=512, chunk=256, cpl=2, bitmap=True, tele=True)

    def _build_sharded_plane(self, mesh) -> Target:
        from ..distributed.index_plane import PlanePipeline
        from ..distributed.sharding import plane_axes

        pipe = PlanePipeline(plane_axes(mesh, STANDARD_MESH_AXES), 2)
        return self._sweep("sharded_plane", nq=1024, n_db=1024 // STANDARD_WORLD, chunk=128, cpl=1, bitmap=True,
                           tele=True, pipe=pipe, world=STANDARD_WORLD)

    def _build_serve_assign(self, mesh) -> Target:
        from ..stream.serve import bucket_shape

        bucket, chunk = bucket_shape(200, 100, db_tile=256, chunk=256, q_tile=128)
        return self._sweep("serve_assign", nq=chunk, n_db=bucket, chunk=chunk, cpl=8, bitmap=True, tele=False)

    # -- the cluster lowerings -----------------------------------------

    def _cell(self, name, mesh, build, **overrides) -> Target:
        from ..configs.registry import ShapeSpec, get_arch
        from ..launch.dryrun import cluster_arch
        from ..launch.trace_analysis import analyze_trace

        arch = cluster_arch(get_arch("laf_dbscan"), reduced=True, index_device=True, **overrides)
        shape = ShapeSpec("analysis_reduced", "cluster", {"n_points": 2048, "dim": 64})
        cell = build(arch, shape, mesh)
        tr = analyze_trace(cell.step_fn, *cell.args)
        return Target(name, tr, dict(cell.meta), sharded=mesh.size() > 1, byte_budget=BYTE_BUDGETS.get(name))

    def _build_laf_cluster(self, mesh) -> Target:
        from ..launch.laf_cluster import build_laf_cluster

        return self._cell("laf_cluster", mesh, build_laf_cluster)

    def _build_one_launch_cluster(self, mesh) -> Target:
        from ..launch.laf_cluster import build_one_launch_cluster

        # telemetry on pins the enlarged loop state (the (4, 64) per-round
        # counts): LAF101, 106 and 107 hold on it, not just on the subset
        return self._cell("one_launch_cluster", mesh, build_one_launch_cluster, telemetry=True)


@dataclass
class Context:
    """What a check sees: the repo layout for the AST passes, the lazily
    built targets for the trace passes, and the probes' switch and
    device (``cuda`` when a card is present)."""

    repo_root: Path
    src_root: Path
    targets: Targets = field(default_factory=Targets)
    dynamic: bool = True
    device: str = "cpu"

    @classmethod
    def for_repo(cls, repo_root=None, *, dynamic: bool = True, device: Optional[str] = None) -> "Context":
        root = Path(repo_root) if repo_root else Path(__file__).resolve().parents[3]
        if device is None:
            import torch

            device = "cuda" if torch.cuda.is_available() else "cpu"
        return cls(repo_root=root, src_root=root / "src" / "repro_torch", dynamic=dynamic, device=device)
