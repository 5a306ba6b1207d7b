"""laf_dbscan: the paper's own workload as a config (port of
``repro.configs.laf_dbscan``): the clustering knobs of
``LAFClusterConfig`` (backend, signature, mesh and device-pass options),
the streaming knobs of ``StreamConfig`` and the dataset operating points
of the paper's Table 1 (n, d) as ``LAF_SHAPES``.

``index_axes`` and ``index_pipeline`` are the sharded index plane's
(``repro_torch.distributed.index_plane``): the mesh axes the database
rows and signature table are co-sharded over, and the sweep's pipeline
depth (2: a launch's count all-reduce overlaps the next launch; 1
serializes them).
"""

from dataclasses import dataclass, field
from typing import Mapping

import torch

from .registry import ArchSpec, ShapeSpec, register

__all__ = ["StreamConfig", "LAFClusterConfig", "make_config", "make_reduced_config", "LAF_SHAPES", "SPEC"]


@dataclass(frozen=True)
class StreamConfig:
    """Knobs for the streaming subsystem (``repro_torch.stream``).

    ``alpha`` is the online analog of the paper's skip factor: a new
    point whose predicted cardinality is below ``alpha * tau`` skips its
    full range query at ingest (it is verified against the core set
    only, and promoted later if its partial count crosses tau).
    ``use_estimator=False`` disables the skip entirely — every ingested
    row pays one range query, which is the exact (parity) mode.
    """

    batch_rows: int = 4096      # driver-side ingest chunking
    use_estimator: bool = False  # RMI predict-core fast path at ingest
    alpha: float = 1.0           # online skip factor (pred < alpha*tau skips)
    shortlist: int = 8           # serve: centroid clusters expanded per query
    min_hits: int = 1            # serve: eps-neighbors required to assign
    max_dead_frac: float = 0.25  # eviction: tombstone fraction forcing rebuild
    snapshot_every: int = 8      # durability: WAL batches between snapshots


@dataclass(frozen=True)
class LAFClusterConfig:
    n_points: int
    dim: int
    eps: float = 0.55
    tau: int = 5
    alpha: float = 1.5
    frontier: int = 4096      # queries per frontier round
    dtype: object = torch.float32
    # range-query backend (repro_torch.index): "exact" or
    # "random_projection" (sign signatures of index_bits bits drawn from
    # index_seed, a Hamming band of index_margin sigmas, "band" or "full"
    # verify); index_device, index_axes ("auto" = the mesh's data axes)
    # and index_pipeline route and pipeline the sharded plane
    backend: str = "exact"
    index_bits: int = 512
    index_seed: int = 0
    index_margin: float = 3.0
    index_verify: str = "band"
    index_device: object = "auto"
    index_axes: object = "auto"
    index_pipeline: int = 2
    # "auto": the packed device pass when the backend packs natively,
    # True forces it, False runs the host union-find pass
    cluster_device: object = "auto"
    # "auto": the obs device switch; True / False pin it
    telemetry: object = "auto"
    stream: StreamConfig = field(default_factory=StreamConfig)


def make_config():
    # MS-150k operating point (paper Table 1: 152,185 x 768)
    return LAFClusterConfig(n_points=152185, dim=768)


def make_reduced_config():
    return LAFClusterConfig(n_points=2048, dim=64, frontier=256, index_bits=128)


LAF_SHAPES: Mapping[str, ShapeSpec] = {
    "nyt_150k": ShapeSpec("nyt_150k", "cluster", {"n_points": 150000, "dim": 256}),
    "glove_150k": ShapeSpec("glove_150k", "cluster", {"n_points": 150000, "dim": 200}),
    "ms_150k": ShapeSpec("ms_150k", "cluster", {"n_points": 152185, "dim": 768}),
    "web_1b": ShapeSpec("web_1b", "cluster", {"n_points": 1_073_741_824, "dim": 768}),
}

SPEC = register(
    ArchSpec(
        name="laf_dbscan",
        family="cluster",
        make_config=make_config,
        make_reduced_config=make_reduced_config,
        shapes=LAF_SHAPES,
        notes="the paper's technique itself; web_1b is the 1000+-node scale target",
    )
)
