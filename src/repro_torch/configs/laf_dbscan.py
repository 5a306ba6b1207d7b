"""Streaming knobs of the paper's own workload (port of
``repro.configs.laf_dbscan``).  Only ``StreamConfig`` is ported; the
launch config ``LAFClusterConfig`` and its registry entry belong to the
multi-GPU slice (ROADMAP A10)."""

from dataclasses import dataclass

__all__ = ["StreamConfig"]


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
