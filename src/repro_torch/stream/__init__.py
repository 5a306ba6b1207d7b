"""``repro_torch.stream`` — incremental LAF-DBSCAN (port of
``repro.stream``): online ingest, cluster maintenance, a serving-grade
assignment API and the durable plane.

* :class:`~repro_torch.stream.ingest.StreamingLAF` — the batch driver:
  ``partial_fit(rows)`` appends to the index and maintains the clusters
  (new-vs-all range queries only; old points promote to core off the
  transposed hits), ``assign(queries)`` serves unseen vectors.
* :class:`~repro_torch.stream.state.StreamingClusterState` — counts,
  core mask, growable union-find, and the min-core-neighbor border rule.
* :class:`~repro_torch.stream.serve.ClusterIndex` — the immutable
  serving snapshot (centroid shortlist + band-verified assignment).
* :class:`~repro_torch.stream.durability.DurableStream` — snapshot/WAL
  crash recovery and replica failover around a ``StreamingLAF``.
"""

from .durability import DurableStream, clone_replica, export_replica, import_replica  # noqa: F401
from .ingest import IngestReport, StreamingLAF  # noqa: F401
from .serve import AssignResult, ClusterIndex, bucket_shape  # noqa: F401
from .state import StreamingClusterState  # noqa: F401
