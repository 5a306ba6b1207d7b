"""Serving-grade cluster assignment for unseen vectors (port of
``repro.stream.serve``).

``ClusterIndex`` is an immutable snapshot built from a
:class:`~repro_torch.stream.ingest.StreamingLAF` (or any labels + data
pair):

1. **centroid shortlist**: score the query against the per-cluster
   centroids (one small host matmul) and expand only the best
   ``shortlist`` clusters;
2. **band-verified range query** inside the shortlist: the engine runs
   every block of queries against the union of its shortlisted
   clusters' members in one sweep (``index.sweep.sweep_bitmap``: K1, the
   Hamming filter, on the snapshot's device) with the signed-RP band;
   an exact-backed snapshot (no signatures) runs the ``range_count``
   kernel's bitmap body instead.  The host loop over queries is the
   oracle, chosen explicitly (``oracle=True`` here or on the backing RP
   backend), never as a fallback;
3. **assignment**: the query joins the cluster holding the plurality of
   its eps-neighbors; confidence is that cluster's share of them.  No
   eps-neighbor in the shortlist is noise (-1), confidence 0.

Both paths take the same unit queries, shortlist and query signatures
(signed once, on the snapshot's device) and record through one
``_record``, so their labels, confidence and hit counts agree.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.range_query import range_bitmap, unpack_bitmap
from ..index.signatures import band_hits, hamming_numpy, sign_signatures
from ..index.sweep import sweep_bitmap
from ..obs import metrics as _metrics
from ..obs import slo as _slo
from ..obs import span as _span

__all__ = ["AssignResult", "ClusterIndex", "bucket_shape"]


def bucket_shape(
    n_cand: int, n_block: int, *, db_tile: int = 256, chunk: int = 256, q_tile: int = 128,
) -> tuple[int, int]:
    """Quantized ``(db_bucket, query_chunk)`` shape of one serve
    verification block, as the reference's: the candidate side rounds up
    to a power of two no smaller than the db tile, the query chunk
    clamps to the power-of-two block size (floored at one q tile).  The
    reference compiles one program a shape; here the shapes are counted
    (``serve.bucket_compiles``) and the chunk sizes the sweep."""
    bucket = max(db_tile, 1 << int(np.ceil(np.log2(max(n_cand, 1)))))
    chunk = min(chunk, max(q_tile, 1 << int(np.ceil(np.log2(max(n_block, 1))))))
    return bucket, chunk


@dataclass
class AssignResult:
    labels: np.ndarray       # (q,) int64: cluster id or -1 (noise/unmatched)
    confidence: np.ndarray   # (q,) float32 in [0, 1]
    n_hits: np.ndarray       # (q,) int64: eps-neighbors found in the shortlist

    def __len__(self) -> int:
        return len(self.labels)


class ClusterIndex:
    """Immutable serving snapshot: centroids + per-cluster members (+ the
    signature table when the backing index is signed-RP), with the rows
    and signatures on ``device`` (``None`` = cuda, raising without a
    card; ``"cpu"`` runs the kernels' plain versions)."""

    def __init__(
        self,
        data: np.ndarray,
        labels: np.ndarray,
        eps: float,
        *,
        sigs: Optional[np.ndarray] = None,
        projection: Optional[np.ndarray] = None,
        band: Optional[tuple[int, int]] = None,
        version: int = 0,
        device=None,
        oracle: bool = False,
        sweep_kw: Optional[dict] = None,
        centroids: Optional[np.ndarray] = None,
        data_dev: Optional[torch.Tensor] = None,
        sigs_dev: Optional[torch.Tensor] = None,
    ):
        self.eps = float(eps)
        self.version = version
        self.device = resolve_device(device)
        self.oracle = bool(oracle)
        self.sweep_kw = dict(sweep_kw or {})
        self._data = data
        self._sigs = sigs
        self._projection = projection
        self._band = band
        # the engine's operands, resident on the device (the backing
        # index's own tensors when built from a stream)
        self._data_dev = data_dev if data_dev is not None else torch.from_numpy(
            np.ascontiguousarray(data, dtype=np.float32)).to(self.device)
        self._sigs_dev = None
        if sigs is not None:
            self._sigs_dev = sigs_dev if sigs_dev is not None else torch.from_numpy(
                np.ascontiguousarray(sigs, dtype=np.uint32).view(np.int32)).to(self.device)
        labels = np.asarray(labels)
        self.n_clusters = int(labels.max()) + 1 if labels.size and labels.max() >= 0 else 0
        mask = labels >= 0
        idx = np.nonzero(mask)[0]
        order = np.argsort(labels[idx], kind="stable")
        self._members = idx[order]
        self._offsets = np.searchsorted(labels[idx][order], np.arange(self.n_clusters + 1))
        if centroids is not None and centroids.shape[0] == self.n_clusters:
            # a restored replica hands the saved centroids back
            self.centroids = np.ascontiguousarray(centroids, dtype=np.float32)
        else:
            cents = np.zeros((self.n_clusters, data.shape[1]), dtype=np.float32)
            for c in range(self.n_clusters):
                cents[c] = data[self.members(c)].mean(axis=0)
            norms = np.linalg.norm(cents, axis=1, keepdims=True)
            self.centroids = cents / np.maximum(norms, 1e-12)
        self._seen_buckets: set = set()

    @classmethod
    def from_stream(cls, stream, centroids: Optional[np.ndarray] = None) -> "ClusterIndex":
        bk = stream.backend
        sweep_kw = {k: getattr(bk, k) for k in ("chunk", "q_tile", "db_tile", "chunks_per_launch")
                    if hasattr(bk, k)}
        sigs = getattr(bk, "signatures", None)
        return cls(
            bk.data,
            stream.state.labels(),
            stream.eps,
            sigs=sigs,
            projection=getattr(bk, "projection", None),
            band=bk.band(stream.eps) if hasattr(bk, "band") else None,
            version=stream.state.version,
            device=bk.device,
            oracle=getattr(bk, "oracle", False),
            sweep_kw=sweep_kw,
            centroids=centroids,
            data_dev=bk.data_device,
            sigs_dev=getattr(bk, "_sigs_dev", None) if sigs is not None else None,
        )

    def members(self, c: int) -> np.ndarray:
        """Database row indices of cluster ``c``."""
        return self._members[self._offsets[c] : self._offsets[c + 1]]

    def shortlist(self, queries: np.ndarray, k: int) -> np.ndarray:
        """(q, k) best cluster ids by centroid cosine score, best first."""
        q = _unit_rows(queries)
        k = min(k, self.n_clusters)
        scores = q @ self.centroids.T
        top = np.argpartition(-scores, k - 1, axis=1)[:, :k]
        row = np.arange(len(q))[:, None]
        return top[row, np.argsort(-scores[row, top], axis=1)]

    def assign(
        self, queries: np.ndarray, *, shortlist: int = 8, min_hits: int = 1,
        oracle: Optional[bool] = None,
    ) -> AssignResult:
        """Cluster ids + confidence for unseen query vectors; ``oracle``
        (default: the snapshot's) picks the host loop."""
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        oracle = self.oracle if oracle is None else bool(oracle)
        t0 = time.perf_counter()
        with _span("serve.assign", nq=queries.shape[0], shortlist=shortlist, oracle=oracle):
            res = self._assign(queries, shortlist=shortlist, min_hits=min_hits, oracle=oracle)
        if _metrics.enabled():
            _metrics.histogram("serve.assign.latency_s", "assign() wall seconds per call").observe(
                time.perf_counter() - t0)
            calls = _metrics.counter("serve.assign.calls")
            calls.inc()
            _metrics.counter("serve.assign.queries").inc(queries.shape[0])
            _metrics.gauge("serve.shortlist").set(min(shortlist, self.n_clusters))
            if calls.value % _slo.EVAL_EVERY_CALLS == 0:
                _slo.check_and_alert(_slo.SERVE_SLOS)
        return res

    def _assign(self, queries, *, shortlist: int, min_hits: int, oracle: bool) -> AssignResult:
        nq = queries.shape[0]
        labels = np.full(nq, -1, dtype=np.int64)
        conf = np.zeros(nq, dtype=np.float32)
        hits_out = np.zeros(nq, dtype=np.int64)
        if self.n_clusters == 0:
            return AssignResult(labels, conf, hits_out)
        q = _unit_rows(queries)
        top = self.shortlist(q, shortlist)
        q_dev = torch.from_numpy(q).to(self.device)
        banded = self._sigs is not None and self._projection is not None and self._band is not None
        q_sig = sign_signatures(q_dev, self._projection, device=self.device) if banded else None
        cluster_of = np.empty(len(self._data), dtype=np.int64)
        cluster_of[self._members] = np.repeat(np.arange(self.n_clusters), np.diff(self._offsets))
        if not oracle:
            self._assign_engine(q_dev, q_sig, top, cluster_of, labels, conf, hits_out, min_hits)
            return AssignResult(labels, conf, hits_out)
        thresh = 1.0 - self.eps
        q_sig_h = q_sig.cpu().numpy().view(np.uint32) if banded else None
        for i in range(nq):
            cand = np.concatenate([self.members(c) for c in top[i]])
            if banded:
                # the shared dual-threshold predicate: dots only for the band
                t_lo, t_hi = self._band
                ham = hamming_numpy(q_sig_h[i : i + 1], self._sigs[cand])[0]
                dots = np.zeros(len(cand), dtype=np.float32)
                bi = np.nonzero((ham <= t_hi) & (ham > t_lo))[0]
                if len(bi):
                    dots[bi] = self._data[cand[bi]] @ q[i]
                hit = band_hits(dots, ham, self.eps, t_lo, t_hi)
            else:
                hit = (self._data[cand] @ q[i]) > thresh
            self._record(i, cluster_of[cand[hit]], labels, conf, hits_out, min_hits)
        return AssignResult(labels, conf, hits_out)

    def _record(self, i, hit_clusters, labels, conf, hits_out, min_hits) -> None:
        """Plurality cluster + confidence from one query's eps-neighbor
        cluster ids: the one definition both paths record through."""
        total = len(hit_clusters)
        hits_out[i] = total
        if total < max(min_hits, 1):
            return
        tally = np.bincount(hit_clusters, minlength=self.n_clusters)
        best = int(tally.argmax())
        labels[i] = best
        conf[i] = tally[best] / total

    def _assign_engine(self, q, q_sig, top, cluster_of, labels, conf, hits_out, min_hits) -> None:
        """One sweep launch per query block against the union of the
        block's shortlisted clusters' members (each query's hits are then
        restricted to its own shortlist, so results equal the host
        loop's), one host read a block."""
        sizes = np.diff(self._offsets)

        def verify(s: int, e: int) -> None:
            ids = np.unique(top[s:e])
            n_cand = int(sizes[ids].sum())
            if n_cand == 0:
                return
            # low-overlap traffic would inflate a query's verified set from
            # its own shortlist to the union: split the block until the
            # shared work stays within ~4x the per-query totals
            if e - s > 8 and n_cand * (e - s) > 4 * int(sizes[top[s:e]].sum()):
                mid = (s + e) // 2
                verify(s, mid)
                verify(mid, e)
                return
            cand = np.concatenate([self.members(c) for c in ids])
            shape = bucket_shape(
                len(cand), e - s, db_tile=self.sweep_kw.get("db_tile", 256),
                chunk=self.sweep_kw.get("chunk", 256), q_tile=self.sweep_kw.get("q_tile", 128),
            )
            if shape not in self._seen_buckets:
                self._seen_buckets.add(shape)
                _metrics.counter("serve.bucket_compiles").inc()
            _metrics.counter("serve.verify_launches").inc()
            _metrics.counter("serve.candidates").inc(int(len(cand)))
            cidx = torch.from_numpy(cand).to(self.device)
            if q_sig is not None:
                t_lo, t_hi = self._band
                _, bm = sweep_bitmap(
                    q[s:e], q_sig[s:e], self._data_dev[cidx], self._sigs_dev[cidx], len(cand),
                    self.eps, t_lo, t_hi, chunk=shape[1], q_tile=self.sweep_kw.get("q_tile", 128),
                    chunks_per_launch=self.sweep_kw.get("chunks_per_launch", 8),
                )
            else:
                bm = range_bitmap(q[s:e], self._data_dev[cidx], self.eps).cpu().numpy().view(np.uint32)
            hit = unpack_bitmap(bm, len(cand))
            cl = cluster_of[cand]
            for bi in range(e - s):
                i = s + bi
                sel = cl[hit[bi]]
                self._record(i, sel[np.isin(sel, top[i])], labels, conf, hits_out, min_hits)

        for s in range(0, q.shape[0], 256):
            verify(s, min(s + 256, q.shape[0]))


def _unit_rows(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
