"""Durable streaming plane: snapshot/restore, write-ahead log, failover
(port of ``repro.stream.durability``; the same ``b"LAFW"`` framing and
``REPLICA_FORMAT``, so a replica either package wrote restores in the
other).

``DurableStream`` wraps a :class:`~repro_torch.stream.ingest.StreamingLAF`
with crash recovery:

* **Snapshots** ride ``repro_torch.train.checkpoint`` (versioned
  manifest, per-array crc32, atomic ``tmp-`` → rename publish).  One
  snapshot is the *full serving replica*: the cluster state's capacity
  arrays + the union-find, the range backend's capacity buffers through
  the ``state_export`` protocol (exact rows / signed-RP signature + row
  slabs, append slack included), and the serve ``ClusterIndex``
  centroids.
* **WAL** — every ``partial_fit`` / ``evict`` batch is appended to a
  length+crc framed log *before* it is applied, and the log rotates at
  each snapshot.  Recovery = newest valid snapshot + replay of the WAL
  tail; a torn final record (the un-fsynced tail of a mid-batch kill)
  fails its crc/length check and is dropped **deterministically**, so
  recovered labels/owners/counts are bit-identical to an uninterrupted
  run over the surviving prefix.
* **Corruption fallback** — a snapshot that fails its checksum verify
  is skipped and recovery falls back to the next older one; the WAL
  chain is replayed from whatever base was restored (per-record global
  sequence numbers make replay idempotent across bases).
* **Failover** — :func:`clone_replica` builds a read replica from the
  snapshot + WAL without touching the log; ``DurableStream.promote``
  replays whatever tail the dead primary wrote after the clone and
  takes over the log.

Layout (one directory per stream)::

    <root>/step_<seq>/        snapshots (train.checkpoint dirs)
    <root>/wal_<seq>.log      records (seq', kind, npz payload, crc32)
                              appended after snapshot <seq>

Sequence numbers are global and monotonic: record k is the k-th
mutation the stream ever applied, snapshots are taken *at* a sequence
number, and ``wal_<s>.log`` holds records ``s+1 ..`` (until the next
rotation).  Replay filters on ``seq > base``, so it is correct even if
a crash lands between snapshot publish and log rotation.
"""

from __future__ import annotations

import io
import json
import os
import struct
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from ..obs import get_logger, metrics as _metrics, rate_limited_warn, span as _span
from ..train.checkpoint import (
    CheckpointCorruptError,
    gc_checkpoints,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)
from .state import StreamingClusterState

__all__ = [
    "DurableStream",
    "WalWriter",
    "read_wal",
    "export_replica",
    "import_replica",
    "clone_replica",
    "KIND_INGEST",
    "KIND_EVICT",
]

_log = get_logger("stream.durability")

WAL_MAGIC = b"LAFW"
WAL_VERSION = 1
_REC_HDR = struct.Struct("<QBI")  # seq, kind, payload_len
_REC_CRC = struct.Struct("<I")

KIND_INGEST = 1
KIND_EVICT = 2

REPLICA_FORMAT = 1


def _npz_bytes(arrays: dict) -> bytes:
    bio = io.BytesIO()
    np.savez(bio, **arrays)
    return bio.getvalue()


def _npz_load(payload: bytes) -> dict:
    with np.load(io.BytesIO(payload)) as z:
        return {k: z[k] for k in z.files}


class WalWriter:
    """Append-only, length+crc framed record log (fsync per append by
    default — the durability boundary the mid-batch kill tests rely
    on: a record either fully lands or its torn tail is dropped)."""

    def __init__(self, path, *, fsync: bool = True):
        self.path = Path(path)
        self.fsync = fsync
        self._f = open(self.path, "wb")
        self._f.write(WAL_MAGIC + struct.pack("<I", WAL_VERSION))
        self._flush()

    def append(self, seq: int, kind: int, arrays: dict) -> int:
        payload = _npz_bytes(arrays)
        hdr = _REC_HDR.pack(seq, kind, len(payload))
        rec = hdr + payload + _REC_CRC.pack(zlib.crc32(hdr + payload))
        self._f.write(rec)
        self._flush()
        _metrics.counter("durability.wal_records").inc()
        _metrics.counter("durability.wal_bytes").inc(len(rec))
        return len(rec)

    def _flush(self) -> None:
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_wal(path):
    """Yield ``(seq, kind, arrays)`` records; stops **deterministically**
    at the first torn or corrupt record (short header, short payload,
    or crc mismatch) — the un-fsynced tail of a killed writer."""
    p = Path(path)
    if not p.exists():
        return
    raw = p.read_bytes()
    if len(raw) < 8 or raw[:4] != WAL_MAGIC:
        return
    off = 8
    while True:
        if off + _REC_HDR.size > len(raw):
            return
        hdr = raw[off : off + _REC_HDR.size]
        seq, kind, plen = _REC_HDR.unpack(hdr)
        end = off + _REC_HDR.size + plen + _REC_CRC.size
        if end > len(raw):
            return
        payload = raw[off + _REC_HDR.size : off + _REC_HDR.size + plen]
        (crc,) = _REC_CRC.unpack(raw[end - _REC_CRC.size : end])
        if crc != zlib.crc32(hdr + payload):
            return
        try:
            arrays = _npz_load(payload)
        except Exception:
            return
        yield seq, kind, arrays
        off = end


# -- replica export/import ---------------------------------------------------


def export_replica(stream, *, seq: int = 0) -> dict:
    """The full serving replica as a flat checkpoint tree: cluster
    state arrays, backend capacity buffers, serve centroids, and a json
    meta leaf (format/config echo)."""
    state = stream.state.export_arrays()
    bk_state = stream.backend.state_export()
    serve = stream.snapshot()  # the ClusterIndex (cached per state version)
    meta = {
        "format": REPLICA_FORMAT,
        "seq": int(seq),
        "eps": float(stream.eps),
        "tau": int(stream.tau),
        "backend": stream.backend.name,
        "n_points": int(stream.state.n),
        "n_clusters": int(serve.n_clusters),
        "estimator_attached": stream.estimator is not None,
    }
    tree = {"meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8).copy()}
    for k, v in state.items():
        tree[f"state.{k}"] = v
    for k, v in bk_state.items():
        tree[f"backend.{k}"] = v
    tree["centroids"] = serve.centroids
    return tree


def import_replica(stream, tree: dict) -> dict:
    """Load an ``export_replica`` tree into a *fresh, identically
    configured* stream (the factory owns code + config + estimator —
    only data travels through the snapshot).  Returns the meta dict."""
    meta = json.loads(np.asarray(tree["meta"], dtype=np.uint8).tobytes().decode())
    if meta["format"] != REPLICA_FORMAT:
        raise ValueError(f"replica format {meta['format']} != {REPLICA_FORMAT}")
    if meta["backend"] != stream.backend.name:
        raise ValueError(
            f"snapshot backend {meta['backend']!r} != stream backend "
            f"{stream.backend.name!r}"
        )
    if float(meta["eps"]) != stream.eps or int(meta["tau"]) != stream.tau:
        raise ValueError(
            f"snapshot operating point (eps={meta['eps']}, tau={meta['tau']}) != "
            f"stream (eps={stream.eps}, tau={stream.tau})"
        )
    stream.state = StreamingClusterState.import_arrays(
        {k.split(".", 1)[1]: v for k, v in tree.items() if k.startswith("state.")}
    )
    stream.backend.state_import(
        {k.split(".", 1)[1]: v for k, v in tree.items() if k.startswith("backend.")}
    )
    if meta.get("estimator_attached") and stream.estimator is None:
        rate_limited_warn(
            _log, "estimator_missing", "restored_without_estimator",
            n_points=meta["n_points"],
        )
    # plant the serving snapshot with the saved centroids so the replica
    # serves immediately without re-running the per-cluster mean pass
    from .serve import ClusterIndex

    stream._serve = ClusterIndex.from_stream(
        stream, centroids=np.asarray(tree["centroids"])
    )
    return meta


def _load_flat(root: Path, step: int) -> dict:
    """Restore one snapshot as the flat dict ``export_replica`` wrote
    (keys recovered from the manifest, values checksum-verified)."""
    manifest = json.loads((root / f"step_{step:012d}" / "manifest.json").read_text())
    keys = [p.strip("[]'\"") for p in manifest["paths"]]
    tree, _ = restore_checkpoint(root, step, template={k: 0 for k in keys})
    return tree


def _replay(stream, root: Path, after: int):
    """Apply every WAL record with ``seq > after`` in order; returns
    ``(last_seq, n_records, n_rows)``."""
    last, n_rec, n_rows = after, 0, 0
    files = sorted(
        root.glob("wal_*.log"), key=lambda f: int(f.stem.split("_")[1])
    )
    for f in files:
        for seq, kind, arrays in read_wal(f):
            if seq <= last:
                continue
            if kind == KIND_INGEST:
                rows = np.ascontiguousarray(arrays["rows"], dtype=np.float32)
                stream.partial_fit(rows)
                n_rows += rows.shape[0]
            elif kind == KIND_EVICT:
                stream.evict(np.asarray(arrays["idx"], dtype=np.int64))
            else:  # unknown kind: stop (a newer writer's record)
                rate_limited_warn(_log, "wal_kind", "wal_unknown_kind", kind=kind)
                return last, n_rec, n_rows
            last = seq
            n_rec += 1
    return last, n_rec, n_rows


def clone_replica(root, factory):
    """Build a **read replica**: newest valid snapshot (corrupt ones are
    skipped with a counter) + WAL replay, never touching the log.
    Returns ``(stream, seq, info)`` — hand ``(stream, seq)`` to
    :meth:`DurableStream.promote` after the primary dies."""
    root = Path(root)
    t0 = time.perf_counter()
    stream, base = None, 0
    for step in reversed(list_steps(root)):
        try:
            tree = _load_flat(root, step)
        except CheckpointCorruptError as e:
            _metrics.counter("durability.corrupt_snapshots").inc()
            rate_limited_warn(
                _log, "snap_corrupt", "snapshot_corrupt", step=step,
                error=type(e).__name__,
            )
            continue
        stream = factory()
        import_replica(stream, tree)
        base = step
        break
    if stream is None:
        stream = factory()
    t_snap = time.perf_counter()
    last, n_rec, n_rows = _replay(stream, root, base)
    t1 = time.perf_counter()
    _metrics.counter("durability.wal_replayed").inc(n_rec)
    info = {
        "snapshot_step": base,
        "seq": last,
        "wal_records": n_rec,
        "wal_rows": n_rows,
        "restore_s": t_snap - t0,
        "replay_s": t1 - t_snap,
        "recovery_s": t1 - t0,
    }
    return stream, last, info


class DurableStream:
    """A :class:`StreamingLAF` with write-ahead logging + snapshots.

    Use the constructor for a *fresh* stream directory (it opens a new
    log); use :meth:`recover` to resume after a crash and
    :meth:`promote` to take over from a cloned read replica.  Ingest
    and evict delegate to the wrapped stream after logging, so an
    uninterrupted ``DurableStream`` is label-identical to the bare
    stream fed the same batches.
    """

    def __init__(
        self,
        stream,
        root,
        *,
        snapshot_every: Optional[int] = None,
        keep: int = 3,
        fsync: bool = True,
        seq: int = 0,
    ):
        self.stream = stream
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        cfg = getattr(stream, "config", None)
        self.snapshot_every = (
            int(getattr(cfg, "snapshot_every", 8))
            if snapshot_every is None
            else int(snapshot_every)
        )
        self.keep = int(keep)
        self.fsync = bool(fsync)
        self.seq = int(seq)
        self.recovery_info: Optional[dict] = None
        self._wal = WalWriter(self.root / f"wal_{self.seq:012d}.log", fsync=fsync)

    # -- recovery / failover ----------------------------------------------
    @classmethod
    def recover(cls, root, factory, **kw) -> "DurableStream":
        """Resume after process death: snapshot + WAL replay, then an
        immediate snapshot to establish a clean base for the new log."""
        stream, seq, info = clone_replica(root, factory)
        d = cls(stream, root, seq=seq, **kw)
        d.recovery_info = info
        d.snapshot()
        return d

    @classmethod
    def promote(cls, stream, root, seq: int, **kw) -> "DurableStream":
        """Promote a read replica cloned at ``seq``: replay the WAL tail
        the dead primary wrote after the clone, then take over the log."""
        root = Path(root)
        t0 = time.perf_counter()
        last, n_rec, n_rows = _replay(stream, root, seq)
        _metrics.counter("durability.wal_replayed").inc(n_rec)
        d = cls(stream, root, seq=last, **kw)
        d.recovery_info = {
            "promoted_from": seq,
            "seq": last,
            "wal_records": n_rec,
            "wal_rows": n_rows,
            "recovery_s": time.perf_counter() - t0,
        }
        d.snapshot()
        return d

    # -- logged mutations ---------------------------------------------------
    def partial_fit(self, batch: np.ndarray):
        batch = np.ascontiguousarray(batch, dtype=np.float32)
        # write-ahead: the record lands (fsynced) before the mutation, so
        # a crash mid-apply replays it and a crash mid-write drops the
        # torn tail — either way recovery is deterministic
        self._wal.append(self.seq + 1, KIND_INGEST, {"rows": batch})
        rep = self.stream.partial_fit(batch)
        self.seq += 1
        self._maybe_snapshot()
        return rep

    def evict(self, idx: np.ndarray) -> bool:
        idx = np.asarray(idx, dtype=np.int64)
        self._wal.append(self.seq + 1, KIND_EVICT, {"idx": idx})
        out = self.stream.evict(idx)
        self.seq += 1
        self._maybe_snapshot()
        return out

    def _maybe_snapshot(self) -> None:
        if self.snapshot_every and self.seq % self.snapshot_every == 0:
            self.snapshot()

    def snapshot(self) -> Path:
        """Publish a snapshot at the current sequence number, rotate the
        log, and GC old snapshots + the WAL files they cover."""
        with _span("durability.snapshot", seq=self.seq, n=self.stream.state.n):
            tree = export_replica(self.stream, seq=self.seq)
            path = save_checkpoint(self.root, self.seq, tree, fsync=self.fsync)
            self._wal.close()
            self._wal = WalWriter(
                self.root / f"wal_{self.seq:012d}.log", fsync=self.fsync
            )
            gc_checkpoints(self.root, self.keep)
            steps = list_steps(self.root)
            if steps:
                # wal_<s>.log holds records s+1..<next snapshot>, so any
                # file older than the oldest kept snapshot is fully
                # covered by that snapshot and can go
                oldest = steps[0]
                for f in self.root.glob("wal_*.log"):
                    if int(f.stem.split("_")[1]) < oldest and f != self._wal.path:
                        f.unlink()
        _metrics.counter("durability.snapshots").inc()
        return path

    def close(self) -> None:
        self._wal.close()

    # -- delegation ---------------------------------------------------------
    def assign(self, queries: np.ndarray, **kw):
        return self.stream.assign(queries, **kw)

    def labels(self) -> np.ndarray:
        return self.stream.labels()

    def serve_snapshot(self):
        """The serving :class:`~repro_torch.stream.serve.ClusterIndex` (the
        wrapped stream's ``snapshot()`` — renamed here because
        ``DurableStream.snapshot`` is the durable one)."""
        return self.stream.snapshot()

    @property
    def state(self):
        return self.stream.state

    @property
    def backend(self):
        return self.stream.backend

    @property
    def n_points(self) -> int:
        return self.stream.n_points

    @property
    def n_clusters(self) -> int:
        return self.stream.n_clusters
