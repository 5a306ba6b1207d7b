"""Port parity for the durable streaming plane (``repro_torch.stream.
durability``, ``repro_torch.train.checkpoint``, ``repro_torch.testing.
faults``, ``repro_torch.train.fault_tolerance``): WAL framing and its
torn-tail and corrupt-record semantics, checkpoint crash safety, the
kill-restore contract (bit-identical labels, counts, core, owners), the
same bytes on disk as the JAX package (a checkpoint, a WAL and a whole
replica written by either restores in the other), and the port's
device-fault policy: a fault raises to the caller, on every sweep path
and in the cluster pass, and a durable stream recovers the batch it
stopped from its WAL.

Streams run on the CPU (``device="cpu"``: the kernels' plain versions).
The JAX package's metric registry is never turned on here.
"""

import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.data.synthetic import make_angular_clusters
from repro.stream import DurableStream as JDurable
from repro.stream import StreamingLAF as JStream
from repro.stream.durability import WalWriter as JWalWriter
from repro.stream.durability import read_wal as j_read_wal
from repro.testing import faults as jfaults
from repro.train import checkpoint as jckpt
from repro.train.fault_tolerance import GuardedStep as JGuardedStep
from repro.train.fault_tolerance import StragglerPolicy as JStragglerPolicy

from repro_torch.core.laf_dbscan import laf_dbscan
from repro_torch.index.random_projection import RandomProjectionBackend
from repro_torch.obs import metrics
from repro_torch.stream import DurableStream, StreamingLAF, clone_replica
from repro_torch.stream.durability import (
    KIND_EVICT,
    KIND_INGEST,
    WalWriter,
    export_replica,
    import_replica,
    read_wal,
)
from repro_torch.testing import faults
from repro_torch.train.checkpoint import (
    AsyncCheckpointer,
    CheckpointCorruptError,
    gc_checkpoints,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.fault_tolerance import GuardedStep, StragglerPolicy

EPS, TAU = 0.35, 5


@pytest.fixture(scope="module")
def stream_data():
    data, _ = make_angular_clusters(700, 16, 8, kappa=120, noise_frac=0.3, seed=7)
    return data[np.random.default_rng(1).permutation(len(data))]


@pytest.fixture
def obs_sandbox():
    """The port's metrics on and clean per test; the switch restored."""
    was = metrics.enabled()
    metrics.enable()
    metrics.reset()
    yield
    metrics.reset()
    if not was:
        metrics.disable()


def _factory(backend="exact"):
    return StreamingLAF(EPS, TAU, block_size=256, backend=backend, device="cpu")


def _jfactory(backend="exact"):
    return JStream(EPS, TAU, block_size=256, backend=backend)


def _batches(data, k):
    step = -(-len(data) // k)
    return [data[i : i + step] for i in range(0, len(data), step)]


def _assert_replica_equal(a, b):
    """Bit-identical serving state: labels, owners, counts, core, alive."""
    np.testing.assert_array_equal(a.labels(), b.labels())
    n = a.state.n
    assert n == b.state.n
    for f in ("counts", "core", "owner", "alive"):
        np.testing.assert_array_equal(getattr(a.state, f)[:n], getattr(b.state, f)[:n], err_msg=f)


# ---------------------------------------------------------------------------
# WAL framing
# ---------------------------------------------------------------------------


def _records(p):
    return [(s, k, {n: a.tolist() for n, a in arrs.items()}) for s, k, arrs in read_wal(p)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wal_round_trip_either_writer(tmp_path, writer):
    p = tmp_path / "wal_000000000000.log"
    w = (WalWriter if writer == "port" else JWalWriter)(p)
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    idx = np.array([1, 5], dtype=np.int64)
    w.append(1, KIND_INGEST, {"rows": rows})
    w.append(2, KIND_EVICT, {"idx": idx})
    w.close()
    recs = list(read_wal(p))
    assert [(s, k) for s, k, _ in recs] == [(1, KIND_INGEST), (2, KIND_EVICT)]
    np.testing.assert_array_equal(recs[0][2]["rows"], rows)
    np.testing.assert_array_equal(recs[1][2]["idx"], idx)
    assert _records(p) == [(s, k, {n: a.tolist() for n, a in arrs.items()}) for s, k, arrs in j_read_wal(p)]


def test_wal_bytes_equal_reference(tmp_path):
    recs = [(1, KIND_INGEST, {"rows": np.ones((2, 3), np.float32)}), (2, KIND_EVICT, {"idx": np.arange(4)})]
    for cls, name in ((WalWriter, "a.log"), (JWalWriter, "b.log")):
        w = cls(tmp_path / name, fsync=False)
        for r in recs:
            w.append(*r)
        w.close()
    assert (tmp_path / "a.log").read_bytes() == (tmp_path / "b.log").read_bytes()


def test_wal_torn_tail_dropped_deterministically(tmp_path):
    p = tmp_path / "wal_000000000000.log"
    w = WalWriter(p)
    for s in range(1, 4):
        w.append(s, KIND_INGEST, {"rows": np.full((2, 3), s, dtype=np.float32)})
    w.close()
    full = p.read_bytes()
    last_len = len(full) - len(full[: full.rfind(b"PK")])
    for cut in (1, last_len // 2, last_len - 1):
        p.write_bytes(full[: len(full) - cut])
        assert [s for s, _, _ in read_wal(p)] == [1, 2]
    p.write_bytes(full)
    assert [s for s, _, _ in read_wal(p)] == [1, 2, 3]


def test_wal_corrupt_record_stops_at_prior(tmp_path):
    p = tmp_path / "wal_000000000000.log"
    w = WalWriter(p)
    lens = [w.append(s, KIND_INGEST, {"rows": np.zeros((2, 2), np.float32)}) for s in (1, 2)]
    w.close()
    raw = bytearray(p.read_bytes())
    raw[8 + lens[0] + 20] ^= 0xFF
    p.write_bytes(bytes(raw))
    assert [s for s, _, _ in read_wal(p)] == [1]
    assert list(read_wal(tmp_path / "nope.log")) == []
    (tmp_path / "junk.log").write_bytes(b"not a wal at all")
    assert list(read_wal(tmp_path / "junk.log")) == []


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_partial_dirs_invisible_and_collected(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": np.arange(6, dtype=np.float32)}, fsync=False)
    (tmp_path / "tmp-step_000000000002").mkdir()
    (tmp_path / "tmp-step_000000000002" / "shard_000000.npz").write_bytes(b"x")
    (tmp_path / "step_000000000003").mkdir()
    assert list_steps(tmp_path) == [1]
    gc_checkpoints(tmp_path, keep=3)
    assert not (tmp_path / "tmp-step_000000000002").exists()
    assert not (tmp_path / "step_000000000003").exists()
    assert list_steps(tmp_path) == [1]


def test_checkpoint_checksum_corruption_detected(tmp_path):
    tree = {"a": np.arange(128, dtype=np.float32), "b": np.ones(4, np.int64)}
    save_checkpoint(tmp_path, 1, tree, fsync=False)
    shard = next((tmp_path / "step_000000000001").glob("shard_*.npz"))
    faults.corrupt_file(shard, seed=0)
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(tmp_path, 1, template={"a": 0, "b": 0})


def test_checkpoint_either_package_restores_the_other(tmp_path):
    """The same tree written by both packages: identical manifests (paths,
    dtypes, shapes, checksums), and each restores what the other wrote."""
    import json

    tree = {"z": np.arange(5, dtype=np.int64), "a": {"w": np.ones((2, 3), np.float32), "b": np.zeros(2, bool)},
            "m": [np.float64(1.5), np.arange(3, dtype=np.uint32)]}
    save_checkpoint(tmp_path / "port", 7, tree, fsync=False)
    jckpt.save_checkpoint(tmp_path / "jax", 7, tree, fsync=False)
    man = [json.loads((tmp_path / d / "step_000000000007" / "manifest.json").read_text()) for d in ("port", "jax")]
    for k in ("paths", "dtypes", "shapes", "checksums", "shards", "n_leaves"):
        assert man[0][k] == man[1][k], k
    got, _ = restore_checkpoint(tmp_path / "jax", template=tree)
    want, _ = jckpt.restore_checkpoint(tmp_path / "port", template=tree)
    for a, b, ref in ((got["a"]["w"], want["a"]["w"], tree["a"]["w"]), (got["m"][1], want["m"][1], tree["m"][1]),
                      (got["z"], want["z"], tree["z"])):
        np.testing.assert_array_equal(a, ref)
        np.testing.assert_array_equal(b, ref)


def test_async_checkpointer_keeps_newest(tmp_path):
    import torch

    ck = AsyncCheckpointer(tmp_path, keep=2)
    for step in range(1, 5):
        ck.save(step, {"w": torch.full((3,), float(step)), "n": np.int64(step)})
    ck.wait()
    assert list_steps(tmp_path) == [3, 4]
    tree, step = restore_checkpoint(tmp_path, template={"w": 0, "n": 0})
    assert step == 4 and tree["w"].tolist() == [4.0, 4.0, 4.0] and int(tree["n"]) == 4


# ---------------------------------------------------------------------------
# snapshot / restore, kill-restore
# ---------------------------------------------------------------------------


def test_export_import_replica_round_trip(stream_data):
    src = _factory()
    for b in _batches(stream_data, 4):
        src.partial_fit(b)
    tree = export_replica(src, seq=4)
    dst = _factory()
    meta = import_replica(dst, tree)
    assert meta["seq"] == 4 and meta["backend"] == "exact"
    _assert_replica_equal(src, dst)
    q = stream_data[:16]
    np.testing.assert_array_equal(src.assign(q).labels, dst.assign(q).labels)
    with pytest.raises(ValueError):
        import_replica(StreamingLAF(EPS, TAU + 1, backend="exact", device="cpu"), tree)
    with pytest.raises(ValueError):
        import_replica(_factory("random_projection"), tree)


def test_durable_stream_is_label_identical_to_bare(stream_data, tmp_path):
    bare = _factory()
    d = DurableStream(_factory(), tmp_path, snapshot_every=2, fsync=False)
    for b in _batches(stream_data, 5):
        bare.partial_fit(b)
        d.partial_fit(b)
    _assert_replica_equal(bare, d.stream)
    d.close()


@pytest.mark.parametrize("kill_after", [1, 3, 4])
def test_kill_at_batch_boundary_bit_identical(stream_data, tmp_path, kill_after):
    batches = _batches(stream_data, 5)
    bare = _factory()
    for b in batches:
        bare.partial_fit(b)
    d = DurableStream(_factory(), tmp_path, snapshot_every=2, fsync=False)
    for b in batches[:kill_after]:
        d.partial_fit(b)
    # the process dies here: no close(), no final snapshot
    d2 = DurableStream.recover(tmp_path, _factory, fsync=False)
    assert d2.seq == kill_after
    for b in batches[kill_after:]:
        d2.partial_fit(b)
    _assert_replica_equal(bare, d2.stream)
    d.close()
    d2.close()


@pytest.mark.parametrize("backend", ["exact", "random_projection"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_replica_carried_across_packages(stream_data, tmp_path, backend, writer):
    """A replica one package's ``DurableStream`` wrote (snapshot + WAL
    tail) recovers in the other's: labels identical, and still identical
    after one more batch on each side."""
    batches = _batches(stream_data, 5)
    mk_w, mk_r = ((_jfactory, _factory) if writer == "jax" else (_factory, _jfactory))
    Dw, Dr = (JDurable, DurableStream) if writer == "jax" else (DurableStream, JDurable)
    w = Dw(mk_w(backend), tmp_path, snapshot_every=2, fsync=False)
    for b in batches[:3]:
        w.partial_fit(b)
    r = Dr.recover(tmp_path, lambda: mk_r(backend), fsync=False)
    assert r.seq == 3
    np.testing.assert_array_equal(r.labels(), w.labels())
    n = w.state.n
    for f in ("counts", "core", "owner"):
        np.testing.assert_array_equal(getattr(r.state, f)[:n], getattr(w.state, f)[:n], err_msg=f)
    w.stream.partial_fit(batches[3])
    r.stream.partial_fit(batches[3])
    np.testing.assert_array_equal(r.labels(), w.labels())
    w.close()
    r.close()


def test_mid_batch_torn_tail_dropped(stream_data, tmp_path):
    batches = _batches(stream_data, 5)
    d = DurableStream(_factory(), tmp_path, snapshot_every=0, fsync=False)
    for b in batches[:3]:
        d.partial_fit(b)
    wal = d._wal.path
    d.close()
    w = WalWriter(tmp_path / "scratch.log", fsync=False)
    w.append(4, KIND_INGEST, {"rows": batches[3]})
    w.close()
    rec = (tmp_path / "scratch.log").read_bytes()[8:]
    with open(wal, "ab") as f:
        f.write(rec[: len(rec) // 2])
    d2 = DurableStream.recover(tmp_path, _factory, fsync=False)
    assert d2.seq == 3
    ref = _factory()
    for b in batches[:3]:
        ref.partial_fit(b)
    _assert_replica_equal(ref, d2.stream)
    d2.close()


def test_corrupt_snapshot_falls_back_to_older(stream_data, tmp_path, obs_sandbox):
    batches = _batches(stream_data, 6)
    bare = _factory()
    d = DurableStream(_factory(), tmp_path, snapshot_every=2, fsync=False)
    for b in batches:
        bare.partial_fit(b)
        d.partial_fit(b)
    d.close()
    steps = list_steps(tmp_path)
    newest = steps[-1]
    faults.corrupt_file(next((tmp_path / f"step_{newest:012d}").glob("shard_*.npz")), seed=1)
    d2 = DurableStream.recover(tmp_path, _factory, fsync=False)
    assert d2.recovery_info["snapshot_step"] < newest
    assert d2.seq == len(batches)
    _assert_replica_equal(bare, d2.stream)
    assert metrics.counter("durability.corrupt_snapshots").value >= 1
    d2.close()


def test_evict_through_wal_replay(stream_data, tmp_path):
    batches = _batches(stream_data, 4)
    evict_idx = np.arange(0, 120, 3, dtype=np.int64)
    bare = _factory()
    for b in batches[:3]:
        bare.partial_fit(b)
    bare.evict(evict_idx)
    bare.partial_fit(batches[3])
    d = DurableStream(_factory(), tmp_path, snapshot_every=2, fsync=False)
    for b in batches[:3]:
        d.partial_fit(b)
    d.evict(evict_idx)
    d2 = DurableStream.recover(tmp_path, _factory, fsync=False)
    d2.partial_fit(batches[3])
    _assert_replica_equal(bare, d2.stream)
    d.close()
    d2.close()


def test_sigkill_mid_run_then_recover(stream_data, tmp_path):
    """Real process death: the child SIGKILLs itself after 3 batches;
    recovery here is bit-identical to an uninterrupted run."""
    child = textwrap.dedent(
        """
        import os, signal, sys
        sys.path.insert(0, "src")
        import numpy as np
        from repro_torch.data.synthetic import make_angular_clusters
        from repro_torch.stream import DurableStream, StreamingLAF

        data, _ = make_angular_clusters(700, 16, 8, kappa=120, noise_frac=0.3, seed=7)
        data = data[np.random.default_rng(1).permutation(len(data))]
        step = -(-len(data) // 5)
        batches = [data[i:i + step] for i in range(0, len(data), step)]
        d = DurableStream(StreamingLAF(0.35, 5, block_size=256, backend="exact", device="cpu"),
                          sys.argv[1], snapshot_every=2, fsync=True)
        for b in batches[:3]:
            d.partial_fit(b)
        os.kill(os.getpid(), signal.SIGKILL)
        """
    )
    proc = subprocess.run([sys.executable, "-c", child, str(tmp_path)], capture_output=True, text=True,
                          timeout=300, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    batches = _batches(stream_data, 5)
    d2 = DurableStream.recover(tmp_path, _factory, fsync=False)
    assert d2.seq == 3
    for b in batches[3:]:
        d2.partial_fit(b)
    bare = _factory()
    for b in batches:
        bare.partial_fit(b)
    _assert_replica_equal(bare, d2.stream)
    d2.close()


def test_failover_clone_then_promote(stream_data, tmp_path):
    batches = _batches(stream_data, 5)
    primary = DurableStream(_factory(), tmp_path, snapshot_every=2, fsync=False)
    for b in batches[:3]:
        primary.partial_fit(b)
    replica, seq, info = clone_replica(tmp_path, _factory)
    assert seq == 3 and info["recovery_s"] >= 0
    for b in batches[3:]:
        primary.partial_fit(b)
    primary.close()
    promoted = DurableStream.promote(replica, tmp_path, seq, fsync=False)
    assert promoted.seq == 5 and promoted.recovery_info["wal_records"] == 2
    bare = _factory()
    for b in batches:
        bare.partial_fit(b)
    _assert_replica_equal(bare, promoted.stream)
    promoted.close()


def test_snapshot_gc_drops_covered_wal_files(stream_data, tmp_path):
    d = DurableStream(_factory(), tmp_path, snapshot_every=1, keep=2, fsync=False)
    for b in _batches(stream_data, 6):
        d.partial_fit(b)
    steps = list_steps(tmp_path)
    assert len(steps) <= 2
    for f in tmp_path.glob("wal_*.log"):
        assert int(f.stem.split("_")[1]) >= steps[0]
    d.close()


# ---------------------------------------------------------------------------
# fault injection: a device fault raises
# ---------------------------------------------------------------------------


def test_fault_plan_grammar_and_draws_match_reference():
    spec = "seed=9,sweep.launch=0.5,cluster.launch=1.0:2"
    plan, ref = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert plan.seed == 9 and plan.rules["cluster.launch"].max_count == 2
    fires = [plan.should_fail("sweep.launch") for _ in range(64)]
    assert fires == [ref.should_fail("sweep.launch") for _ in range(64)]
    assert 0 < sum(fires) < 64
    assert sum(plan.should_fail("cluster.launch") for _ in range(10)) == 2
    assert plan.summary()["fired"]["cluster.launch"] == 2


def test_guarded_step_and_straggler_match_reference():
    def flaky(k):
        state = {"n": 0}

        def step():
            state["n"] += 1
            if state["n"] <= k:
                raise RuntimeError("transient")
            return state["n"]
        return step

    sleeps, jsleeps = [], []
    got = GuardedStep(flaky(2), max_retries=3, backoff_s=0.5, sleep=sleeps.append)()
    want = JGuardedStep(flaky(2), max_retries=3, backoff_s=0.5, sleep=jsleeps.append)()
    assert (got.value, got.attempts, got.recovered) == (want.value, want.attempts, want.recovered) == (3, 3, False)
    assert sleeps == jsleeps == [0.5, 1.0]
    with pytest.raises(RuntimeError):
        GuardedStep(flaky(5), max_retries=1)()
    pol, jpol = StragglerPolicy(eject_after=2), JStragglerPolicy(eject_after=2)
    for t in (1.0, 1.1, 5.0, 6.0, 1.0):
        assert pol.observe(t) == jpol.observe(t)


def _rp(**kw):
    return RandomProjectionBackend(device="cpu", n_bits=128, margin=3.0, seed=3, chunk=64, q_tile=32, db_tile=64,
                                   **kw)


@pytest.fixture(scope="module")
def small_angular():
    data, _ = make_angular_clusters(192, 48, 6, kappa=120, noise_frac=0.3, seed=2)
    return data


SWEEP_OPS = {
    "counts": lambda bk, rows: bk.query_counts(rows, 0.55),
    "hits": lambda bk, rows: bk.query_hits(rows, 0.55),
    "hits_packed": lambda bk, rows: bk.query_hits_packed(rows, 0.55),
    "packed_device": lambda bk, rows: bk.query_packed_device(rows, 0.55),
    "subset": lambda bk, rows: bk.query_hits_subset(rows, rows[::2], 0.55),
}


@pytest.mark.parametrize("op", sorted(SWEEP_OPS))
def test_sweep_fault_raises(small_angular, obs_sandbox, op):
    """A fault at ``sweep.launch`` reaches the caller on every device
    query path, once: nothing retries it or answers from the host
    oracle.  With the plan gone the same backend answers as the oracle."""
    bk = _rp().fit(small_angular)
    rows = np.arange(16)
    with faults.inject("seed=5,sweep.launch=1.0"):
        with pytest.raises(faults.InjectedFault):
            SWEEP_OPS[op](bk, rows)
    assert metrics.counter("faults.injected").value == 1
    assert metrics.counter("stream.degraded.events").value == 0
    got, want = SWEEP_OPS[op](bk, rows), SWEEP_OPS[op](_rp(oracle=True).fit(small_angular), rows)
    for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cluster_launch_fault_raises(small_angular, obs_sandbox):
    """A fault at ``cluster.launch`` raises out of ``laf_dbscan``; the
    host pass does not stand in for the device pass."""
    pc = np.full(len(small_angular), 10**9)
    with faults.inject("seed=3,cluster.launch=1.0"):
        with pytest.raises(RuntimeError, match="cluster.launch"):
            laf_dbscan(small_angular, 0.45, 4, 1.0, pc, backend="exact", device="cpu", cluster_device=True)
        ref = laf_dbscan(small_angular, 0.45, 4, 1.0, pc, backend="exact", device="cpu", cluster_device=False)
    got = laf_dbscan(small_angular, 0.45, 4, 1.0, pc, backend="exact", device="cpu", cluster_device=True)
    np.testing.assert_array_equal(ref.labels, got.labels)
    assert metrics.counter("faults.injected").value == 1
    assert metrics.counter("stream.degraded.events").value == 0


def test_cluster_pass_refused_launch_raises(small_angular, monkeypatch):
    """A refused launch inside the device cluster pass (the way a
    cooperative launch whose grid cannot be resident fails:
    ``_build.check`` raises RuntimeError) raises out of ``laf_dbscan``."""
    from repro_torch.kernels.label_prop import ops as lp_ops

    def refused(*a, **k):
        lp_ops._build.check(720, "label_prop_fixpoint")  # cudaErrorCooperativeLaunchTooLarge

    monkeypatch.setattr(lp_ops, "label_prop_fixpoint", refused)
    pc = np.full(len(small_angular), 10**9)
    with pytest.raises(RuntimeError, match="label_prop_fixpoint"):
        laf_dbscan(small_angular, 0.45, 4, 1.0, pc, backend="exact", device="cpu", cluster_device=True)


def test_ingest_fault_raises_and_recovery_replays_it(small_angular, tmp_path, obs_sandbox):
    """A sweep fault in the middle of a durable stream's batch raises to
    the caller; the batch's WAL record landed first, so the recovered
    replica replays it and, after the remaining batches, equals a stream
    that never faulted, bit for bit."""
    batches = [small_angular[i : i + 64] for i in range(0, len(small_angular), 64)]

    def factory():
        return StreamingLAF(0.55, 4, block_size=64, backend=_rp())

    clean = factory()
    for b in batches:
        clean.partial_fit(b)
    d = DurableStream(factory(), tmp_path, snapshot_every=0, fsync=False)
    d.partial_fit(batches[0])
    with faults.inject("seed=11,sweep.launch=1.0"):
        with pytest.raises(faults.InjectedFault):
            d.partial_fit(batches[1])
    d2 = DurableStream.recover(tmp_path, factory, fsync=False)
    assert d2.seq == 2
    for b in batches[2:]:
        d2.partial_fit(b)
    _assert_replica_equal(clean, d2.stream)
    assert metrics.counter("stream.degraded.events").value == 0
    d.close()
    d2.close()


def test_rebuild_counter_and_reasons(stream_data, obs_sandbox):
    s = _factory()
    s.partial_fit(stream_data[:400])
    s.evict(np.nonzero(s.state.core[: s.state.n])[0][:40])
    assert metrics.counter("stream.rebuilds").value >= 1
    reasons = sum(metrics.counter(f"stream.rebuilds.{r}").value for r in ("core_death", "tombstone_frac", "manual"))
    assert reasons == metrics.counter("stream.rebuilds").value


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["exact", "random_projection"])
def test_gpu_kill_restore_on_card_matches_cpu(stream_data, tmp_path, backend):
    """A durable stream on the card, dropped after 3 batches and
    recovered on the card, against the same batches on the CPU: the
    replica's state is bit-identical (snapshots carry the backends'
    device buffers through the host)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def card():
        return StreamingLAF(EPS, TAU, block_size=256, backend=backend, device="cuda")

    batches = _batches(stream_data, 5)
    d = DurableStream(card(), tmp_path, snapshot_every=2, fsync=False)
    for b in batches[:3]:
        d.partial_fit(b)
    d2 = DurableStream.recover(tmp_path, card, fsync=False)
    for b in batches[3:]:
        d2.partial_fit(b)
    bare = _factory(backend)
    for b in batches:
        bare.partial_fit(b)
    _assert_replica_equal(bare, d2.stream)
    d.close()
    d2.close()
