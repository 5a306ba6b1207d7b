"""Port parity for streaming LAF-DBSCAN (``repro_torch.stream``) against
the JAX package's ``repro.stream`` on the same seeded numpy batches:
exact-backend streams are identical (labels, counts, core, owner), RP
streams agree to ARI >= 0.99 (the reference's own bound), the serving
engine equals its host oracle loop, the backends' in-place appends and
state protocol match the reference's, and the ingest's host reads stay
within the reference's.

On the CPU the port runs its kernels' plain versions (``device="cpu"``);
the ``gpu`` cases hold a stream on the card to the same stream on the
CPU.  The RP backend packs natively in the port on the CPU too, so its
streams here run the packed path (``ingest_rows_packed``,
``promote_packed``, ``apply_core_rows_packed`` through
``packed_connectivity``); the reference on the CPU runs its host path.
"""

import numpy as np
import pytest
import torch

from repro.core.metrics import adjusted_rand_index
from repro.data.synthetic import make_angular_clusters
from repro.index import ExactBackend as JExact
from repro.index import RandomProjectionBackend as JRP
from repro.stream import StreamingLAF as JStream
from repro.stream.serve import bucket_shape as j_bucket_shape

from repro_torch.core.dbscan import dbscan_parallel
from repro_torch.core.pipeline import LAFPipeline
from repro_torch.core.range_query import pack_bitmap
from repro_torch.index.exact import ExactBackend
from repro_torch.index.random_projection import RandomProjectionBackend
from repro_torch.obs import metrics
from repro_torch.stream import ClusterIndex, StreamingClusterState, StreamingLAF, bucket_shape

EPS, TAU = 0.35, 5


@pytest.fixture(scope="module")
def stream_data():
    data, _ = make_angular_clusters(1500, 32, 12, kappa=200, noise_frac=0.3, seed=1)
    return data[np.random.default_rng(0).permutation(len(data))]


@pytest.fixture
def metrics_on():
    was = metrics.enabled()
    metrics.enable()
    metrics.reset()
    yield metrics
    metrics.reset()
    if not was:
        metrics.disable()


def _batches(data, k):
    step = -(-len(data) // k)
    return [data[i : i + step] for i in range(0, len(data), step)]


def _pair(data, k, block_size=512, **kw):
    """The same batches through the reference's stream and the port's."""
    a = JStream(EPS, TAU, block_size=block_size, **kw)
    b = StreamingLAF(EPS, TAU, block_size=block_size, device="cpu", **kw)
    for batch in _batches(data, k):
        a.partial_fit(batch)
        b.partial_fit(batch)
    return a, b


def _assert_same_state(a, b):
    n = a.state.n
    assert n == b.state.n
    np.testing.assert_array_equal(a.labels(), b.labels())
    for f in ("counts", "core", "owner", "alive", "queried"):
        np.testing.assert_array_equal(getattr(a.state, f)[:n], getattr(b.state, f)[:n], err_msg=f)


# (batches, block_size): several batches; one batch over twelve blocks
# (same-batch pairs that span two blocks must not count twice)
@pytest.mark.parametrize("k,block_size", [(5, 512), (9, 512), (1, 128)])
def test_exact_stream_identical_to_reference(stream_data, k, block_size):
    a, b = _pair(stream_data[: 1500 if k > 1 else 600], k, block_size, backend="exact")
    _assert_same_state(a, b)


def test_exact_stream_matches_dbscan_parallel(stream_data):
    s = StreamingLAF(EPS, TAU, backend="exact", device="cpu")
    for batch in _batches(stream_data, 6):
        s.partial_fit(batch)
    ref = dbscan_parallel(stream_data, EPS, TAU, device="cpu")
    np.testing.assert_array_equal(s.labels(), ref.labels)
    np.testing.assert_array_equal(s.state.core[: s.state.n], ref.core)


def test_rp_stream_matches_reference(stream_data, metrics_on):
    a, b = _pair(stream_data, 4, backend="random_projection")
    assert adjusted_rand_index(a.labels(), b.labels()) >= 0.99
    # the packed path ran: one connectivity launch-equivalent a block
    assert metrics.counter("stream.ingest.host_syncs").value > 0


def test_rp_warm_start_matches_reference(stream_data):
    """A pre-fitted backend warm-starts the stream (its rows are batch
    zero), then batches stream in, in both packages."""
    a = JStream(EPS, TAU, backend=JRP().fit(stream_data[:900]), block_size=256)
    b = StreamingLAF(EPS, TAU, backend=RandomProjectionBackend(device="cpu").fit(stream_data[:900]),
                     block_size=256)
    assert b.n_points == 900
    for batch in _batches(stream_data[900:], 3):
        a.partial_fit(batch)
        b.partial_fit(batch)
    assert adjusted_rand_index(a.labels(), b.labels()) >= 0.99


def test_exact_warm_start_identical(stream_data):
    a = JStream(EPS, TAU, backend=JExact().fit(stream_data[:900]))
    b = StreamingLAF(EPS, TAU, backend=ExactBackend(device="cpu").fit(stream_data[:900]))
    for batch in _batches(stream_data[900:1200], 2):
        a.partial_fit(batch)
        b.partial_fit(batch)
    _assert_same_state(a, b)


def test_estimator_fast_path_identical(stream_data):
    """Skipped rows verified against the core set (``query_hits_subset``,
    ``seed_skipped``) and promoted later: the same oracle estimator in
    both packages gives the same state."""
    counts = JExact().fit(stream_data).query_counts(np.arange(len(stream_data)), EPS).astype(float)
    lookup = {v.tobytes(): c for v, c in zip(stream_data, counts)}

    def est(vectors):
        return np.array([lookup[v.tobytes()] for v in vectors])

    a, b = _pair(stream_data, 5, backend="exact", estimator=est, use_estimator=True, alpha=1.5)
    _assert_same_state(a, b)
    assert b.state.queried[: b.state.n].sum() < b.state.n  # some rows skipped


def test_evict_core_rebuilds_identically(stream_data, metrics_on):
    a, b = _pair(stream_data[:800], 2, backend="exact")
    core = np.nonzero(b.state.core[: b.state.n])[0]
    idx = np.random.default_rng(5).choice(core, 20, replace=False)
    assert a.evict(idx) and b.evict(idx)
    assert metrics.counter("stream.rebuilds").value == 1
    assert metrics.counter("stream.rebuilds.core_death").value == 1
    _assert_same_state(a, b)


def test_evict_noise_is_cheap_and_identical(stream_data):
    a, b = _pair(stream_data[:800], 2, backend="exact")
    noise = np.nonzero(b.labels() == -1)[0][:10]
    assert not a.evict(noise) and not b.evict(noise)
    _assert_same_state(a, b)
    assert b.state.n_dead == 10


def test_pipeline_partial_fit_assign(stream_data):
    pipe = LAFPipeline(backend="exact", device="cpu")
    with pytest.raises(ValueError):
        pipe.partial_fit(stream_data[:100])
    for start in range(0, 1000, 250):
        rep = pipe.partial_fit(stream_data[start : start + 250], eps=EPS, tau=TAU)
    assert rep.n_points == 1000
    ref = dbscan_parallel(stream_data[:1000], EPS, TAU, device="cpu")
    np.testing.assert_array_equal(pipe.stream.labels(), ref.labels)
    members = np.nonzero(ref.labels >= 0)[0][:10]
    np.testing.assert_array_equal(pipe.assign(stream_data[members]).labels, ref.labels[members])
    with pytest.raises(ValueError, match="operating-point-specific"):
        pipe.partial_fit(stream_data[1000:1100], eps=0.9, tau=2)
    with pytest.raises(ValueError, match="cannot be applied"):
        pipe.partial_fit(stream_data[1000:1100], eps=EPS, tau=TAU, block_size=64)


def test_instance_backend_rejects_index_kwargs():
    with pytest.raises(ValueError, match="constructed instance"):
        StreamingLAF(EPS, TAU, backend=RandomProjectionBackend(device="cpu"), n_bits=128)
    with pytest.raises(ValueError, match="constructed instance"):
        StreamingLAF(EPS, TAU, backend=RandomProjectionBackend(device="cpu"), device="cpu")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _queries(data, rows, seed=3, scale=0.01):
    rng = np.random.default_rng(seed)
    q = data[rows] + scale / np.sqrt(data.shape[1]) * rng.standard_normal((len(rows), data.shape[1]))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("backend", ["random_projection", "exact"])
def test_assign_engine_equals_host_oracle(stream_data, backend, metrics_on):
    a, b = _pair(stream_data, 4, backend=backend)
    q = np.concatenate([_queries(stream_data, np.arange(0, 1500, 7)), -stream_data[:3]])
    snap = b.snapshot()
    eng = snap.assign(q)
    host = snap.assign(q, oracle=True)
    for f in ("labels", "confidence", "n_hits"):
        np.testing.assert_array_equal(getattr(eng, f), getattr(host, f), err_msg=f)
    assert metrics.counter("serve.verify_launches").value >= 1
    # against the reference's assign on the same stream
    want = a.assign(q)
    assert np.mean(want.labels == eng.labels) >= 0.99
    if backend == "exact":
        np.testing.assert_array_equal(want.labels, eng.labels)
        np.testing.assert_array_equal(want.n_hits, eng.n_hits)


def test_assign_members_and_noise(stream_data):
    _, s = _pair(stream_data, 4, backend="random_projection")
    lab = s.labels()
    members = np.nonzero(lab >= 0)[0][:60]
    res = s.assign(stream_data[members])
    np.testing.assert_array_equal(res.labels, lab[members])
    far = np.zeros((1, stream_data.shape[1]), np.float32)
    far[0, -1] = 1.0
    assert not np.any(stream_data @ far[0] > 1.0 - EPS)
    r = s.assign(far)
    assert r.labels[0] == -1 and r.confidence[0] == 0.0 and r.n_hits[0] == 0
    assert s.snapshot() is s.snapshot()  # cached per state version
    snap = s.snapshot()
    s.partial_fit(stream_data[:10])
    assert s.snapshot() is not snap


def test_bucket_shape_matches_reference():
    for n_cand in (0, 1, 255, 256, 257, 1000, 4096, 70000):
        for n_block in (1, 8, 100, 128, 256):
            for kw in ({}, {"db_tile": 512, "chunk": 128, "q_tile": 64}):
                assert bucket_shape(n_cand, n_block, **kw) == j_bucket_shape(n_cand, n_block, **kw)


def test_cluster_index_from_labels_defaults_to_cuda(stream_data):
    labels = np.zeros(len(stream_data), dtype=np.int64)
    if torch.cuda.is_available():
        assert ClusterIndex(stream_data, labels, EPS).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ClusterIndex(stream_data, labels, EPS)
    assert ClusterIndex(stream_data, labels, EPS, device="cpu").n_clusters == 1


# ---------------------------------------------------------------------------
# backends: in-place appends and the state protocol
# ---------------------------------------------------------------------------


def test_rp_partial_fit_in_place_matches_reference(stream_data, metrics_on):
    j, t = JRP().fit(stream_data[:300]), RandomProjectionBackend(device="cpu").fit(stream_data[:300])
    for s, e in ((300, 350), (350, 1000), (1000, 1013)):
        j.partial_fit(stream_data[s:e])
        t.partial_fit(stream_data[s:e])
        assert t.n_points == e and t.data_device.shape[0] == e
        np.testing.assert_array_equal(t.signatures, j.signatures)
    assert metrics.counter("index.capacity_doublings").value == 2
    want, got = j.state_export(), t.state_export()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["data_buf"].shape[0] % t.db_tile == 0
    rows = np.arange(0, 1013, 11)
    np.testing.assert_array_equal(t.query_hits(rows, EPS), j.query_hits(rows, EPS))


def test_rp_state_import_either_way(stream_data):
    j = JRP().fit(stream_data[:500])
    j.partial_fit(stream_data[500:700])
    t = RandomProjectionBackend(device="cpu").state_import(j.state_export())
    rows = np.arange(0, 700, 9)
    np.testing.assert_array_equal(t.query_hits(rows, EPS), j.query_hits(rows, EPS))
    t.partial_fit(stream_data[700:800])
    j2 = JRP().state_import(t.state_export())
    np.testing.assert_array_equal(j2.query_hits(rows, EPS), t.query_hits(rows, EPS))
    with pytest.raises(ValueError, match="n_bits"):
        RandomProjectionBackend(device="cpu", n_bits=256).state_import(j.state_export())
    with pytest.raises(ValueError, match="db_tile"):
        RandomProjectionBackend(device="cpu", db_tile=512).state_import(j.state_export())


def test_exact_partial_fit_and_state(stream_data):
    j, t = JExact().fit(stream_data[:100]), ExactBackend(device="cpu").fit(stream_data[:100])
    for s, e in ((100, 150), (150, 420)):
        j.partial_fit(stream_data[s:e])
        t.partial_fit(stream_data[s:e])
    want, got = j.state_export(), t.state_export()
    assert sorted(got) == sorted(want) and int(got["n"]) == 420
    np.testing.assert_array_equal(got["buf"], want["buf"])
    t2 = ExactBackend(device="cpu").state_import(want)
    np.testing.assert_array_equal(t2.query_hits(np.arange(0, 420, 5), EPS), j.query_hits(np.arange(0, 420, 5), EPS))


# ---------------------------------------------------------------------------
# state: the packed connectivity replay and the host reads
# ---------------------------------------------------------------------------


def test_apply_core_rows_packed_equals_unpacked(stream_data):
    """One block through ``apply_core_rows_packed`` (``packed_connectivity``)
    and through the boolean ``apply_core_rows``: the same partition and
    owners, with a tombstone and a ragged n."""
    data = stream_data[:611]
    hit = (data @ data.T) > 1.0 - EPS
    counts = hit.sum(axis=1)
    states = []
    for _ in range(2):
        st = StreamingClusterState(EPS, TAU)
        st.extend(len(data))
        st.core[: len(data)] = counts >= TAU
        st.alive[17] = False
        states.append(st)
    rows = np.arange(100, 400)
    states[0].apply_core_rows(rows, hit[rows])
    states[1].apply_core_rows_packed(rows, torch.from_numpy(pack_bitmap(hit[rows]).view(np.int32)))
    np.testing.assert_array_equal(states[0].labels(), states[1].labels())
    np.testing.assert_array_equal(states[0].owner, states[1].owner)


def test_host_syncs_within_reference(stream_data, metrics_on):
    """One host read a sweep block, a promotion block and a connectivity
    block on the native path; the reference reads a promotion block
    twice."""
    s = StreamingLAF(EPS, TAU, backend="random_projection", device="cpu", block_size=200)
    blocks = promo_blocks = 0
    for batch in _batches(stream_data, 4):
        rep = s.partial_fit(batch)
        blocks += -(-rep.n_executed // 200)
        promo_blocks += -(-rep.n_promoted // 200)
    assert promo_blocks > 0
    got = metrics.counter("stream.ingest.host_syncs").value
    assert got == 2 * blocks + promo_blocks
    assert got <= 2 * blocks + 2 * promo_blocks  # the reference's reads


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["random_projection", "exact"])
def test_gpu_stream_matches_cpu(stream_data, backend, metrics_on):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    runs = []
    for dev in ("cuda", "cpu"):
        s = StreamingLAF(EPS, TAU, backend=backend, device=dev, block_size=512)
        for batch in _batches(stream_data, 4):
            s.partial_fit(batch)
        runs.append(s)
    _assert_same_state(*runs)
    q = _queries(stream_data, np.arange(0, 1500, 7))
    np.testing.assert_array_equal(runs[0].assign(q).labels, runs[1].assign(q).labels)
    if backend == "random_projection":
        assert metrics.counter("kernel.packed_connectivity.launches").value >= 4
