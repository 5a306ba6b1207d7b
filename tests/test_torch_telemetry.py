"""Port parity for the device telemetry slice: the Hamming filter's
``_stats`` bodies, the count sweep's per-chunk occupancy slab, the
cluster fixpoint's per-round counters, ``suggest_margin`` /
``record_occupancy`` and the one-copy contracts with everything on.

The same numpy inputs go to the JAX package (Pallas kernels in
interpret mode, as its own tests run them) and to ``repro_torch`` on
CPU tensors (each kernel's plain version).  Every comparison is exact:
occupancy triples, slabs, per-round vectors and ``index.band.*``
counters are integers, and telemetry must leave counts, words and
labels bit-identical.  The ``gpu`` test holds both stats bodies to
their plain versions on the card and skips here.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro import obs as jobs
from repro.core.range_query import pack_bitmap
from repro.data.synthetic import make_angular_clusters
from repro.index.random_projection import RandomProjectionBackend as JaxRP
from repro.index.random_projection import record_occupancy as jax_record_occupancy
from repro.index.random_projection import suggest_margin as jax_suggest_margin
from repro.index.signatures import make_projection as jax_make_projection
from repro.index.signatures import sign_signatures as jax_sign_signatures
from repro.kernels.hamming_filter import ops as jhf
from repro.kernels.label_prop import packed_cluster_labels as jax_packed_cluster_labels
from repro.obs import device as jdevice
from repro.obs import metrics as jmetrics

from repro_torch import obs
from repro_torch.core.laf_dbscan import laf_dbscan
from repro_torch.index.random_projection import RandomProjectionBackend, record_occupancy, suggest_margin
from repro_torch.index.signatures import make_projection, popcount32, sign_signatures
from repro_torch.kernels.hamming_filter import ops as thf
from repro_torch.kernels.hamming_filter.ref import hamming_filter_ref
from repro_torch.kernels.label_prop import packed_cluster_labels
from repro_torch.obs import device as tdevice
from repro_torch.obs import metrics

BAND_FIELDS = ("accept", "band", "reject")


@pytest.fixture(autouse=True)
def obs_sandbox():
    """Both packages' obs switches fully on (trace, metrics, device
    telemetry) and their registries clean for each test; the
    process-global switches are restored afterwards."""
    saved = [(o, o.trace_enabled(), o.metrics_enabled(), o.device_enabled()) for o in (obs, jobs)]
    for o in (obs, jobs):
        o.enable(trace=True, metrics_on=True, telemetry=True)
        o.clear_trace()
        o.metrics.reset()
    yield
    for o, tr, me, dv in saved:
        o.clear_trace()
        o.metrics.reset()
        o.disable()
        if tr or me:
            o.enable(trace=tr, metrics_on=me)
        (o.enable_device if dv else o.disable_device)()


def _unit_clusters(seed, n, d, k=4, spread=0.35):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((k, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = c[rng.integers(0, k, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _t(a):
    a = np.array(a)  # a writable copy (JAX hands out read-only buffers)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


# ---------------------------------------------------------------------------
# (a) the stats bodies: the whole-call triple on the reference's grid
# ---------------------------------------------------------------------------

# (nq, nd, d, n_bits, eps, t_lo, t_hi, q_tile, db_tile): tile-aligned,
# ragged nq and nd, full verify (t_lo = -1), and eps > 1
STATS_CASES = [
    (64, 256, 16, 64, 0.5, 20, 30, 32, 128),
    (37, 201, 16, 64, 0.5, -1, 30, 32, 128),
    (70, 300, 32, 128, 0.45, 40, 60, 32, 128),
    (45, 150, 32, 128, 1.2, 50, 128, 32, 64),
    (130, 257, 16, 64, 0.6, 18, 34, 128, 256),
]


@pytest.mark.parametrize("nq,nd,d,n_bits,eps,t_lo,t_hi,q_tile,db_tile", STATS_CASES)
def test_stats_triples_match_jax(nq, nd, d, n_bits, eps, t_lo, t_hi, q_tile, db_tile):
    x = _unit_clusters(nq + nd, nq + nd, d)
    sig = np.asarray(jax_sign_signatures(x, jax_make_projection(d, n_bits, nq)))
    q, db, qs, dbs = x[:nq], x[nq:], sig[:nq], sig[nq:]
    kw = dict(t_lo=t_lo, q_tile=q_tile, db_tile=db_tile)
    jc, js = jhf.hamming_filter_count(jnp.asarray(q), jnp.asarray(db), qs, dbs, eps, t_hi,
                                      interpret=True, return_stats=True, **kw)
    jbc, jbw, jbs = jhf.hamming_filter_bitmap(jnp.asarray(q), jnp.asarray(db), qs, dbs, eps, t_hi,
                                              interpret=True, return_stats=True, **kw)
    np.testing.assert_array_equal(np.asarray(js), np.asarray(jbs))
    tq, tdb, tqs, tdbs = _t(q), _t(db), _t(qs), _t(dbs)
    tc, ts = thf.hamming_filter_count(tq, tdb, tqs, tdbs, eps, t_hi, return_stats=True, **kw)
    tbc, tbw, tbs = thf.hamming_filter_bitmap(tq, tdb, tqs, tdbs, eps, t_hi, return_stats=True, **kw)
    assert ts.dtype == torch.int32 and ts.shape == (1, 3)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tbs.numpy(), np.asarray(js))
    assert int(ts.sum()) == (-(-nq // q_tile) * q_tile) * (-(-nd // db_tile) * db_tile)
    # the counters change no count and no word
    oc = thf.hamming_filter_count(tq, tdb, tqs, tdbs, eps, t_hi, t_lo=t_lo)
    obc, obw = thf.hamming_filter_bitmap(tq, tdb, tqs, tdbs, eps, t_hi, t_lo=t_lo)
    assert torch.equal(tc, oc) and torch.equal(tbc, obc) and torch.equal(tbw, obw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_pad_grid_stats_complement_real_pairs():
    """The kernel's real-pair triples per chunk plus ``pad_grid_stats``
    cover the whole padded grid, chunk by chunk (one all-pad chunk)."""
    nq, nd, chunk, n_chunks, db_tile = 75, 100, 32, 4, 64
    x = _unit_clusters(3, nq + nd, 16)
    sig = sign_signatures(x, make_projection(16, 64, 3), device="cpu")
    q, db = torch.from_numpy(x[:nq]), torch.from_numpy(x[nq:])
    stats = torch.zeros((-(-nq // chunk), 3), dtype=torch.int32)
    counts = torch.zeros(nq, dtype=torch.int32)
    thf.hamming_filter_into(q, db, sig[:nq], sig[nq:], 0.5, 20, 30, counts, stats=stats, chunk_rows=chunk)
    rows = torch.tensor([32, 32, 11])
    np.testing.assert_array_equal(stats.sum(1).numpy(), (rows * nd).numpy())
    _, _, plain = hamming_filter_ref(q, db, sig[:nq], sig[nq:], 0.5, 20, 30, stats_chunk=chunk)
    assert torch.equal(stats, plain)
    pad = thf.pad_grid_stats(sig[:nq], sig[nq:], 20, 30, chunk=chunk, n_chunks=n_chunks, db_tile=db_tile)
    full = pad.clone()
    full[: stats.shape[0]] += stats
    np.testing.assert_array_equal(full.sum(1).numpy(), [chunk * 128] * n_chunks)
    # the all-pad chunk: 32 zero rows x 100 real cols + 32 x 28 pad pairs at distance 0
    assert int(pad[3, 0]) == 32 * 28 + 32 * int((popcount32(sig[nq:]).sum(1) <= 20).sum())
    with pytest.raises(ValueError):
        thf.hamming_filter_into(q, db, sig[:nq], sig[nq:], 0.5, 20, 30, counts,
                                stats=stats, chunk_rows=40)


# ---------------------------------------------------------------------------
# (b) the count sweep's per-chunk slab and sweep.tele.*
# ---------------------------------------------------------------------------

SWEEP_CFG = dict(n_bits=64, seed=2, chunk=64, chunks_per_launch=2, q_tile=32, db_tile=128)


@pytest.mark.parametrize("rows", ["all", "ragged"])
def test_sweep_slab_and_counters_match_jax(rows):
    """n 150, chunk 64, cpl 2: 3 live chunks and 1 all-pad chunk (the
    reference test's configuration); counts do not move with telemetry."""
    data, _ = make_angular_clusters(150, 16, 4, kappa=60, noise_frac=0.2, seed=2)
    idx = np.arange(150) if rows == "all" else np.arange(1, 150, 3)
    eps = 0.45
    jbk = JaxRP(device=True, interpret=True, sweep=True, **SWEEP_CFG).fit(data)
    tbk = RandomProjectionBackend(device="cpu", **SWEEP_CFG).fit(data)
    jc = np.asarray(jbk.query_counts(idx, eps))
    syncs = metrics.counter("sweep.host_syncs")
    tc = tbk.query_counts(idx, eps)
    assert syncs.value == 1
    np.testing.assert_array_equal(tc, jc)
    jslab, tslab = jdevice.last_sweep_stats(), tdevice.last_sweep_stats()
    assert tslab.shape == jslab.shape and tslab.dtype == np.int32
    np.testing.assert_array_equal(tslab, jslab)
    tsnap, jsnap = metrics.snapshot("sweep.tele."), jmetrics.snapshot("sweep.tele.")
    for i, f in enumerate(tdevice.SWEEP_STAT_FIELDS):
        assert tsnap[f"sweep.tele.{f}"] == jsnap[f"sweep.tele.{f}"] == int(tslab[:, i].sum())
    snap, jsnap = metrics.snapshot("sweep."), jmetrics.snapshot("sweep.")
    for k in ("sweep.sweeps", "sweep.launches", "sweep.slab_alloc"):
        assert snap[k] == jsnap[k], k
    assert snap["sweep.sweeps"] == snap["sweep.slab_alloc"] == 1
    tdevice.disable_device()
    np.testing.assert_array_equal(tbk.query_counts(idx, eps), tc)
    assert syncs.value == 2


# ---------------------------------------------------------------------------
# (c) the cluster fixpoint's per-round counters
# ---------------------------------------------------------------------------


def _ragged_adjacency(n, seed, density=0.012):
    rng = np.random.default_rng(seed)
    hit = rng.random((n, n)) < density
    hit = hit | hit.T
    np.fill_diagonal(hit, True)
    return hit


def test_cluster_round_counters_match_jax():
    """613 rows (ragged against words and tiles), tau 6: the four
    per-round vectors equal the reference's; frontier is counted per
    core column here and per core slab row there, equal because slab
    rows are unique."""
    n, tau = 613, 6
    hit = _ragged_adjacency(n, seed=9)
    rows = np.arange(n, dtype=np.int32)
    slab = pack_bitmap(hit)
    j = jax.device_get(jax_packed_cluster_labels(jnp.asarray(slab), jnp.asarray(rows), tau, n=n,
                                                 telemetry=True, interpret=True))
    t = packed_cluster_labels(_t(slab), torch.from_numpy(rows), tau, n=n, telemetry=True)
    assert len(t) == 6 and t[5].shape == (4, tdevice.MAX_ROUNDS) and t[5].dtype == torch.int32
    rounds = int(t[4])
    assert rounds == int(j[4]) >= 2
    for k, field in enumerate(tdevice.CLUSTER_ROUND_FIELDS):
        np.testing.assert_array_equal(t[5][k].numpy(), np.asarray(j[5][k]), err_msg=field)
        assert not t[5][k, rounds:].any(), field
    assert torch.equal(t[5][0], t[5][3])  # one device: shard wins == frontier
    off = packed_cluster_labels(_t(slab), torch.from_numpy(rows), tau, n=n, telemetry=False)
    assert len(off) == 5
    for a, b in zip(t[:5], off):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(t[0][:n].numpy(), np.asarray(j[0])[:n])
    per_round = tdevice.harvest_cluster_telemetry(t[5].numpy(), rounds)
    assert all(len(v) == rounds for v in per_round.values())
    snap = metrics.snapshot("laf.telemetry.")
    for f, vals in per_round.items():
        assert snap[f"laf.telemetry.{f}"] == sum(vals)


# ---------------------------------------------------------------------------
# (d) suggest_margin / record_occupancy / band()
# ---------------------------------------------------------------------------

OCC_CFG = dict(n_bits=64, margin=3.0, seed=3, chunk=64, q_tile=32, db_tile=64)


@pytest.fixture(scope="module")
def occ_data():
    data, _ = make_angular_clusters(613, 32, 8, kappa=120, noise_frac=0.3, seed=2)
    return data


def _band_counts(m):
    return {k: m.counter(f"index.band.{k}").value for k in BAND_FIELDS}


def test_suggest_margin_tables_match_jax(occ_data):
    """Ragged n (613 against q_tile 32 and db_tile 64): the device table
    (stats bodies + pad corrections) and the host table equal the
    reference's device and host tables, and each other in pair counts."""
    eps, rows, margins = 0.55, np.arange(0, 613, 7), (4.0, 2.5, 1.0)
    dev = RandomProjectionBackend(device="cpu", **OCC_CFG).fit(occ_data)
    host = RandomProjectionBackend(device="cpu", oracle=True, **OCC_CFG).fit(occ_data)
    jdev = JaxRP(device=True, interpret=True, **OCC_CFG).fit(occ_data)
    jhost = JaxRP(device=False, **OCC_CFG).fit(occ_data)
    got = [suggest_margin(b, eps, rows, margins=margins, report=True) for b in (dev, host)]
    want = [jax_suggest_margin(b, eps, rows, margins=margins, report=True) for b in (jdev, jhost)]
    assert got[0] == want[0] and got[1] == want[1]
    total = len(rows) * len(occ_data)
    for a, b in zip(got[0][1], got[1][1]):
        assert (a["t_lo"], a["t_hi"]) == (b["t_lo"], b["t_hi"])
        assert round(a["band_frac"] * total) == round(b["band_frac"] * total)
        assert round(a["accept_frac"] * total) == round(b["accept_frac"] * total)
    assert got[0][0] == got[1][0]


@pytest.mark.parametrize("oracle", [False, True])
def test_record_occupancy_counters_match_jax(occ_data, oracle):
    eps, rows = 0.55, np.arange(0, 613, 7)
    tbk = RandomProjectionBackend(device="cpu", oracle=oracle, **OCC_CFG).fit(occ_data)
    jbk = JaxRP(device=not oracle, interpret=True, **OCC_CFG).fit(occ_data)
    metrics.reset()
    jmetrics.reset()
    trow = record_occupancy(tbk, eps, rows)
    jrow = jax_record_occupancy(jbk, eps, rows)
    assert trow == jrow
    got, want = _band_counts(metrics), _band_counts(jmetrics)
    assert got == want and sum(got.values()) == len(rows) * len(occ_data)
    tg, jg = metrics.snapshot("index.band."), jmetrics.snapshot("index.band.")
    assert tg == jg


def test_band_records_once_per_eps(occ_data):
    bk = RandomProjectionBackend(device="cpu", **OCC_CFG).fit(occ_data)
    jbk = JaxRP(device=True, interpret=True, **OCC_CFG).fit(occ_data)
    launches = metrics.counter(thf.STATS_LAUNCHES[False])
    assert bk.band(0.55) == jbk.band(0.55)
    first = _band_counts(metrics)
    assert first == _band_counts(jmetrics) and sum(first.values()) > 0
    bk.band(0.55)  # memoized per (backend, eps)
    assert _band_counts(metrics) == first
    bk.band(0.4)
    assert sum(_band_counts(metrics).values()) > sum(first.values())
    assert launches.value == 0  # the plain version ran: a CPU tensor launches nothing
    metrics.disable()
    fresh = RandomProjectionBackend(device="cpu", **OCC_CFG).fit(occ_data)
    fresh.band(0.55)
    assert not fresh._occ_recorded  # metrics off: no measurement at all


# ---------------------------------------------------------------------------
# (e) one host copy per pass with trace, metrics and telemetry all on
# ---------------------------------------------------------------------------


def test_one_copy_with_everything_on():
    data, _ = make_angular_clusters(500, 16, 6, kappa=60, noise_frac=0.25, seed=7)
    pred = np.random.default_rng(1).uniform(0, 15, len(data))
    bk = RandomProjectionBackend(n_bits=128, seed=1, chunk=64, device="cpu")
    res = laf_dbscan(data, 0.45, 4, 1.2, pred, backend=bk, cluster_device=True)
    snap = metrics.snapshot()
    assert snap["laf.cluster.host_syncs"] == 1
    rounds = snap["laf.cluster.last_rounds"]
    assert rounds >= 1 and snap["laf.cluster.rounds"] == rounds
    spans = {r.span_id: r for r in obs.spans()}
    (lp,) = obs.spans("laf.label_prop")
    round_spans = [r for r in spans.values() if r.name == "laf.cluster.round"]
    assert len(round_spans) == rounds and all(r.parent_id == lp.span_id for r in round_spans)
    for f in tdevice.CLUSTER_ROUND_FIELDS:
        assert snap[f"laf.telemetry.{f}"] == sum(r.attrs[f] for r in round_spans)
    (cl,) = obs.spans("laf.cluster")
    assert {spans[r.parent_id].name for r in obs.spans("laf.sweep")} == {"laf.pass1"}
    assert {r.name for r in spans.values() if r.parent_id == cl.span_id} >= {
        "laf.fit_index", "laf.pass1", "laf.label_prop", "laf.postprocess"}
    # telemetry and tracing are observers: the labels are the plain run's
    obs.disable()
    plain = laf_dbscan(data, 0.45, 4, 1.2, pred, backend=bk, cluster_device=True)
    np.testing.assert_array_equal(res.labels, plain.labels)
    np.testing.assert_array_equal(res.core, plain.core)
    obs.enable(trace=True, metrics_on=True, telemetry=True)
    metrics.reset()
    bk.query_counts(np.arange(0, 500, 2), 0.45)
    assert metrics.snapshot("sweep.host_syncs")["sweep.host_syncs"] == 1


# ---------------------------------------------------------------------------
# the stats bodies on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nd,chunk,t_lo", [
    (70, 301, 64, -1), (333, 1000, 128, 40), (5, 40, 5, 20),
    # the kernel's blocks are 128 query rows: chunks of 32, 96 and 160
    # split a block's triple, and 129 or 257 rows leave a ragged block
    (257, 129, 32, 30), (129, 257, 96, -1), (300, 31, 160, 45), (129, 1, 129, 40),
])
def test_gpu_stats_bodies_match_plain(nq, nd, chunk, t_lo):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    x = _unit_clusters(nq, nq + nd, 32)
    sig = sign_signatures(x, make_projection(32, 128, 0), device=dev)
    q, db = torch.from_numpy(x[:nq]).to(dev), torch.from_numpy(x[nq:]).to(dev)
    qs, dbs = sig[:nq].contiguous(), sig[nq:].contiguous()
    eps, t_hi = 0.5, 70
    plain = hamming_filter_ref(q, db, qs, dbs, eps, t_lo, t_hi, stats_chunk=chunk)
    for bitmap in (False, True):
        launches = metrics.counter(thf.STATS_LAUNCHES[bitmap])
        before = launches.value
        counts = torch.zeros(nq, dtype=torch.int32, device=dev)
        words = torch.zeros((nq, -(-nd // 32)), dtype=torch.int32, device=dev) if bitmap else None
        stats = torch.zeros((-(-nq // chunk), 3), dtype=torch.int32, device=dev)
        thf.hamming_filter_into(q, db, qs, dbs, eps, t_lo, t_hi, counts, words,
                                stats=stats, chunk_rows=chunk)
        torch.cuda.synchronize()
        assert launches.value == before + 1
        assert torch.equal(stats, plain[2])  # the split reads Hamming distances only
        twin = thf.hamming_filter_bitmap(q, db, qs, dbs, eps, t_hi, t_lo=t_lo)
        assert torch.equal(counts, twin[0])
        if bitmap:
            assert torch.equal(words, twin[1])
