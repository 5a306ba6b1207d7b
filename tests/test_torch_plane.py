"""The sharded index plane (``repro_torch.distributed``) on gloo, held to
the JAX package's single-device results.

Each world (1, 2 and 4 ranks on a ``data`` axis, and a (pod 2, data 2)
mesh sharded over both axes) is one spawn of CPU ranks
(``repro_torch.testing.ranks``) that runs every check's port side once;
the tests below read its results.  The JAX side runs its kernels in
interpret mode on one device, as its own tests run them.  The reference's
multi-device runs are not used as oracles (ROADMAP C4).

The database has 1,000 rows (not a multiple of 32 x world), d 64, 128
bits, a db tile of 64: plane padding and its count correction are on
every call, and the eps > 1 corner (zero rows pass the dot test) is
checked.  Counts and marginals must be equal and bitmaps byte-equal;
signatures are the JAX package's where a function takes them, and the
port's own (held equal to the JAX package's) behind the backend.  The
LAF-DBSCAN runs use the JAX estimator's predictions; hit bits may differ
only for pairs within ``2 (d - 1) 2**-24`` of the threshold, which are
counted (with none, labels, core mask and ``n_range_queries`` must be
identical).

The per-round cluster telemetry follows the reference's contract: the
frontier, changed and hops rows equal the single-device run's, and the
shard wins (each rank's gather beating the label, summed over ranks)
equal the frontier on one rank and are at least it on several.

This module imports no JAX at import time: its rank bodies run in
spawned children that import it.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.testing.ranks import run_ranks

N, N_APPEND, D, BITS = 1000, 200, 64, 128
Q_TILE, DB_TILE, CHUNK, CPL = 32, 64, 64, 2
EPS, EPS_WIDE, TAU, ALPHA = 0.55, 1.2, 5, 1.5
NQ = 96  # the one-call evaluators' queries: 3 chunks of 32
BK = dict(n_bits=BITS, seed=3, chunk=CHUNK, q_tile=Q_TILE, db_tile=DB_TILE, chunks_per_launch=CPL)
WORLDS = {  # name -> (mesh shape, axis names, sharded axes)
    "w1": ((1,), ("data",), ("data",)),
    "w2": ((2,), ("data",), ("data",)),
    "w4": ((4,), ("data",), ("data",)),
    "pod2x2": ((2, 2), ("pod", "data"), ("pod", "data")),
}
FLIP_BOUND = 2 * (D - 1) * 2.0 ** -24


# ---------------------------------------------------------------------------
# the rank body: every check's port side, once a world
# ---------------------------------------------------------------------------


def _rank_body(rank, world, shape, names, axes, p):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.laf_dbscan import laf_dbscan
    from repro_torch.distributed import index_plane as ip
    from repro_torch.distributed.sharding import plane_axes
    from repro_torch.index.random_projection import RandomProjectionBackend
    from repro_torch.kernels.label_prop import packed_cluster_fixpoint
    from repro_torch.obs import device as obs_device
    from repro_torch.obs import metrics
    from repro_torch.testing import faults

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    ax = plane_axes(mesh, axes)
    # every tensor that crosses ranks, by dtype
    crossed = set()
    real = dist.all_reduce, dist.all_gather

    def all_reduce(t, *a, **k):
        crossed.add(str(t.dtype))
        return real[0](t, *a, **k)

    def all_gather(parts, t, *a, **k):
        crossed.add(str(t.dtype))
        return real[1](parts, t, *a, **k)

    dist.all_reduce, dist.all_gather = all_reduce, all_gather
    metrics.enable()
    out = {"index": ax.index, "size": ax.size}
    plan = ip.shard_plan(mesh, N, axes, tile=DB_TILE)
    out["plan"] = dataclasses.astuple(plan)

    data = torch.from_numpy(p["data"])
    sigs = torch.from_numpy(p["sigs"].view(np.int32))
    q, qs = data[:NQ], sigs[:NQ]
    for eps, (t_lo, t_hi) in p["bands"].items():
        kw = dict(mesh=mesh, t_lo=t_lo, axes=axes)
        c = ip.sharded_hamming_count(q, data, qs, sigs, eps, t_hi, **kw)
        c2, bm = ip.sharded_hamming_bitmap(q, data, qs, sigs, eps, t_hi, **kw)
        cm, part = ip.sharded_band_marginals(q, data, qs, sigs, eps, t_hi, **kw)
        cs, ps = ip.sharded_sweep_marginals(q.view(3, NQ // 3, D), data, qs.view(3, NQ // 3, -1), sigs, eps, t_hi,
                                            db_tile=DB_TILE, **kw)
        out[("one_call", eps)] = dict(count=c.numpy(), count2=c2.numpy(), bitmap=bm.numpy(), mcount=cm.numpy(),
                                      partial=part.numpy(), scount=cs.numpy(), spartial=ps.numpy())

    for depth in (1, 2):
        before = metrics.snapshot()
        bk = RandomProjectionBackend(**BK, device="cpu", mesh=mesh, mesh_axes=axes, pipeline_depth=depth)
        bk.fit(p["data"])
        obs_device.enable_device()
        counts = bk.query_counts(p["rows"], EPS)
        tele = obs_device.last_sweep_stats().copy()
        cb = bk.query_hits_packed(p["rows"], EPS)
        slab, _ = bk.query_bitmap_device(p["rows"], EPS)
        btele = obs_device.take_deferred_sweep_stats()
        obs_device.disable_device()
        sigs_fit = bk.signatures.copy()
        bk.partial_fit(p["extra"])
        counts2 = bk.query_counts(p["rows2"], EPS)
        cb2 = bk.query_hits_packed(p["rows2"], EPS)
        slab2, _ = bk.query_bitmap_device(p["rows2"], EPS)
        after = metrics.snapshot()
        chunks = {k: after.get(f"plane.chunks.{k}", 0) - before.get(f"plane.chunks.{k}", 0)
                  for k in ("pipelined", "serialized")}
        out[("sweep", depth)] = dict(
            counts=counts, tele=tele, cb=cb, slab=slab.numpy(), btele=None if btele is None else btele.numpy(),
            counts2=counts2, cb2=cb2, slab2=slab2.numpy(), chunks=chunks,
            sigs=np.concatenate([sigs_fit, bk.signatures[N:]]), n_local=bk._db_plane.shape[0])

    for name, (slab, rows, n, tau, max_iters) in p["slabs"].items():
        w_loc = slab.shape[1] // ax.size
        local = torch.from_numpy(np.ascontiguousarray(slab[:, ax.index * w_loc : (ax.index + 1) * w_loc]))
        res = packed_cluster_fixpoint(local, torch.from_numpy(rows), tau, n=n, cap=slab.shape[1] * 32,
                                      max_iters=max_iters, telemetry=True, col_off=ax.index * w_loc * 32,
                                      group=ax.group)
        full = ip.sharded_cluster_labels(local, rows, tau, mesh=mesh, axes=axes, n=n, max_iters=max_iters,
                                         telemetry=True)
        out[("fixpoint", name)] = dict(
            labels=res[0].numpy(), owner=res[1].numpy(), col_sum=res[2].numpy(), counts=res[3].numpy(),
            rounds=int(res[4]), tele=res[5].numpy(), full=[t.numpy() for t in full])

    syncs = metrics.counter("laf.cluster.host_syncs")
    bk = RandomProjectionBackend(**BK, device="cpu", mesh=mesh, mesh_axes=axes)
    s0 = syncs.value
    res = laf_dbscan(p["data"], EPS, TAU, ALPHA, p["pred"], backend=bk)
    s1 = syncs.value
    obs_device.enable_device()
    res_t = laf_dbscan(p["data"], EPS, TAU, ALPHA, p["pred"], backend=bk)
    obs_device.disable_device()
    s2 = syncs.value
    hits = bk.query_hits(np.nonzero(p["pred"] >= ALPHA * TAU)[0], EPS)  # a collective: every rank calls it
    out["laf"] = dict(labels=res.labels, core=res.core, n_range_queries=res.n_range_queries, extras=res.extras,
                      labels_t=res_t.labels, core_t=res_t.core, syncs=(s1 - s0, s2 - s1),
                      hits=hits if rank == 0 else None)

    from repro_torch.index.random_projection import suggest_margin

    host = RandomProjectionBackend(**BK, device="cpu", oracle=True).fit(p["data"])
    out["margins"] = (suggest_margin(bk, EPS, report=True), suggest_margin(host, EPS, report=True))

    try:
        ip.plane_collective("sum", torch.zeros(3), ax.group)
        out["refuses_float32"] = False
    except TypeError:
        out["refuses_float32"] = True

    with faults.inject("seed=5,plane.launch=1.0:1"):
        try:
            bk.query_counts(p["rows"], EPS)
            raised = False
        except faults.InjectedFault:
            raised = True
        after_fault = bk.query_counts(p["rows"], EPS)  # the plan's one fault is spent
    peers = torch.ones(1, dtype=torch.int32)
    dist.all_reduce(peers)  # every rank got here: none waits in a collective
    out["fault"] = dict(raised=raised, after=after_fault, peers=int(peers[0]))
    out["crossed"] = sorted(crossed)
    out["counters"] = {k: v for k, v in metrics.snapshot().items() if k.startswith("plane.")}
    dist.all_reduce, dist.all_gather = real
    return out


# ---------------------------------------------------------------------------
# the JAX side, once a module
# ---------------------------------------------------------------------------


def _chain_slab(n=613, seed=4, rows_pad=27):
    """A random path over n nodes (every node core at tau 2): min
    propagation needs several rounds.  Words padded to a multiple of 4
    shards, rows padded with sentinel rows."""
    from repro_torch.core.range_query import pack_bitmap

    perm = np.random.default_rng(seed).permutation(n)
    hit = np.eye(n, dtype=bool)
    hit[perm[:-1], perm[1:]] = hit[perm[1:], perm[:-1]] = True
    words = pack_bitmap(hit)
    words = np.pad(words, ((0, rows_pad), (0, (-words.shape[1]) % 4)))
    rows = np.full(n + rows_pad, n, np.int32)
    rows[:n] = np.arange(n)
    return words.view(np.int32), rows


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core.cardinality.features import build_training_set
    from repro.core.cardinality.training import train_rmi
    from repro.core.laf_dbscan import laf_dbscan as jax_laf_dbscan
    from repro.data.synthetic import make_angular_clusters
    from repro.index.random_projection import RandomProjectionBackend as JaxRP
    from repro.kernels.hamming_filter.ops import hamming_filter_bitmap
    from repro.kernels.label_prop import packed_cluster_labels
    from repro.obs import device as jax_obs_device

    full, _ = make_angular_clusters(N + N_APPEND, D, 8, kappa=120, noise_frac=0.3, seed=2)
    data, extra = full[:N], full[N:]
    jbk = JaxRP(**BK, device=True, interpret=True).fit(data)
    sigs = np.array(jbk.signatures)
    bands = {eps: tuple(int(t) for t in jbk.band(eps)) for eps in (EPS, EPS_WIDE)}
    one_call = {}
    for eps, (t_lo, t_hi) in bands.items():
        c, bm = hamming_filter_bitmap(data[:NQ], data, sigs[:NQ], sigs, eps, t_hi, t_lo=t_lo,
                                      q_tile=Q_TILE, db_tile=DB_TILE, interpret=True)
        one_call[eps] = (np.asarray(c), np.asarray(bm))
    rows, rows2 = np.arange(0, N, 3), np.arange(1, N + N_APPEND, 4)
    was = jax_obs_device.device_enabled()
    jax_obs_device.enable_device()
    try:
        counts = jbk.query_counts(rows, EPS)
        tele = np.array(jax_obs_device.last_sweep_stats())
    finally:
        if not was:
            jax_obs_device.disable_device()
    cb = jbk.query_hits_packed(rows, EPS)
    jbk.partial_fit(extra)
    counts2, cb2 = jbk.query_counts(rows2, EPS), jbk.query_hits_packed(rows2, EPS)
    sigs_all = np.array(jbk.signatures)

    chain, chain_rows = _chain_slab()
    slabs = {"converges": (chain, chain_rows, 613, 2, 64), "max_iters": (chain, chain_rows, 613, 2, 3)}
    fix = {}
    for name, (slab, srows, n, tau, max_iters) in slabs.items():
        o = packed_cluster_labels(jnp.asarray(slab.view(np.uint32)), jnp.asarray(srows), tau, n=n,
                                  max_iters=max_iters, telemetry=True, interpret=True)
        fix[name] = [np.asarray(t) for t in o[:5]] + [np.stack([np.asarray(v) for v in o[5]])]

    feats, targets = build_training_set(data, (0.5, 0.6))
    est = train_rmi(data, epochs=3, batch_size=128, lr=1e-2, seed=0, feats_targets=(feats, targets))
    pred = np.asarray(est.predict_counts(data, EPS, reference_n=N), dtype=np.float64)
    lbk = JaxRP(**BK, device=True, interpret=True)
    want = jax_laf_dbscan(data, EPS, TAU, ALPHA, pred, backend=lbk, cluster_device="auto")
    exec_idx = np.nonzero(pred >= ALPHA * TAU)[0]
    payload = dict(data=data, extra=extra, sigs=sigs, bands=bands, rows=rows, rows2=rows2, slabs=slabs, pred=pred)
    return SimpleNamespace(
        payload=payload, one_call=one_call, counts=counts, tele=tele, cb=cb, counts2=counts2, cb2=cb2,
        sigs_all=sigs_all, fix=fix, laf=want, laf_hits=lbk.query_hits(exec_idx, EPS), exec_idx=exec_idx)


_RESULTS = {}


@pytest.fixture
def ranks(ref, request):
    """Every rank's results of one world, spawned once a module."""
    name = request.param
    if name not in _RESULTS:
        shape, names, axes = WORLDS[name]
        _RESULTS[name] = run_ranks(_rank_body, int(np.prod(shape)), shape, names, axes, ref.payload,
                                   timeout=150, threads=1)
    return _RESULTS[name]


def _world(fn):
    return pytest.mark.parametrize("ranks", list(WORLDS), indirect=True)(fn)


def _cat(outs, key, field):
    """Rank-local arrays concatenated in shard order on their last axis."""
    by_shard = sorted(outs, key=lambda o: o["index"])
    return np.concatenate([o[key][field] if key else o[field] for o in by_shard], axis=-1)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,names,axes,n,tile", [
    ((1,), ("data",), None, 613, 32), ((4,), ("data",), None, 613, 64), ((2, 2), ("pod", "data"), None, 1000, 64),
    ((2, 2), ("pod", "data"), ("data",), 1000, 256), ((2, 3), ("data", "model"), ("data", "model"), 6001, 32),
    ((3, 2), ("data", "model"), None, 31, 128),
])
def test_shard_plan_matches_reference(shape, names, axes, n, tile):
    """``shard_plan`` on a stand-in mesh (names and sizes only) against the
    reference's on its JAX-shaped stand-in."""
    pytest.importorskip("jax")
    from repro.distributed.index_plane import shard_plan as jax_shard_plan

    from repro_torch.distributed.index_plane import shard_plan
    from repro_torch.distributed.sharding import axis_size, data_axes

    tmesh = SimpleNamespace(mesh_dim_names=names, shape=shape)
    jmesh = SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
    got, want = shard_plan(tmesh, n, axes, tile=tile), jax_shard_plan(jmesh, n, axes, tile=tile)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert (got.n_local, got.n_pad) == (want.n_local, want.n_pad)
    assert data_axes(tmesh) == (("pod", "data") if "pod" in names else ("data",))
    assert axis_size(tmesh, got.axes) == got.n_shards


@_world
def test_plan_and_shard_index(ranks):
    assert sorted(o["index"] for o in ranks) == list(range(len(ranks)))
    assert len({o["plan"] for o in ranks}) == 1
    axes, n_shards, n, n_padded = ranks[0]["plan"]
    assert n_shards == len(ranks) and n == N and n_padded % (DB_TILE * n_shards) == 0 and n_padded >= N


# ---------------------------------------------------------------------------
# the one-call evaluators
# ---------------------------------------------------------------------------


@_world
@pytest.mark.parametrize("eps", [EPS, EPS_WIDE])
def test_one_call_evaluators_match_single_device(ranks, ref, eps):
    want_c, want_bm = ref.one_call[eps]
    hits = np.unpackbits(want_bm.view(np.uint8), axis=1, bitorder="little")[:, :N].astype(bool)
    if eps > 1:  # the corner where zero rows pass the dot test
        assert (hits.sum(axis=1) == want_c).all() and want_c.min() > 0
    for o in ranks:
        got = o[("one_call", eps)]
        np.testing.assert_array_equal(got["count"], want_c)
        np.testing.assert_array_equal(got["count2"], want_c)
        assert got["bitmap"].view(np.uint32).tobytes() == want_bm.tobytes()
        np.testing.assert_array_equal(got["mcount"], hits.sum(axis=1))
        np.testing.assert_array_equal(got["scount"].reshape(-1), hits.sum(axis=1))
    partial = _cat(ranks, ("one_call", eps), "partial")
    np.testing.assert_array_equal(partial[:N], hits.sum(axis=0))
    assert not partial[N:].any()  # plane padding never counts
    np.testing.assert_array_equal(_cat(ranks, ("one_call", eps), "spartial")[:N], hits.sum(axis=0))


# ---------------------------------------------------------------------------
# the sweeps: depth 1 and 2, before and after an append
# ---------------------------------------------------------------------------


@_world
@pytest.mark.parametrize("depth", [1, 2])
def test_sweeps_match_single_device(ranks, ref, depth):
    words = -(-N // 32)
    for o in ranks:
        got = o[("sweep", depth)]
        np.testing.assert_array_equal(got["sigs"], ref.sigs_all)
        np.testing.assert_array_equal(got["counts"], ref.counts)
        np.testing.assert_array_equal(got["cb"][0], ref.cb[0])
        assert got["cb"][1].tobytes() == np.asarray(ref.cb[1]).tobytes()
        np.testing.assert_array_equal(got["counts2"], ref.counts2)
        np.testing.assert_array_equal(got["cb2"][0], ref.cb2[0])
        assert got["cb2"][1].tobytes() == np.asarray(ref.cb2[1]).tobytes()
        # the count sweep's occupancy, summed over the ranks, is the
        # single-device grid's (both pad the database to 1,024 rows)
        np.testing.assert_array_equal(got["tele"], ref.tele)
        np.testing.assert_array_equal(got["btele"], ref.tele)
        if len(ranks) > 1:
            assert got["chunks"]["pipelined" if depth == 2 else "serialized"] > 0
            assert got["chunks"]["serialized" if depth == 2 else "pipelined"] == 0
    # the rank-local device slabs, concatenated in shard order, are the
    # single-device bitmap (plus zero words of plane padding)
    for slab_key, rows, cb in (("slab", ref.payload["rows"], ref.cb), ("slab2", ref.payload["rows2"], ref.cb2)):
        slab = _cat(ranks, ("sweep", depth), slab_key)
        want = np.asarray(cb[1]).view(np.int32)
        n_words = want.shape[1]
        assert slab[: len(rows), :n_words].tobytes() == want.tobytes()
        assert not slab[len(rows):].any() and not slab[:, n_words:].any()
    assert _cat(ranks, ("sweep", depth), "slab").shape[1] * 32 >= words * 32


# ---------------------------------------------------------------------------
# the sharded cluster fixpoint
# ---------------------------------------------------------------------------


@_world
@pytest.mark.parametrize("slab", ["converges", "max_iters"])
def test_cluster_fixpoint_matches_single_device(ranks, ref, slab):
    labels, owner, col_sum, counts, rounds, tele = ref.fix[slab]
    n, max_iters = ref.payload["slabs"][slab][2], ref.payload["slabs"][slab][4]
    assert int(rounds) >= 3
    if slab == "max_iters":
        assert int(rounds) == max_iters and ref.fix["converges"][4] > max_iters
    for o in ranks:
        got = o[("fixpoint", slab)]
        assert got["rounds"] == int(rounds)
        np.testing.assert_array_equal(got["labels"][:n], labels[:n])
        np.testing.assert_array_equal(got["counts"], counts[: len(got["counts"])])
        np.testing.assert_array_equal(got["tele"][:3], tele[:3])
        if len(ranks) == 1:
            np.testing.assert_array_equal(got["tele"][3], tele[3])
        else:
            assert (got["tele"][3] >= got["tele"][0]).all()
        np.testing.assert_array_equal(tele[3], tele[0])  # one device: wins are the frontier
        full = got["full"]
        np.testing.assert_array_equal(full[0][:n], labels[:n])
        np.testing.assert_array_equal(full[1][:n], owner[:n])
        np.testing.assert_array_equal(full[2][:n], col_sum[:n])
        np.testing.assert_array_equal(full[5], got["tele"])
    np.testing.assert_array_equal(_cat(ranks, ("fixpoint", slab), "owner")[:n], owner[:n])
    np.testing.assert_array_equal(_cat(ranks, ("fixpoint", slab), "col_sum")[:n], col_sum[:n])


# ---------------------------------------------------------------------------
# LAF-DBSCAN through a mesh backend
# ---------------------------------------------------------------------------


@_world
def test_laf_dbscan_matches_single_device(ranks, ref):
    want = ref.laf
    hits = ranks[0]["laf"]["hits"]
    pi, pj = np.nonzero(hits != ref.laf_hits)
    rows = ref.exec_idx[pi]
    data = ref.payload["data"].astype(np.float64)
    margins = np.abs((data[rows] * data[pj]).sum(axis=1) - (1 - EPS))
    print(f"{len(pi)} boundary pairs differ from the JAX run (max margin {margins.max(initial=0):.2e})")
    assert (margins <= FLIP_BOUND).all()
    assert 0 < want.extras["n_predicted_core"] < N
    for o in ranks:
        got = o["laf"]
        if len(pi) == 0:
            np.testing.assert_array_equal(got["labels"], want.labels)
            np.testing.assert_array_equal(got["core"], want.core)
            assert got["n_range_queries"] == want.n_range_queries
            assert got["extras"] == want.extras
        np.testing.assert_array_equal(got["labels_t"], got["labels"])  # telemetry moves nothing
        np.testing.assert_array_equal(got["core_t"], got["core"])
        np.testing.assert_array_equal(got["labels"], ranks[0]["laf"]["labels"])


@_world
def test_suggest_margin_on_the_plane_matches_the_host_table(ranks):
    """The band's occupancy priced on the plane (each rank's block, the
    triples summed) equals the host oracle's table of real pairs."""
    for o in ranks:
        plane, host = o["margins"]
        assert plane == host


@_world
def test_one_host_sync_a_clustering_on_every_rank(ranks):
    for o in ranks:
        assert o["laf"]["syncs"] == (1, 1)


# ---------------------------------------------------------------------------
# what crosses ranks, and faults
# ---------------------------------------------------------------------------


@_world
def test_only_int32_crosses_ranks(ranks):
    for o in ranks:
        assert o["refuses_float32"]
        assert o["crossed"] == ["torch.int32"]
        c = o["counters"]
        if len(ranks) == 1:
            assert not any(c.values())  # a one-rank plane issues nothing
        else:
            assert c["plane.psum.calls"] > 0 and c["plane.pmin.calls"] > 0 and c["plane.gather.calls"] > 0
            assert c["plane.psum.bytes"] > 0 and c["plane.gather.bytes"] > 0


@_world
def test_plane_launch_fault_raises_on_every_rank(ranks, ref):
    for o in ranks:
        assert o["fault"]["raised"] and o["fault"]["peers"] == len(ranks)
        np.testing.assert_array_equal(o["fault"]["after"], ref.counts)


def test_a_failing_rank_fails_the_launch():
    """A rank that raises makes ``run_ranks`` raise with its traceback,
    within the deadline, while its peer waits in a collective."""
    from repro_torch.testing.ranks import RanksFailed

    with pytest.raises(RanksFailed, match="rank 1 raises"):
        run_ranks(_raise_on_rank_1, 2, timeout=60, threads=1)


def _raise_on_rank_1(rank, world):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 raises")
    dist.barrier()
