"""The exact path of the port against the JAX package: DBSCAN (sequential
and batch), DBSCAN++ (uniform and k-center samples), LAF-DBSCAN++,
exact-backend LAF-DBSCAN through both cluster passes, and
``LAFPipeline``'s four ``cluster_*`` methods with the JAX estimator's
weights carried across (``rmi_from_jax``).  Inputs are made with numpy
from a seed and handed to both packages; the port runs with
``device="cpu"`` (the ``range_count`` kernel's plain version).

Tolerance, as in ``test_torch_laf.py``: hit bits may differ only for
pairs within the fp32 summation-order bound of the threshold
(``2 (d - 1) 2**-24``); they are counted and reported.  With no such
pair, labels, core masks, ``n_range_queries`` and extras must be
identical; otherwise the ARI must be at least 0.99.
"""

import dataclasses
import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import dbscan as jdb
from repro.core import dbscan_pp as jpp
from repro.core.laf_dbscan import laf_dbscan as jax_laf_dbscan
from repro.core import pipeline as jpipe
from repro.core.metrics import adjusted_rand_index
from repro.core.range_query import neighbor_lists as jax_neighbor_lists
from repro.data import synthetic as jsyn
from repro.index.exact import ExactBackend as JaxExact

from repro_torch.core import dbscan as tdb
from repro_torch.core import dbscan_pp as tpp
from repro_torch.core import laf_dbscan as tlaf
from repro_torch.core import pipeline as tpipe
from repro_torch.core.cardinality import rmi as trmi
from repro_torch.core.cardinality.training import TrainedEstimator
from repro_torch.index.exact import ExactBackend
from repro_torch.obs import metrics

EPS, TAU, ALPHA = 0.35, 4, 1.2


@pytest.fixture
def metrics_on():
    """Counters record only while metrics are on (off by default, as in
    the reference); the switch is process-global, so it is put back."""
    was = metrics.enabled()
    metrics.enable()
    yield metrics
    if not was:
        metrics.disable()


@pytest.fixture(scope="module")
def data():
    x, _ = jsyn.make_angular_clusters(500, 16, 6, kappa=60, noise_frac=0.25, seed=7)
    return x


def _boundary(x, eps):
    """Pairs on which the two packages' exact range queries disagree: hit
    bits of the port's kernel path vs the reference's numpy hits, plus
    the reference's own jnp-count vs numpy-hit disagreements (its
    ``query_counts`` and ``query_hits`` take different fp32 sums).  Each
    must lie within the summation-order bound of the threshold."""
    n = len(x)
    jbk, tbk = JaxExact().fit(x), ExactBackend(device="cpu").fit(x)
    jh, th = jbk.query_hits(np.arange(n), eps), tbk.query_hits(np.arange(n), eps)
    pi, pj = np.nonzero(jh != th)
    dots = (x[pi].astype(np.float64) * x[pj].astype(np.float64)).sum(1)
    assert (np.abs(dots - (1 - eps)) <= 2 * (x.shape[1] - 1) * 2.0 ** -24).all()
    own = int(np.abs(jbk.query_counts(np.arange(n), eps) - jh.sum(1)).sum())
    print(f"{len(pi)} boundary pairs differ, {own} reference count/hit disagreements")
    return len(pi) + own


def _same(got, want, n_boundary, *, extras=True):
    if n_boundary == 0:
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.core, want.core)
        assert got.n_clusters == want.n_clusters
        assert got.n_range_queries == want.n_range_queries
        if extras:
            assert got.extras == want.extras
    else:
        assert adjusted_rand_index(got.labels, want.labels) >= 0.99


@pytest.fixture(scope="module")
def n_boundary(data):
    return _boundary(data, EPS)


def test_dbscan_sequential_matches_jax():
    x, _ = jsyn.make_angular_clusters(150, 8, 3, kappa=40, noise_frac=0.2, seed=4)
    want = jdb.dbscan_sequential(x, 0.5, 3)
    got = tdb.dbscan_sequential(x, 0.5, 3, device="cpu")
    _same(got, want, _boundary(x, 0.5))
    # the loop reads whatever lists it is given, as the reference's does
    given = tdb.dbscan_sequential(x, 0.5, 3, precomputed_neighbors=jax_neighbor_lists(x, 0.5))
    np.testing.assert_array_equal(given.labels, want.labels)
    assert given.n_range_queries == want.n_range_queries == len(x)


def test_dbscan_parallel_matches_jax(data, n_boundary, metrics_on):
    want = jdb.dbscan_parallel(data, EPS, TAU)
    got = tdb.dbscan_parallel(data, EPS, TAU, device="cpu", block_size=128)
    assert want.n_clusters >= 2
    _same(got, want, n_boundary)
    gauges = metrics.snapshot("dbscan.phase.")
    assert all(gauges[f"dbscan.phase.{k}_s"] >= 0 for k in ("fit_index", "core_counts", "components"))


@pytest.mark.parametrize("init", ["uniform", "kcenter"])
def test_dbscan_pp_matches_jax(data, n_boundary, init):
    want = jpp.dbscan_pp(data, EPS, TAU, 0.5, init=init, seed=3)
    got = tpp.dbscan_pp(data, EPS, TAU, 0.5, init=init, seed=3, device="cpu", block_size=128)
    if init == "kcenter":
        np.testing.assert_array_equal(tpp.kcenter_sample(data, 60, 3, device="cpu"),
                                      jpp.kcenter_sample(data, 60, 3))
    _same(got, want, n_boundary)


def test_laf_dbscan_pp_matches_jax(data, n_boundary):
    pred = np.random.default_rng(5).uniform(0, 3 * TAU, len(data))
    p = jpp.auto_sample_fraction(pred, TAU, 1.0)
    assert p == tpp.auto_sample_fraction(pred, TAU, 1.0)
    m = max(1, int(round(p * len(data))))
    sample = np.sort(np.random.default_rng(0).choice(len(data), size=m, replace=False))
    want = jpp.laf_dbscan_pp(data, EPS, TAU, p, pred[sample], sample_idx=sample)
    got = tpp.laf_dbscan_pp(data, EPS, TAU, p, pred[sample], sample_idx=sample, device="cpu")
    assert 0 < want.extras["n_skipped"] < m
    _same(got, want, n_boundary)
    drawn_j = jpp.laf_dbscan_pp(data, EPS, TAU, 0.4, pred[:200], seed=2)
    drawn_t = tpp.laf_dbscan_pp(data, EPS, TAU, 0.4, pred[:200], seed=2, device="cpu")
    _same(drawn_t, drawn_j, n_boundary)


@pytest.mark.parametrize("cluster_device", ["auto", True])
def test_laf_dbscan_exact_matches_jax(data, n_boundary, cluster_device, metrics_on):
    pred = np.random.default_rng(1).uniform(0, 3 * ALPHA * TAU, len(data))
    want = jax_laf_dbscan(data, EPS, TAU, ALPHA, pred, backend="exact", cluster_device=cluster_device)
    syncs = metrics.counter("laf.cluster.host_syncs")
    before = syncs.value
    got = tlaf.laf_dbscan(data, EPS, TAU, ALPHA, pred, backend="exact", device="cpu",
                          cluster_device=cluster_device)
    # "auto" on the exact backend is the host union-find pass, as in the reference
    assert syncs.value - before == (1 if cluster_device is True else 0)
    assert 0 < want.extras["n_predicted_core"] < len(data) and want.extras["n_rescued"] > 0
    _same(got, want, n_boundary)


def test_default_backend_is_exact_as_in_reference(data, n_boundary):
    """The repaired defaults: both packages' engines and pipelines take
    the exact backend when none is named, and give the same labels."""
    for t_fn, j_fn in [(tlaf.laf_dbscan, jax_laf_dbscan), (tdb.dbscan_parallel, jdb.dbscan_parallel),
                       (tpp.dbscan_pp, jpp.dbscan_pp), (tpp.laf_dbscan_pp, jpp.laf_dbscan_pp),
                       (tpipe.LAFPipeline, jpipe.LAFPipeline)]:
        t_default = inspect.signature(t_fn).parameters["backend"].default
        assert t_default == inspect.signature(j_fn).parameters["backend"].default == "exact"
    assert tpipe.LAFPipeline(device="cpu").backend == "exact"
    pred = np.random.default_rng(2).uniform(0, 3 * ALPHA * TAU, len(data))
    want = jax_laf_dbscan(data, EPS, TAU, ALPHA, pred)
    got = tlaf.laf_dbscan(data, EPS, TAU, ALPHA, pred, device="cpu")
    if n_boundary == 0:
        np.testing.assert_array_equal(got.labels, want.labels)
    _same(got, want, n_boundary)


def test_dbscan_parallel_equals_every_point_core_device_pass(data):
    """The check ``chip_smoke.py`` runs at full size: exact DBSCAN equals
    LAF-DBSCAN with every point predicted core through the packed
    device pass, label for label."""
    truth = tdb.dbscan_parallel(data, EPS, TAU, device="cpu")
    every = tlaf.laf_dbscan(data, EPS, TAU, ALPHA, np.full(len(data), np.inf), device="cpu",
                            cluster_device=True)
    host = tlaf.laf_dbscan(data, EPS, TAU, ALPHA, np.full(len(data), np.inf), device="cpu",
                           cluster_device=False)
    for other in (every, host):
        np.testing.assert_array_equal(truth.labels, other.labels)
        np.testing.assert_array_equal(truth.core, other.core)
    assert every.n_range_queries == truth.n_range_queries == len(data)


@pytest.fixture(scope="module")
def pipelines():
    """A JAX pipeline with a trained estimator, and the port's pipeline
    holding the same weights."""
    x, _ = jsyn.make_angular_clusters(600, 16, 6, kappa=60, noise_frac=0.25, seed=7)
    jp = jpipe.LAFPipeline(eps_grid=(0.3, 0.4), epochs=4, batch_size=64, seed=0)
    test = jp.fit_split(x)
    jest = jp.estimator
    cfg = trmi.RMIConfig(**{f.name: getattr(jest.cfg, f.name) for f in dataclasses.fields(trmi.RMIConfig)})
    model = trmi.rmi_from_jax(jax.tree_util.tree_map(np.asarray, jest.params), cfg, device="cpu")
    tp = tpipe.LAFPipeline(eps_grid=(0.3, 0.4), seed=0, device="cpu")
    tp.estimator = TrainedEstimator(model, cfg, train_n=jest.train_n)
    return jp, tp, test


@pytest.mark.parametrize("method", ["cluster_dbscan", "cluster_laf_dbscan", "cluster_dbscan_pp",
                                    "cluster_laf_dbscan_pp"])
def test_pipeline_cluster_methods_match_jax(pipelines, method):
    jp, tp, test = pipelines
    pj, pt = jp.predict_counts(test, EPS), tp.predict_counts(test, EPS)
    np.testing.assert_allclose(pt, pj, rtol=1e-4, atol=1e-4)
    # the estimators agree on which points are predicted core at both alphas
    for a in (1.0, ALPHA):
        np.testing.assert_array_equal(pt >= a * TAU, pj >= a * TAU)
    args = (test, EPS, TAU, ALPHA) if method == "cluster_laf_dbscan" else (test, EPS, TAU)
    want = getattr(jp, method)(*args)
    got = getattr(tp, method)(*args)
    assert got.method == want.method and got.params == want.params
    assert got.elapsed_s >= got.predict_s >= 0
    _same(got.result, want.result, _boundary(test, EPS))
