"""The whole slice: ``repro_torch``'s LAF-DBSCAN (random-projection
backend, sweep -> packed label propagation -> rescue) against the JAX
package on the same data and the same JAX-estimator predictions.

The JAX side runs its kernel path on the CPU as its own tests do
(``RandomProjectionBackend(device=True, interpret=True)``); the port
runs with ``device="cpu"`` (plain versions).  Hit bits may differ only
for pairs within the fp32 summation-order bound of the threshold
(``2 (d - 1) 2**-24``); they are counted.  With no such pair, labels,
core mask, ``n_range_queries`` and extras must be identical; otherwise
the ARI must be at least 0.99.

Training draws its weights and shuffles from other generators than the
reference, so ``train_rmi`` is held to estimator quality on the same
training set: its MSE of z is within 1.5x of the JAX estimator's (plus
0.05), and below the predict-the-mean MSE.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core.cardinality import rmi as jrmi
from repro.core.cardinality.features import build_training_set
from repro.core.cardinality.training import train_rmi as jax_train_rmi
from repro.core.laf_dbscan import laf_dbscan as jax_laf_dbscan
from repro.core.laf_dbscan import laf_dbscan_sequential as jax_laf_sequential
from repro.core.metrics import adjusted_rand_index
from repro.data import synthetic as jsyn
from repro.index.random_projection import RandomProjectionBackend as JaxRP

from repro_torch.core.cardinality.rmi import rmi_predict
from repro_torch.core.cardinality.training import train_rmi as torch_train_rmi
from repro_torch.core.laf_dbscan import laf_dbscan, laf_dbscan_sequential
from repro_torch.core.pipeline import LAFPipeline
from repro_torch.data import synthetic as tsyn
from repro_torch.index.random_projection import RandomProjectionBackend
from repro_torch.obs import metrics

EPS, TAU, ALPHA = 0.45, 4, 1.2


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
def split():
    data, _ = jsyn.make_angular_clusters(600, 16, 6, kappa=60, noise_frac=0.25, seed=7)
    return jsyn.train_test_split(data, 0.8, 0)


@pytest.fixture(scope="module")
def estimators(split):
    """The JAX and the port's estimators, trained on the same features."""
    train, _ = split
    feats, targets = build_training_set(train, (0.4, 0.5))
    kw = dict(epochs=10, batch_size=64, lr=1e-3, seed=0, feats_targets=(feats, targets))
    return feats, targets, jax_train_rmi(train, **kw), torch_train_rmi(train, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_pred(split, estimators):
    """The JAX estimator's predicted counts for the test split."""
    return estimators[2].predict_counts(split[1], EPS, reference_n=len(split[1]))


def test_train_rmi_quality_matches_jax(estimators):
    feats, targets, jest, test = estimators
    jz = np.asarray(jrmi.rmi_predict(jest.params, jax.numpy.asarray(feats), jest.cfg))
    tz = rmi_predict(test.model, torch.from_numpy(feats)).numpy()
    j_mse = float(np.mean((jz - targets) ** 2))
    t_mse = float(np.mean((tz - targets) ** 2))
    base = float(np.var(targets))
    print(f"MSE(z): jax {j_mse:.4f}  torch {t_mse:.4f}  predict-the-mean {base:.4f}")
    assert t_mse <= 1.5 * j_mse + 0.05
    assert t_mse < base
    assert test.cfg.target_max == pytest.approx(jest.cfg.target_max)
    assert sorted(test.history) == sorted(jest.history)


def _flip_margin(jbk, tbk, rows, data):
    hj, ht = jbk.query_hits(rows, EPS), tbk.query_hits(rows, EPS)
    pi, pj = np.nonzero(hj != ht)
    if not len(pi):
        return 0, 0.0
    dots = (data[rows[pi]].astype(np.float64) * data[pj].astype(np.float64)).sum(1)
    return len(pi), float(np.abs(dots - (1 - EPS)).max())


def test_synthetic_same_draws():
    for args in [(300, 8, 3), (257, 32, 5)]:
        a, la = jsyn.make_angular_clusters(*args, kappa=50, noise_frac=0.3, seed=2)
        b, lb = tsyn.make_angular_clusters(*args, kappa=50, noise_frac=0.3, seed=2)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
        for x, y in zip(jsyn.train_test_split(a, 0.8, 1), tsyn.train_test_split(a, 0.8, 1)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("verify,n_bits", [("band", 128), ("full", 64)])
def test_laf_dbscan_matches_jax(split, jax_pred, verify, n_bits):
    _, test = split
    jbk = JaxRP(n_bits=n_bits, seed=3, device=True, interpret=True, chunk=64,
                q_tile=32, db_tile=128, verify=verify).fit(test)
    tbk = RandomProjectionBackend(n_bits=n_bits, seed=3, chunk=64, verify=verify, device="cpu")
    want = jax_laf_dbscan(test, EPS, TAU, ALPHA, jax_pred, backend=jbk, cluster_device="auto")
    got = laf_dbscan(test, EPS, TAU, ALPHA, jax_pred, backend=tbk)
    exec_idx = np.nonzero(jax_pred >= ALPHA * TAU)[0]
    n_flip, margin = _flip_margin(jbk, tbk, exec_idx, test)
    print(f"{verify}: {n_flip} boundary pairs differ (max margin {margin:.2e})")
    assert margin <= 2 * (test.shape[1] - 1) * 2.0 ** -24
    assert 0 < want.extras["n_predicted_core"] < len(test)
    if n_flip == 0:
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.core, want.core)
        assert got.n_range_queries == want.n_range_queries
        assert got.extras == want.extras
    else:
        assert adjusted_rand_index(got.labels, want.labels) >= 0.99


def test_cluster_pass_device_vs_host_identical(split, jax_pred):
    """The port's device pass, its host union-find pass and the host
    numpy oracle backend give identical results."""
    _, test = split
    bk = RandomProjectionBackend(n_bits=128, seed=1, chunk=64, device="cpu")
    dev = laf_dbscan(test, EPS, TAU, ALPHA, jax_pred, backend=bk, cluster_device=True)
    host = laf_dbscan(test, EPS, TAU, ALPHA, jax_pred, backend=bk, cluster_device=False)
    oracle = RandomProjectionBackend(n_bits=128, seed=1, chunk=64, device="cpu", oracle=True)
    assert not oracle.packs_natively
    forced = laf_dbscan(test, EPS, TAU, ALPHA, jax_pred, backend=oracle, cluster_device=True)
    for other in (host, forced):
        np.testing.assert_array_equal(dev.labels, other.labels)
        np.testing.assert_array_equal(dev.core, other.core)
        assert dev.extras == other.extras


def test_one_host_sync_per_device_clustering(split, jax_pred, metrics_on):
    _, test = split
    syncs = metrics.counter("laf.cluster.host_syncs")
    before = syncs.value
    res = laf_dbscan(test, EPS, TAU, 1.0, jax_pred, backend="random_projection", device="cpu")
    assert syncs.value - before == 1
    assert res.n_clusters >= 1


def test_backend_queries_match_jax(split):
    _, test = split
    jbk = JaxRP(n_bits=128, seed=3, device=True, interpret=True, chunk=64,
                q_tile=32, db_tile=128).fit(test)
    tbk = RandomProjectionBackend(n_bits=128, seed=3, chunk=64, device="cpu").fit(test)
    rows, cols = np.arange(0, 120, 3), np.arange(5, 110, 2)
    assert tbk.band(EPS) == jbk.band(EPS)
    np.testing.assert_array_equal(tbk.signatures, jbk.signatures)
    np.testing.assert_array_equal(tbk.query_counts(rows, EPS), jbk.query_counts(rows, EPS))
    np.testing.assert_array_equal(tbk.query_hits_subset(rows, cols, EPS), jbk.query_hits_subset(rows, cols, EPS))
    tc, tb = tbk.query_hits_packed(rows, EPS)
    jc, jb = jbk.query_hits_packed(rows, EPS)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tb, jb)
    oracle = RandomProjectionBackend(n_bits=128, seed=3, chunk=64, device="cpu", oracle=True).fit(test)
    np.testing.assert_array_equal(oracle.query_hits(rows, EPS), tbk.query_hits(rows, EPS))
    np.testing.assert_array_equal(oracle.query_counts(rows, EPS), tbk.query_counts(rows, EPS))


def test_pipeline_end_to_end(split):
    data = np.concatenate(split)
    pipe = LAFPipeline(eps_grid=(0.4, 0.5), epochs=1, batch_size=256, seed=0, device="cpu")
    test = pipe.fit_split(data)
    np.testing.assert_array_equal(test, jsyn.train_test_split(data, 0.8, 0)[1])
    out = pipe.cluster_laf_dbscan(test, EPS, TAU, ALPHA)
    res = out.result
    assert res.labels.shape == (len(test),) and res.labels.min() >= -1
    assert out.elapsed_s >= out.predict_s > 0
    pred = pipe.predict_counts(test, EPS)
    host = laf_dbscan(test, EPS, TAU, ALPHA, pred, device="cpu", cluster_device=False)
    np.testing.assert_array_equal(res.labels, host.labels)


def test_laf_dbscan_sequential_matches_jax():
    data, _ = jsyn.make_angular_clusters(150, 8, 3, kappa=40, noise_frac=0.2, seed=4)
    est = (np.arange(150) % 7).astype(float)
    want = jax_laf_sequential(data, 0.5, 3, 1.0, lambda i: est[i])
    got = laf_dbscan_sequential(data, 0.5, 3, 1.0, lambda i: est[i], device="cpu")
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.n_range_queries == want.n_range_queries
