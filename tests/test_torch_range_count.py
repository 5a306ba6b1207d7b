"""Port parity for the exact range query: ``repro_torch``'s
``range_count`` kernel wrappers, the ``core.range_query`` engine on top
of them and ``ExactBackend``, against the JAX package on the same numpy
inputs (the Pallas kernel in interpret mode, the jnp engine and the
numpy backend).

The port runs with CPU tensors, i.e. through the kernel's plain PyTorch
version.  Hit bits may differ only for pairs whose fp32 dot lies within
the summation-order bound of the threshold, ``|dot - (1 - eps)| <= 2 (d
- 1) 2**-24`` (two fp32 sums of the same d products of unit vectors
differ by at most that; the reference's threshold may also sit one ulp
away, which the bound covers); such pairs are counted and reported,
and every count must equal the other side's count plus its row's flips.
The data are never chosen to avoid them.  A ``gpu`` test holds the CUDA
kernel to its plain version on the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import distances as jdist
from repro.core import range_query as jrq
from repro.index.base import RangeBackend as JaxBase
from repro.index.exact import ExactBackend as JaxExact
from repro.kernels.range_count import ops as jops

from repro_torch.core import distances as tdist
from repro_torch.core import range_query as trq
from repro_torch.core.dbscan import core_mask
from repro_torch.index.base import RangeBackend
from repro_torch.index.exact import ExactBackend
from repro_torch.kernels.range_count import range_count, range_count_bitmap, threshold
from repro_torch.kernels.range_count.ref import range_count_bitmap_ref, range_count_ref
from repro_torch.obs import metrics


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(seed, n, d, k=4, spread=0.35):
    """Unit rows around k centres, so every eps here has hits."""
    rng = np.random.default_rng(seed)
    centers = _unit(rng, k, d)
    x = centers[rng.integers(0, k, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _words(x) -> np.ndarray:
    """Packed words as the reference's uint32 bytes."""
    a = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return np.ascontiguousarray(a).view(np.uint32)


def _flips(got_words, want_words, q, db, eps):
    """(flipped pairs, their max |dot - (1 - eps)|, per-row popcount
    difference got - want) between two packed hit matrices."""
    g, w = _words(got_words), _words(want_words)
    nd = db.shape[0]
    diff = np.unpackbits((g ^ w).view(np.uint8), axis=1, bitorder="little")[:, :nd]
    pi, pj = np.nonzero(diff)
    margin = 0.0
    if len(pi):
        dots = (q[pi].astype(np.float64) * db[pj].astype(np.float64)).sum(1)
        margin = float(np.abs(dots - (1 - eps)).max())
    pop = lambda a: np.unpackbits(a.view(np.uint8), axis=1).sum(1).astype(np.int64)
    return len(pi), margin, pop(g) - pop(w)


def _tol(d):
    return 2 * (d - 1) * 2.0 ** -24


@pytest.mark.parametrize("eps", [0.3, 0.6, 1.2])
@pytest.mark.parametrize("nq,nd,d", [(37, 301, 24), (130, 77, 32), (5, 33, 7)])
def test_range_count_matches_jax(nq, nd, d, eps):
    x = _clustered(nq * 7 + nd, nq + nd, d)
    q, db = x[:nq], x[nq:]
    tc = range_count(torch.from_numpy(q), torch.from_numpy(db), eps)
    tc2, tb = range_count_bitmap(torch.from_numpy(q), torch.from_numpy(db), eps)
    assert tc.dtype == torch.int32 and tb.dtype == torch.int32
    assert tb.shape == (nq, -(-nd // 32))
    np.testing.assert_array_equal(tc.numpy(), tc2.numpy())
    # the bitmap and the counts of one call agree, and no tail bit is set
    pops = np.unpackbits(_words(tb).view(np.uint8), axis=1, bitorder="little")
    np.testing.assert_array_equal(pops.sum(1), tc.numpy())
    assert not pops[:, nd:].any()

    jc = np.asarray(jops.range_count(jnp.asarray(q), jnp.asarray(db), eps, q_tile=32, db_tile=64))
    jc2, jb = jops.range_count_bitmap(jnp.asarray(q), jnp.asarray(db), eps, q_tile=32, db_tile=64)
    ec = np.asarray(jrq.range_counts(jnp.asarray(q), jnp.asarray(db), eps, block_size=64))
    eb = np.asarray(jrq.range_bitmap(jnp.asarray(q), jnp.asarray(db), eps, block_size=64))
    for name, want_c, want_b in [("pallas", jc2, jb), ("engine", ec, eb)]:
        n_flip, margin, dpop = _flips(tb, np.asarray(want_b), q, db, eps)
        print(f"{name}: {n_flip} boundary pairs differ (max margin {margin:.2e})")
        assert margin <= _tol(d)
        np.testing.assert_array_equal(tc.numpy().astype(np.int64) - np.asarray(want_c), dpop)
    np.testing.assert_array_equal(jc, np.asarray(jc2))


def test_range_query_engine_blocks_and_numpy_inputs():
    x = _clustered(3, 300, 16)
    q, db = x[:70], x[70:]
    whole_c, whole_b = range_count_bitmap(torch.from_numpy(q), torch.from_numpy(db), 0.5)
    c, b = trq.range_counts_and_bitmap(q, db, 0.5, block_size=32, device="cpu")
    assert torch.equal(c, whole_c) and torch.equal(b, whole_b)
    assert torch.equal(trq.range_counts(torch.from_numpy(q), torch.from_numpy(db), 0.5, block_size=8), whole_c)
    assert torch.equal(trq.range_bitmap(q, db, 0.5, device="cpu"), whole_b)
    words = _words(whole_b)
    for i in (0, 13, 69):
        np.testing.assert_array_equal(
            trq.bitmap_row_to_indices(words[i], len(db)), jrq.bitmap_row_to_indices(words[i], len(db)))
    empty_c, empty_b = trq.range_counts_and_bitmap(q[:0], db, 0.5, device="cpu")
    assert empty_c.shape == (0,) and empty_b.shape == (0, -(-len(db) // 32))


def test_threshold_and_plain_version():
    assert threshold(0.55) == float(np.float32(1.0 - 0.55))
    x = _clustered(5, 90, 12)
    q, db = torch.from_numpy(x[:20]), torch.from_numpy(x[20:])
    thr = threshold(0.4)
    want = (q @ db.T > thr)
    assert torch.equal(range_count_ref(q, db, thr, block=32), want.sum(1, dtype=torch.int32))
    c, b = range_count_bitmap_ref(q, db, thr, block=32)
    np.testing.assert_array_equal(_words(b), jrq.pack_bitmap(want.numpy()))


def test_wrappers_validate_operands():
    q = torch.zeros((4, 8))
    with pytest.raises(TypeError):
        range_count(q.double(), q, 0.5)
    with pytest.raises(ValueError):
        range_count_bitmap(q, q[:, :4], 0.5)
    with pytest.raises(ValueError):
        range_count(q.T, q, 0.5)


def test_neighbor_lists_and_core_mask_match_jax():
    x = _clustered(9, 260, 20)
    got = trq.neighbor_lists(x, 0.45, block_size=64, device="cpu")
    want = jrq.neighbor_lists(x, 0.45, block_size=64)
    flips = [(i, j) for i, (a, b) in enumerate(zip(got, want)) for j in np.setxor1d(a, b)]
    dots = [abs(float(x[i].astype(np.float64) @ x[j].astype(np.float64)) - 0.55) for i, j in flips]
    print(f"{len(flips)} boundary pairs differ")
    assert all(m <= _tol(20) for m in dots)
    if not flips:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # core masks: the counts may differ only by pairs near the threshold
    jc = np.asarray(jrq.range_counts(jnp.asarray(x), jnp.asarray(x), 0.45)).astype(np.int64)
    tc = trq.range_counts(x, x, 0.45, device="cpu").numpy().astype(np.int64)
    near = (np.abs(x.astype(np.float64) @ x.T.astype(np.float64) - 0.55) <= _tol(20)).sum(1)
    assert (np.abs(tc - jc) <= near).all()
    mask = core_mask(x, 0.45, 5, device="cpu")
    assert mask.dtype == bool
    np.testing.assert_array_equal(mask, tc >= 5)


def test_distances_match_jax():
    rng = np.random.default_rng(2)
    raw = rng.standard_normal((50, 24)).astype(np.float32)
    raw[3] = 0.0
    tn = tdist.l2_normalize(torch.from_numpy(raw))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jdist.l2_normalize(jnp.asarray(raw))), rtol=1e-6, atol=1e-7)
    u, v = tn[:25], tn[25:]
    ju, jv = jnp.asarray(u.numpy()), jnp.asarray(v.numpy())
    np.testing.assert_allclose(tdist.cosine_distance(u, v).numpy(),
                               np.asarray(jdist.cosine_distance(ju, jv)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tdist.pairwise_cosine_distance(u, v).numpy(),
                               np.asarray(jdist.pairwise_cosine_distance(ju, jv)), rtol=1e-6, atol=1e-6)
    d = np.linspace(0.0, 2.0, 9)
    np.testing.assert_array_equal(tdist.cos_to_euclidean(d), jdist.cos_to_euclidean(d))
    np.testing.assert_array_equal(tdist.euclidean_to_cos(d), jdist.euclidean_to_cos(d))


@pytest.fixture(scope="module")
def backends():
    x = _clustered(11, 333, 24)
    return x, JaxExact(block_size=64).fit(x), ExactBackend(block_size=64, device="cpu").fit(x)


@pytest.mark.parametrize("eps", [0.35, 1.2])
def test_exact_backend_primitives_match_jax(backends, eps):
    x, jbk, tbk = backends
    n = len(x)
    rows, cols = np.arange(3, 300, 4), np.arange(0, 333, 3)
    th, jh = tbk.query_hits(rows, eps), jbk.query_hits(rows, eps)
    assert th.dtype == bool and th.shape == jh.shape == (len(rows), n)
    pi, pj = np.nonzero(th != jh)
    dots = (x[rows[pi]].astype(np.float64) * x[pj].astype(np.float64)).sum(1)
    print(f"eps {eps}: {len(pi)} boundary pairs differ")
    assert (np.abs(dots - (1 - eps)) <= _tol(24)).all()
    flips_per_row = th.sum(1) - jh.sum(1)
    np.testing.assert_array_equal(tbk.query_counts(rows, eps) - jbk.query_counts(rows, eps), flips_per_row)
    if len(pi) == 0:
        np.testing.assert_array_equal(th, jh)
        np.testing.assert_array_equal(tbk.query_hits_subset(rows, cols, eps), jbk.query_hits_subset(rows, cols, eps))
        tc, tb = tbk.query_hits_packed(rows, eps)
        jc, jb = jbk.query_hits_packed(rows, eps)
        assert tc.dtype == np.int64 and tb.dtype == np.uint32
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tb, jb)
    # whole-database counts: the reference takes them from its jnp
    # engine, its hits from numpy; each side may flip boundary pairs
    every = np.arange(n)
    all_t, all_j = tbk.query_counts(every, eps), jbk.query_counts(every, eps)
    hits_t, hits_j = tbk.query_hits(every, eps), jbk.query_hits(every, eps)
    assert all_t.dtype == np.int64
    np.testing.assert_array_equal(all_t, hits_t.sum(1))
    slack = (hits_t != hits_j).sum(1) + np.abs(all_j - hits_j.sum(1))
    assert (np.abs(all_t - all_j) <= slack).all()
    assert not tbk.packs_natively and not jbk.packs_natively


def test_exact_backend_fit_is_idempotent_and_lists(backends):
    x, jbk, tbk = backends
    dev = tbk.data_device
    assert tbk.fit(tbk.data) is tbk and tbk.data_device is dev
    np.testing.assert_array_equal(tbk.data, x)
    got, want = tbk.neighbor_lists(0.4, block_size=100), jbk.neighbor_lists(0.4, block_size=100)
    assert len(got) == len(want) == len(x)
    n_diff = sum(len(np.setxor1d(a, b)) for a, b in zip(got, want))
    print(f"{n_diff} boundary pairs differ")
    if n_diff == 0:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    refit = ExactBackend(device="cpu").fit(x.copy())
    np.testing.assert_array_equal(refit.query_counts(np.arange(10), 0.4), tbk.query_counts(np.arange(10), 0.4))


class _ToyTorch(RangeBackend):
    """Implements only ``fit`` and ``query_hits``: the base defaults
    supply the rest."""

    block_size = 16

    def fit(self, data):
        self._data = np.asarray(data, np.float32)
        return self

    def query_hits(self, rows, eps):
        return (self._data[rows] @ self._data.T) > (1.0 - eps)


class _ToyJax(JaxBase):
    block_size = 16
    fit = _ToyTorch.fit
    query_hits = _ToyTorch.query_hits


def test_base_defaults_match_reference_base():
    x = _clustered(4, 90, 12)
    t, j = _ToyTorch().fit(x), _ToyJax().fit(x)
    rows, cols = np.arange(0, 90, 7), np.array([1, 5, 9, 40, 77])
    np.testing.assert_array_equal(t.query_hits_subset(rows, cols, 0.5), j.query_hits_subset(rows, cols, 0.5))
    np.testing.assert_array_equal(t.query_counts(np.arange(90), 0.5), j.query_counts(np.arange(90), 0.5))
    assert t.query_counts(rows, 0.5).dtype == np.int64
    for a, b in zip(t.neighbor_lists(0.5, block_size=20), j.neighbor_lists(0.5, block_size=20)):
        np.testing.assert_array_equal(a, b)
    assert t.data is t._data and t.n_points == j.n_points == 90
    tc, tb = t.query_hits_packed(rows, 0.5)
    jc, jb = j.query_hits_packed(rows, 0.5)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tb, jb)
    with pytest.raises(AssertionError):
        _ToyTorch().data
    # the device-side defaults: an upload of the rows and of the words
    assert t.device.type == "cpu"
    np.testing.assert_array_equal(t.data_device.numpy(), x)
    dev_words = t.query_packed_device(rows, 0.5)
    assert dev_words.dtype == torch.int32
    np.testing.assert_array_equal(_words(dev_words), jb)


def test_exact_backend_hands_device_words_over(backends, monkeypatch):
    """``query_packed_device`` gives the kernel's words as they are, and
    the forced device pass takes them without ``query_hits_packed``'s
    host copy; the labels equal the host pass's."""
    from repro_torch.core.laf_dbscan import laf_dbscan

    x, _, tbk = backends
    rows = np.arange(5, 300, 3)
    words = tbk.query_packed_device(rows, 0.4)
    assert words.dtype == torch.int32 and words.device == tbk.device
    np.testing.assert_array_equal(_words(words), tbk.query_hits_packed(rows, 0.4)[1])
    pred = np.random.default_rng(1).uniform(0, 12, len(x))
    host = laf_dbscan(x, 0.4, 4, 1.0, pred, backend=tbk, cluster_device=False)

    def no_host_copy(*a, **k):
        raise AssertionError("the device pass copied its words through the host")

    monkeypatch.setattr(ExactBackend, "query_hits_packed", no_host_copy)
    dev = laf_dbscan(x, 0.4, 4, 1.0, pred, backend=tbk, block_size=64, cluster_device=True)
    np.testing.assert_array_equal(dev.labels, host.labels)
    np.testing.assert_array_equal(dev.core, host.core)
    assert dev.extras == host.extras


def test_data_device_is_the_resident_copy():
    from repro_torch.index.random_projection import RandomProjectionBackend

    x = _clustered(6, 120, 16)
    for bk in (ExactBackend(device="cpu").fit(x), RandomProjectionBackend(n_bits=64, device="cpu").fit(x)):
        assert bk.data_device is bk.data_device
        assert bk.data_device.dtype == torch.float32 and bk.data_device.device == bk.device
        np.testing.assert_array_equal(bk.data_device.numpy(), x)


@pytest.fixture
def metrics_on():
    """Counters record only while metrics are on (off by default, as in
    the reference); the switch is process-global, so it is put back."""
    was = metrics.enabled()
    metrics.enable()
    yield metrics
    if not was:
        metrics.disable()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nd,d,eps", [(70, 301, 32, 0.5), (200, 1000, 768, 0.45), (5, 40, 33, 1.2), (129, 129, 7, 0.3)])
def test_gpu_range_count_matches_plain(nq, nd, d, eps, metrics_on):
    dev = _card()
    x = _clustered(nq + d, nq + nd, d)
    q, db = torch.from_numpy(x[:nq]).to(dev), torch.from_numpy(x[nq:]).to(dev)
    launches = {k: metrics.counter(f"kernel.{k}.launches") for k in ("range_count", "range_count_bitmap")}
    before = {k: c.value for k, c in launches.items()}
    kc = range_count(q, db, eps)
    kc2, kb = range_count_bitmap(q, db, eps)
    torch.cuda.synchronize()
    assert all(launches[k].value == before[k] + 1 for k in launches)
    pc, pb = range_count_bitmap_ref(q, db, threshold(eps))
    n_flip, margin, dpop = _flips(kb.cpu(), pb.cpu(), x[:nq], x[nq:], eps)
    assert margin <= _tol(d)
    assert torch.equal(kc, kc2)
    np.testing.assert_array_equal((kc - pc).cpu().numpy(), dpop)
    if n_flip == 0:
        assert torch.equal(kc, pc) and torch.equal(kb, pb)


@pytest.mark.gpu
def test_gpu_range_query_engine_launches_once(metrics_on):
    """On the card ``block_size`` does not split the queries: one launch
    of each body takes them all, with the CPU's blocked results."""
    dev = _card()
    x = _clustered(8, 700, 32)
    launches = {k: metrics.counter(f"kernel.{k}.launches") for k in ("range_count", "range_count_bitmap")}
    before = {k: c.value for k, c in launches.items()}
    kc = trq.range_counts(x, x, 0.4, block_size=64, device=dev)
    kc2, kb = trq.range_counts_and_bitmap(x, x, 0.4, block_size=64, device=dev)
    torch.cuda.synchronize()
    assert all(launches[k].value == before[k] + 1 for k in launches)
    pc, pb = trq.range_counts_and_bitmap(x, x, 0.4, block_size=64, device="cpu")
    n_flip, margin, dpop = _flips(kb.cpu(), pb, x, x, 0.4)
    assert margin <= _tol(32) and torch.equal(kc, kc2)
    np.testing.assert_array_equal((kc.cpu() - pc).numpy(), dpop)
