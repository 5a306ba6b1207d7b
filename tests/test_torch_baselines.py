"""The paper's baselines in the port against the JAX package's
(``repro.core.baselines``): KNN-BLOCK (exact and windowed modes),
BLOCK-DBSCAN (all singleton blocks; inner blocks with replayed
``rng.choice`` draws; a set where those draws decide unions) and
rho-approximate DBSCAN (rho 0 and 1, both engines).  The same numpy
inputs go to both; the port runs with ``device="cpu"`` (the kernels'
plain versions).  Tolerance: none — labels, core masks, ``n_clusters``,
``n_range_queries`` and extras are identical.

Also the row popcount (``kernels/popcount``): its plain version against
``lax.population_count`` row sums of the same words, whole rows and bit
ranges (empty, whole words, ragged ends); and ``gpu`` cases (they skip
inside the test without a card): the kernel against its plain version,
each baseline on the card against the CPU.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core.range_query import pack_bitmap, unpack_bitmap  # noqa: E402
from repro.data.synthetic import make_angular_clusters  # noqa: E402

from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.kernels.popcount import row_popcount  # noqa: E402
from repro_torch.kernels.popcount.ref import row_popcount_ref  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402


@pytest.fixture
def metrics_on():
    was = metrics.enabled()
    metrics.enable()
    yield metrics
    if not was:
        metrics.disable()


@pytest.fixture(scope="module")
def blocks_set():
    """126 blocks at eps 0.2, 6 of them with more than 10 members: inner
    blocks, replayed draws and a candidate test (cand_sim 0.2)."""
    return make_angular_clusters(600, 16, 6, kappa=3000, noise_frac=0.2, seed=5)[0]


@pytest.fixture(scope="module")
def draws_set():
    """165 blocks at eps 0.2, 33 inner: here the replayed draws decide
    which blocks join (another generator seed changes the labels)."""
    return make_angular_clusters(600, 16, 6, kappa=300, noise_frac=0.2, seed=5)[0]


def _same(got, want):
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.core, want.core)
    assert got.n_clusters == want.n_clusters
    assert got.n_range_queries == want.n_range_queries
    assert got.extras == want.extras


@pytest.mark.parametrize("mode", ["exact", "windows"])
def test_knn_block_matches_jax(small_clustered, mode, metrics_on):
    x = small_clustered[0]
    kw = {"window": len(x)} if mode == "exact" else {"n_proj": 6, "window": 300}
    want = jbase.knn_block_dbscan(x, 0.25, 5, **kw)
    syncs = metrics.counter(tbase.METRICS["knn_block_dbscan"] + ".host_syncs")
    before = syncs.value
    # windowed: blocks of 256 sorted rows, so most bands start past column
    # 0 and the last one is shifted left to stay whole pieces
    bs = 2048 if mode == "exact" else 256
    got = tbase.knn_block_dbscan(x, 0.25, 5, block_size=bs, device="cpu", **kw)
    _same(got, want)
    assert want.n_clusters >= 2
    # the core mask, then one read a block of core rows
    assert syncs.value - before == 1 + -(-int(got.core.sum()) // bs)


@pytest.mark.parametrize("n, window, block", [(2000, 300, 256), (2000, 300, 2048), (1000, 7, 64), (150, 100, 64)])
def test_knn_band_holds_every_window(n, window, block):
    """Each band slice holds its rows' windows, spans whole 128-column
    pieces where n allows, and the bit ranges are the windows shifted
    into the slice."""
    for s in range(0, n, block):
        e = min(s + block, n)
        c0, c1, lo, hi = tbase._band(s, e, n, window, "cpu")
        pos = np.arange(s, e)
        assert 0 <= c0 <= max(s - window, 0) and min(e + window, n) <= c1 <= n
        assert (c1 - c0) % tbase.BAND_ALIGN == 0 or c1 - c0 == n
        np.testing.assert_array_equal(lo.numpy() + c0, np.maximum(pos - window, 0))
        np.testing.assert_array_equal(hi.numpy() + c0, np.minimum(pos + window + 1, n))


@pytest.mark.parametrize("case", ["singletons", "tiny", "inner_blocks", "draws_decide"])
def test_block_dbscan_matches_jax(case, small_clustered, tiny_clustered, blocks_set, draws_set, metrics_on):
    x, eps, tau = {
        "singletons": (small_clustered[0], 0.25, 5),
        "tiny": (tiny_clustered[0], 0.3, 4),
        "inner_blocks": (blocks_set, 0.2, 5),
        "draws_decide": (draws_set, 0.2, 5),
    }[case]
    want = jbase.block_dbscan(x, eps, tau)
    syncs = metrics.counter(tbase.METRICS["block_dbscan"] + ".host_syncs")
    before = syncs.value
    got = tbase.block_dbscan(x, eps, tau, device="cpu")
    _same(got, want)
    if case == "singletons":
        assert want.extras == {"n_blocks": len(x), "inner_blocks": 0}
    if case in ("inner_blocks", "draws_decide"):
        assert want.extras["inner_blocks"] >= 6
    # reads grow with the chunks of the cover (2 each), of the core rows and
    # of the landmarks (1 each), not with n
    assert 0 < syncs.value - before <= 4 * -(-len(x) // 2048) + 12


def test_block_dbscan_blocked_cover_and_pairs(draws_set):
    """Chunks of the cover and of the core rows smaller than the data,
    and a small ``rnt``: the same result as the reference's sequential
    loops."""
    want = jbase.block_dbscan(draws_set, 0.15, 5, rnt=3, seed=2)
    got = tbase.block_dbscan(draws_set, 0.15, 5, rnt=3, seed=2, block_size=64, device="cpu")
    _same(got, want)


@pytest.mark.parametrize("engine", ["cell", "direct"])
@pytest.mark.parametrize("rho", [0.0, 1.0])
def test_rho_approx_matches_jax(small_clustered, rho, engine, metrics_on):
    x = small_clustered[0]
    want = jbase.rho_approx_dbscan(x, 0.25, 5, rho, engine=engine)
    syncs = metrics.counter(tbase.METRICS["rho_approx_dbscan"] + ".host_syncs")
    before = syncs.value
    got = tbase.rho_approx_dbscan(x, 0.25, 5, rho, engine=engine, device="cpu")
    _same(got, want)
    # the core mask, then two reads (eps and eps(1 + rho)) a block of core rows
    assert syncs.value - before == 1 + 2 * -(-int(got.core.sum()) // 2048)


def _popcount_cases():
    rng = np.random.default_rng(11)
    out = []
    for r, w in [(7, 1), (9, 3), (33, 5), (16, 8), (5, 13)]:
        words = rng.integers(0, 2**32, size=(r, w), dtype=np.uint64).astype(np.uint32)
        words[0] = 0xFFFFFFFF
        nbits = 32 * w
        lo = rng.integers(-3, nbits + 3, size=r)
        hi = rng.integers(-3, nbits + 3, size=r)
        lo[0], hi[0] = 0, nbits              # the whole row
        lo[1], hi[1] = 32 * (w - 1), nbits   # the last word, whole
        lo[2], hi[2] = 5, 5                  # empty
        lo[3], hi[3] = 9, 4                  # empty (hi below lo)
        out.append((words, lo.astype(np.int32), hi.astype(np.int32)))
    return out


def _jax_row_counts(words, lo=None, hi=None):
    if lo is not None:
        bits = unpack_bitmap(words, 32 * words.shape[1])
        col = np.arange(bits.shape[1])
        bits = bits & (col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None])
        words = pack_bitmap(bits)
    return np.asarray(jnp.sum(lax.population_count(jnp.asarray(words)), axis=1))


@pytest.mark.parametrize("case", range(5))
def test_row_popcount_matches_population_count(case):
    words, lo, hi = _popcount_cases()[case]
    t = torch.from_numpy(words.view(np.int32))
    np.testing.assert_array_equal(row_popcount(t).numpy(), _jax_row_counts(words))
    got = row_popcount(t, torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    np.testing.assert_array_equal(got, _jax_row_counts(words, lo, hi))
    assert got[2] == got[3] == 0 and got[0] == _jax_row_counts(words)[0]


def test_row_popcount_validates_operands():
    w = torch.zeros((4, 3), dtype=torch.int32)
    r = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        row_popcount(w.long())
    with pytest.raises(ValueError):
        row_popcount(w, r)
    with pytest.raises(ValueError):
        row_popcount(w, r[:3], r[:3])
    with pytest.raises(ValueError):
        row_popcount(w.t())


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_row_popcount_matches_plain(metrics_on):
    dev = _card()
    rng = np.random.default_rng(3)
    cases = _popcount_cases()
    big = rng.integers(0, 2**32, size=(1031, 952), dtype=np.uint64).astype(np.uint32)  # 16-byte rows
    nb = 32 * 952
    cases.append((big, rng.integers(-40, nb, 1031).astype(np.int32), rng.integers(0, nb + 40, 1031).astype(np.int32)))
    # long rows of a word count that is not a multiple of 4: the word-by-word
    # path, which loads only the words that each row's range touches
    ragged = rng.integers(0, 2**32, size=(300, 351), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(-40, 32 * 351, 300)
    cases.append((ragged, lo.astype(np.int32), (lo + rng.integers(0, 4000, 300)).astype(np.int32)))
    launches = metrics.counter("kernel.row_popcount.launches")
    for words, lo, hi in cases:
        t = torch.from_numpy(words.view(np.int32))
        lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
        before = launches.value
        got = row_popcount(t.to(dev)).cpu()
        got_r = row_popcount(t.to(dev), lo_t.to(dev), hi_t.to(dev)).cpu()
        assert launches.value - before == 2
        assert torch.equal(got, row_popcount_ref(t))
        assert torch.equal(got_r, row_popcount_ref(t, lo_t, hi_t))
    # a slab view 4 bytes off a 16-byte boundary takes the word-by-word path
    odd = torch.from_numpy(big.view(np.int32)).to(dev).reshape(-1)[1 : 1 + 100 * 952].reshape(100, 952)
    assert torch.equal(row_popcount(odd).cpu(), row_popcount_ref(odd.cpu()))
    assert row_popcount(torch.zeros((0, 4), dtype=torch.int32, device=dev)).shape == (0,)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["knn_block", "block", "rho_cell", "rho_direct"])
def test_gpu_baselines_match_cpu(method, tiny_clustered, draws_set):
    dev = _card()
    x = tiny_clustered[0]
    run = {
        "knn_block": lambda **kw: tbase.knn_block_dbscan(x, 0.3, 4, n_proj=6, window=60, **kw),
        "block": lambda **kw: tbase.block_dbscan(draws_set, 0.2, 5, **kw),
        "rho_cell": lambda **kw: tbase.rho_approx_dbscan(x, 0.3, 4, 1.0, **kw),
        "rho_direct": lambda **kw: tbase.rho_approx_dbscan(x, 0.3, 4, 0.0, engine="direct", **kw),
    }[method]
    _same(run(device=dev), run(device="cpu"))
