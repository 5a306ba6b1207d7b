"""Port parity for connected components over a packed adjacency: the
square round (``label_prop_round``), its fixpoint
(``label_propagation_pallas``) and the plain versions in
``repro_torch.core.union_find`` (``label_propagation``,
``label_propagation_dense``, ``connected_components_host``), against the
JAX package (Pallas kernels in interpret mode) on the same numpy
adjacency.  Labels are integers: every comparison is exact.

On the CPU the port's wrappers run the plain version (``ref.py``); the
``gpu`` test holds the kernels to it on the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import union_find as juf
from repro.core.range_query import pack_bitmap
from repro.kernels.label_prop import ops as jops
from repro.kernels.label_prop.ref import label_prop_round_ref as jax_round_ref

from repro_torch.core import union_find as tuf
from repro_torch.kernels.label_prop import label_prop_round, label_propagation_pallas
from repro_torch.kernels.label_prop.ref import label_prop_round_ref
from repro_torch.obs import metrics

BIG = np.iinfo(np.int32).max


def _graph(n, p, seed, active_frac=1.0):
    """Symmetric random adjacency with self-bits, masked to the active set."""
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < p
    adj = adj | adj.T
    np.fill_diagonal(adj, True)
    active = rng.random(n) < active_frac
    return adj & active[:, None] & active[None, :], active


def _packed(adj):
    """(uint32 words for JAX, the same bits as int32 for the port)."""
    words = pack_bitmap(adj)
    return words, torch.from_numpy(words.view(np.int32))


@pytest.mark.parametrize("n,p", [(100, 0.05), (300, 0.01), (515, 0.004)])
def test_label_prop_round_sweep(n, p):
    adj, _ = _graph(n, p, n)
    words, bits = _packed(adj)
    labels = np.random.default_rng(n + 1).permutation(n).astype(np.int32)
    want = np.asarray(jops.label_prop_round(jnp.asarray(labels), jnp.asarray(words), row_tile=64, word_tile=4))
    np.testing.assert_array_equal(want, np.asarray(jax_round_ref(jnp.asarray(labels), jnp.asarray(words), BIG)))
    lt = torch.from_numpy(labels)
    np.testing.assert_array_equal(label_prop_round(lt, bits).numpy(), want)
    np.testing.assert_array_equal(label_prop_round_ref(lt, bits).numpy(), want)


def test_label_prop_round_pad_bits_inert():
    """Bits of columns >= N meet INT32_MAX labels, as the reference's
    padding makes them: the round is the reference's with them set."""
    n = 70
    adj, _ = _graph(n, 0.05, 3)
    words, bits = _packed(adj)
    bits = bits.clone()
    bits[:, -1] |= torch.tensor(-(1 << (n % 32)), dtype=torch.int32)  # set every bit past n
    labels = np.random.default_rng(4).permutation(n).astype(np.int32)
    want = np.asarray(jax_round_ref(jnp.asarray(labels), jnp.asarray(words), BIG))
    np.testing.assert_array_equal(label_prop_round(torch.from_numpy(labels), bits).numpy(), want)


def test_label_prop_full_cc_matches_host():
    adj, active = _graph(400, 0.008, 5, active_frac=0.8)
    words, bits = _packed(adj)
    want = np.asarray(jops.label_propagation_pallas(jnp.asarray(words), jnp.asarray(active), row_tile=64, word_tile=8))
    act = torch.from_numpy(active)
    got, rounds = label_propagation_pallas(bits, act, with_rounds=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 1 <= int(rounds) <= 64
    np.testing.assert_array_equal(tuf.label_propagation(bits, act).numpy(), want)
    np.testing.assert_array_equal(np.asarray(juf.label_propagation(jnp.asarray(words), jnp.asarray(active))), want)
    edges = list(zip(*np.nonzero(np.triu(adj))))
    host = tuf.connected_components_host(400, edges, active)
    np.testing.assert_array_equal(host, juf.connected_components_host(400, edges, active))
    # min-index labels compacted in order of first member = the host's
    np.testing.assert_array_equal(tuf.compact_labels(np.where(active, got.numpy(), -1)), host)


def test_label_prop_chain_graph():
    """Worst-case diameter: a 257-node path converges within 64 rounds
    (pointer jumping)."""
    n = 257
    adj = np.zeros((n, n), bool)
    idx = np.arange(n - 1)
    adj[idx, idx + 1] = True
    adj = adj | adj.T
    words, bits = _packed(adj)
    got, rounds = label_propagation_pallas(bits, torch.ones(n, dtype=torch.bool), with_rounds=True)
    assert (got == 0).all() and int(rounds) < 64
    want = np.asarray(juf.label_propagation(jnp.asarray(words), jnp.ones(n, bool)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,p,active_frac,max_iters", [(64, 0.05, 1.0, 64), (300, 0.01, 0.7, 64),
                                                       (515, 0.004, 0.9, 64), (300, 0.006, 0.9, 2)])
def test_label_propagation_plain_matches_jax(n, p, active_frac, max_iters):
    """The plain versions, packed and dense, and the fixpoint, with the
    round limit cutting the propagation short in the last case."""
    adj, active = _graph(n, p, n + 7, active_frac)
    words, bits = _packed(adj)
    want = np.asarray(juf.label_propagation(jnp.asarray(words), jnp.asarray(active), max_iters=max_iters))
    np.testing.assert_array_equal(
        np.asarray(juf.label_propagation_dense(jnp.asarray(adj), jnp.asarray(active), max_iters=max_iters)), want)
    act = torch.from_numpy(active)
    np.testing.assert_array_equal(tuf.label_propagation(bits, act, max_iters=max_iters, block=100).numpy(), want)
    np.testing.assert_array_equal(
        tuf.label_propagation_dense(torch.from_numpy(adj), act, max_iters=max_iters).numpy(), want)
    np.testing.assert_array_equal(label_propagation_pallas(bits, act, max_iters=max_iters).numpy(), want)


@pytest.fixture
def metrics_on():
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
@pytest.mark.parametrize("n,p,active_frac", [(515, 0.004, 0.9), (2000, 0.001, 0.8), (1, 1.0, 1.0),
                                             (4421, 0.0015, 0.85)])  # more rows than an H100's K2 warps
def test_gpu_components_match_plain(n, p, active_frac, metrics_on):
    dev = _card()
    adj, active = _graph(n, p, n, active_frac)
    _, bits = _packed(adj)
    bits, act = bits.to(dev), torch.from_numpy(active).to(dev)
    labels = torch.from_numpy(np.random.default_rng(n).permutation(n).astype(np.int32)).to(dev)
    launches = {k: metrics.counter(f"kernel.{k}.launches") for k in ("label_prop_round", "label_prop_update")}
    before = {k: c.value for k, c in launches.items()}
    assert torch.equal(label_prop_round(labels, bits), label_prop_round_ref(labels, bits))
    got = label_propagation_pallas(bits, act, max_iters=64)
    torch.cuda.synchronize()
    assert launches["label_prop_round"].value == before["label_prop_round"] + 65
    assert launches["label_prop_update"].value == before["label_prop_update"] + 64
    assert torch.equal(got, tuf.label_propagation(bits, act))
