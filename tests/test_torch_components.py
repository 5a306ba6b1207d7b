"""Port parity for connected components over a packed adjacency: the
square round (``label_prop_round``), its fixpoint
(``label_propagation_pallas``, one ``label_prop_fixpoint`` launch in
square mode) and the plain versions in
``repro_torch.core.union_find`` (``label_propagation``,
``label_propagation_dense``, ``connected_components_host``), against the
JAX package (Pallas kernels in interpret mode) on the same numpy
adjacency.  Labels are integers: every comparison is exact.

On the CPU the port's wrappers run the plain version (``ref.py``); the
``gpu`` tests hold the kernels to it on the card.
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
from repro_torch.kernels.label_prop import label_prop_fixpoint, label_prop_round, label_propagation_pallas
from repro_torch.kernels.label_prop.ops import fixpoint_inputs
from repro_torch.kernels.label_prop.ref import label_prop_fixpoint_ref, label_prop_round_ref
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


def _path(n):
    adj = np.zeros((n, n), bool)
    idx = np.arange(n - 1)
    adj[idx, idx + 1] = True
    adj = adj | adj.T
    np.fill_diagonal(adj, True)
    return adj


def _jax_square_rounds(words, active, max_iters):
    """``repro``'s ``label_propagation_pallas`` while loop (ops.py:98-116)
    driven round by round from Python, so its round count and the
    telemetry counts of each round can be read: (labels, rounds, (4,
    max_iters) frontier / changed / hops / shard wins)."""
    n = active.shape[0]
    act = jnp.asarray(active)
    labels = jnp.where(act, jnp.arange(n, dtype=jnp.int32), jnp.int32(n))
    tele = np.zeros((4, max_iters), np.int32)
    rounds = 0
    while rounds < max_iters:
        neigh = jops.label_prop_round(jnp.where(act, labels, BIG), jnp.asarray(words), row_tile=64, word_tile=4)
        new = jnp.where(act, jnp.minimum(labels, neigh), jnp.int32(n))
        jump = jnp.where(new < n, new, 0)
        jumped = jnp.where(new < n, jnp.minimum(new, new[jump]), new)
        front = int(jnp.sum(act & (neigh < labels)))
        tele[:, rounds] = [front, int(jnp.sum(jumped != labels)), int(jnp.sum(jumped < new)), front]
        changed = bool(jnp.any(jumped != labels))
        labels, rounds = jumped, rounds + 1
        if not changed:
            break
    return np.asarray(labels), rounds, tele


def _square_state(bits, active, max_iters, telemetry):
    """label_propagation_pallas's buffers for the fixpoint in square mode."""
    n, cap = len(active), bits.shape[1] * 32
    act = torch.zeros(cap, dtype=torch.bool, device=bits.device)
    act[:n] = torch.as_tensor(active, device=bits.device)
    idx = torch.arange(cap, dtype=torch.int32, device=bits.device)
    bufs = (torch.where(act, idx, BIG), torch.empty(cap, dtype=torch.int32, device=bits.device))
    flags = torch.zeros(max_iters + 1, dtype=torch.int32, device=bits.device)
    flags[0] = 1
    tele = torch.zeros((4, max_iters), dtype=torch.int32, device=bits.device) if telemetry else None
    return bufs, torch.empty(n, dtype=torch.int32, device=bits.device), torch.where(act, idx, -1), flags, tele


# (n, graph, active_frac, max_iters, telemetry): random graphs, and a path
# whose propagation max_iters cuts short
@pytest.mark.parametrize("n,graph,active_frac,max_iters,telemetry", [
    (300, 0.01, 0.7, 64, False), (300, 0.01, 0.7, 64, True), (515, 0.004, 0.9, 64, True),
    (120, "path", 1.0, 3, False), (120, "path", 1.0, 3, True),
])
def test_label_prop_fixpoint_square_matches_jax(n, graph, active_frac, max_iters, telemetry):
    """The fixpoint in square mode (``label_propagation_pallas``'s): the
    plain version and the wrapper on the CPU against the reference's
    while loop (Pallas round in interpret mode): labels, rounds and the
    four per-round counts."""
    if graph == "path":
        adj, active = _path(n), np.ones(n, bool)
    else:
        adj, active = _graph(n, graph, n + 11, active_frac)
    words, bits = _packed(adj)
    want, want_rounds, want_tele = _jax_square_rounds(words, active, max_iters)
    np.testing.assert_array_equal(
        np.asarray(jops.label_propagation_pallas(jnp.asarray(words), jnp.asarray(active), max_iters=max_iters,
                                                 row_tile=64, word_tile=4)), want)
    for fixpoint in (label_prop_fixpoint_ref, label_prop_fixpoint):
        bufs, m, pos, flags, tele = _square_state(bits, active, max_iters, telemetry)
        fixpoint(bits, bufs, m, pos, flags, square=True, tele=tele)
        rounds = int(flags[:max_iters].sum())
        assert rounds == want_rounds
        got = torch.where(torch.from_numpy(active), bufs[rounds % 2][:n], n)
        np.testing.assert_array_equal(got.numpy(), want)
        if telemetry:
            np.testing.assert_array_equal(tele.numpy(), want_tele)
    assert (rounds == max_iters) == (graph == "path")


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
    launches = {k: metrics.counter(f"kernel.{k}.launches")
                for k in ("label_prop_round", "label_prop_update", "label_prop_fixpoint")}
    before = {k: c.value for k, c in launches.items()}
    assert torch.equal(label_prop_round(labels, bits), label_prop_round_ref(labels, bits))
    got = label_propagation_pallas(bits, act, max_iters=64)
    torch.cuda.synchronize()
    # the round above, then one fixpoint launch that runs every round itself
    assert launches["label_prop_round"].value == before["label_prop_round"] + 1
    assert launches["label_prop_update"].value == before["label_prop_update"]
    assert launches["label_prop_fixpoint"].value == before["label_prop_fixpoint"] + 1
    assert torch.equal(got, tuf.label_propagation(bits, act))


def _rect_case(r, w, p, seed):
    """A sweep-like rect slab: ``r`` executed rows among w*32 columns,
    their adjacency among themselves (symmetric, self-bits) plus border
    bits in other columns; returns (slab int32, rows)."""
    rng = np.random.default_rng(seed)
    cap = w * 32
    rows = np.sort(rng.choice(cap, r, replace=False))
    adj = rng.random((r, r)) < p
    adj = adj | adj.T
    np.fill_diagonal(adj, True)
    full = np.zeros((r, cap), bool)
    full[:, rows] = adj
    full |= rng.random((r, cap)) < p / 4
    full[:, rows] = adj
    return torch.from_numpy(pack_bitmap(full).view(np.int32)), torch.from_numpy(rows.astype(np.int32))


# (mode, size, p, max_iters, telemetry): rect slabs as pass 2 gives them,
# one of 2048 words (labels of 256 KB: past what a block stages in shared
# memory), one of 40 rows (fewer than an H100's SMs: 2 blocks), square
# adjacencies, and paths whose propagation max_iters cuts short
GPU_FIXPOINT = [
    ("rect", (1000, 40), 0.01, 64, False), ("rect", (1000, 40), 0.01, 64, True),
    ("rect", (300, 2048), 0.02, 64, True), ("rect", (40, 8), 0.1, 64, True),
    ("square", 2000, 0.001, 64, False), ("square", 4421, 0.0015, 64, True),
    ("square", 3000, "path", 3, True), ("rect", 200, "path", 2, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("mode,size,p,max_iters,telemetry", GPU_FIXPOINT)
def test_gpu_label_prop_fixpoint_matches_plain(mode, size, p, max_iters, telemetry, metrics_on):
    """One cooperative launch against the plain fixpoint on the card:
    both label buffers, m, the flags and the telemetry exactly equal."""
    dev = _card()
    if mode == "square":
        adj, active = (_path(size), np.ones(size, bool)) if p == "path" else _graph(size, p, size, 0.9)
        bits = _packed(adj)[1].to(dev)
        states = [_square_state(bits, active, max_iters, telemetry) for _ in range(2)]
    else:
        if p == "path":
            bits, rows = torch.from_numpy(pack_bitmap(_path(size)).view(np.int32)), torch.arange(size, dtype=torch.int32)
        else:
            bits, rows = _rect_case(*size, p, seed=size[0])
        bits, cap = bits.to(dev), bits.shape[1] * 32
        _, _, _, _, pos, init = fixpoint_inputs(bits, rows, 2, n=cap, cap=cap)
        states = []
        for _ in range(2):
            flags = torch.zeros(max_iters + 1, dtype=torch.int32, device=dev)
            flags[0] = 1
            states.append(((init.clone(), torch.empty_like(init)), torch.empty(bits.shape[0], dtype=torch.int32, device=dev),
                           pos, flags, torch.zeros((4, max_iters), dtype=torch.int32, device=dev) if telemetry else None))
    launches = metrics.counter("kernel.label_prop_fixpoint.launches")
    before = launches.value
    (kb, km, kpos, kf, kt), (pb, pm, ppos, pf, pt) = states
    label_prop_fixpoint(bits, kb, km, kpos, kf, square=mode == "square", tele=kt)
    torch.cuda.synchronize()
    assert launches.value == before + 1
    label_prop_fixpoint_ref(bits, pb, pm, ppos, pf, square=mode == "square", tele=pt)
    for a, b in [(kb[0], pb[0]), (kb[1], pb[1]), (km, pm), (kf, pf)] + ([(kt, pt)] if telemetry else []):
        assert torch.equal(a, b)
    rounds = int(kf[:max_iters].sum())
    assert rounds >= 1 and (rounds == max_iters) == (p == "path")


# ---------------------------------------------------------------------------
# packed_connectivity (B10): one streaming block, bipartite propagation
# ---------------------------------------------------------------------------


def _conn_block(n, r, p, core_frac, seed, all_core_rows=False):
    """A streaming block: ``r`` rows of a symmetric adjacency over ``n``
    points (self-bits), a core mask, and the rows' core flags."""
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < p
    adj = adj | adj.T
    np.fill_diagonal(adj, True)
    core = rng.random(n) < core_frac
    rows = np.sort(rng.choice(n, r, replace=False))
    if all_core_rows:
        core[rows] = True
    return pack_bitmap(adj[rows]), rows, core


# (n, R, p, core_frac, all_core_rows): rows partly core; every row core;
# no core at all; a ragged R (37, 130) and W (7, 32 words) against the
# reference's 32-row / 2-word tiles
CONN_CASES = [(150, 40, 0.06, 0.5, False), (200, 37, 0.03, 0.5, False), (200, 64, 0.03, 0.4, True),
              (96, 20, 0.1, 0.0, False), (1000, 130, 0.01, 0.6, False)]


@pytest.mark.parametrize("n,r,p,core_frac,all_core_rows", CONN_CASES)
def test_packed_connectivity_matches_jax(n, r, p, core_frac, all_core_rows):
    """The port's wrapper (its plain version on the CPU) against the JAX
    function through its Pallas kernels in interpret mode: comp, owner,
    row_first and rounds exactly equal."""
    from repro_torch.kernels.label_prop import packed_connectivity

    words, rows, core = _conn_block(n, r, p, core_frac, n + r, all_core_rows)
    want = jax.device_get(jops.packed_connectivity(
        jnp.asarray(words), jnp.asarray(rows), jnp.asarray(core[rows]), jnp.asarray(core),
        row_tile=32, word_tile=2, interpret=True))
    got = packed_connectivity(torch.from_numpy(words.view(np.int32)), torch.from_numpy(rows),
                              torch.from_numpy(core[rows]), torch.from_numpy(core))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[3]) >= 1


def test_packed_connectivity_needs_a_round():
    """Round 0 yields row_first and the owner on the card, so the wrapper
    refuses ``max_iters`` < 1 on every device."""
    from repro_torch.kernels.label_prop import packed_connectivity

    words, rows, core = _conn_block(96, 20, 0.1, 0.5, 3)
    with pytest.raises(ValueError, match="max_iters"):
        packed_connectivity(torch.from_numpy(words.view(np.int32)), torch.from_numpy(rows),
                            torch.from_numpy(core[rows]), torch.from_numpy(core), max_iters=0)


def _conn_gpu_case(r, w, p, seed, core_frac=0.5):
    """A wide streaming slab on the card: ``r`` rows over ``w`` words
    (bits past n = 32 w - 5 clear), a ``core_frac`` share of the rows and
    columns core."""
    rng = np.random.default_rng(seed)
    n = 32 * w - 5
    rows = np.sort(rng.choice(n, r, replace=False))
    hit = rng.random((r, n)) < p
    hit[np.arange(r), rows] = True
    core = rng.random(n) < core_frac
    return torch.from_numpy(pack_bitmap(hit).view(np.int32)), rows, core


def _conn_gpu_sparse_case(r, w, p, seed, core_frac=0.5, dense=0):
    """As ``_conn_gpu_case``, built packed (LSB-first, as ``pack_bitmap``)
    from the set bits alone, so that tall and wide slabs need no (r, n)
    draw: about a share ``p`` of each row's bits set at random plus its
    own column; ``dense`` core columns hit by half the rows (a skewed
    slab: clustered points share their core neighbours)."""
    rng = np.random.default_rng(seed)
    n = 32 * w - 5
    rows = np.sort(rng.choice(n, r, replace=False))
    k = rng.binomial(n, p, size=r)
    ri = np.concatenate([np.repeat(np.arange(r), k), np.arange(r)])
    ci = np.concatenate([rng.integers(0, n, size=int(k.sum())), rows])
    core = rng.random(n) < core_frac
    if dense:
        cols = rng.choice(n, dense, replace=False)
        dr, dc = np.nonzero(rng.random((r, dense)) < 0.5)
        ri, ci = np.concatenate([ri, dr]), np.concatenate([ci, cols[dc]])
        core[cols] = True
    words = np.zeros((r, w), dtype=np.uint32)
    np.bitwise_or.at(words, (ri, ci // 32), np.left_shift(np.uint32(1), (ci % 32).astype(np.uint32)))
    return torch.from_numpy(words.view(np.int32)), rows, core


def _check_connectivity_on_card(bits, rows, core, max_iters):
    """``packed_connectivity`` on the card against the plain version: all
    four outputs exactly equal, one launch and no other kernel."""
    from repro_torch.kernels.label_prop import packed_connectivity
    from repro_torch.kernels.label_prop.ref import packed_connectivity_ref

    dev = bits.device
    args = (bits, torch.from_numpy(rows).to(dev), torch.from_numpy(core[rows]).to(dev), torch.from_numpy(core).to(dev))
    names = ("packed_connectivity", "col_reduce", "label_prop_rect", "label_prop_update")
    before = {k: metrics.counter(f"kernel.{k}.launches").value for k in names}
    got = packed_connectivity(*args, max_iters=max_iters)
    torch.cuda.synchronize()
    after = {k: metrics.counter(f"kernel.{k}.launches").value - before[k] for k in names}
    assert after == {"packed_connectivity": 1, "col_reduce": 0, "label_prop_rect": 0, "label_prop_update": 0}
    want = packed_connectivity_ref(*args, max_iters=max_iters)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# (R, W words, density, seed, core share, max_iters): the exact main
# slab's width (952: K2 staged) and the stream's width at 152,185 points
# (4,756: unstaged), a ragged small slab, a sparse one whose propagation
# takes many rounds, the same cut to one and to two rounds (round 0 alone
# yields row_first and the owner), a block with no core, and a block with
# no rows (the launch runs no round; the plain version counts one)
GPU_CONNECTIVITY = [(512, 952, 0.004, 0, 0.5, 64), (512, 4756, 0.001, 1, 0.5, 64), (37, 7, 0.05, 2, 0.5, 64),
                    (2048, 952, 0.0005, 3, 0.5, 64), (2048, 952, 0.0005, 3, 0.5, 1), (2048, 952, 0.0005, 3, 0.5, 2),
                    (300, 130, 0.01, 5, 0.0, 64), (0, 7, 0.05, 4, 0.5, 64)]
# (R, W, density, seed, core share, max_iters, dense core columns): the
# work items' edges at the launcher's own heights (``conn_grid``; see
# test_gpu_connectivity_items_reach_their_edges): one chunk holding all
# of R inside a warp's step (20 rows); many 32-row chunks (5,000 rows
# over 3 tiles); R past K3's capped 512-row chunk and not a multiple of
# 32 (1,700 rows over 265 tiles: chunks 512, 512, 512, 164); R not a
# multiple of 32 (4,133 rows); W % 4 != 0 (4,757 and 1,001 words: the
# 4-byte loads) past the old label-staging limit; a skewed slab whose
# dense core columns cluster in a few tiles; a single round
GPU_CONNECTIVITY_ITEMS = [(5000, 300, 0.004, 6, 0.5, 64, 0), (4133, 4757, 0.0005, 7, 0.6, 64, 0),
                          (700, 1001, 0.003, 8, 0.5, 64, 0), (4096, 952, 0.001, 9, 0.6, 64, 300),
                          (1000, 4756, 0.0002, 10, 0.6, 64, 2000), (4133, 4757, 0.0005, 7, 0.6, 1, 0),
                          (20, 40, 0.01, 11, 0.5, 64, 0), (1700, 33800, 0.00003, 12, 0.6, 64, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("r,w,p,seed,core_frac,max_iters", GPU_CONNECTIVITY)
def test_gpu_packed_connectivity_matches_plain(r, w, p, seed, core_frac, max_iters, metrics_on):
    """The connectivity mode's one cooperative launch, which also yields
    the owner and row_first, against the plain version on the card: all
    four outputs exactly equal, and no other kernel launched."""
    dev = _card()
    bits, rows, core = _conn_gpu_case(r, w, p, seed, core_frac)
    _check_connectivity_on_card(bits.to(dev), rows, core, max_iters)


@pytest.mark.gpu
@pytest.mark.parametrize("r,w,p,seed,core_frac,max_iters,dense", GPU_CONNECTIVITY_ITEMS)
def test_gpu_packed_connectivity_items_match_plain(r, w, p, seed, core_frac, max_iters, dense, metrics_on):
    """The same on slabs shaped to the work items' edges."""
    dev = _card()
    bits, rows, core = _conn_gpu_sparse_case(r, w, p, seed, core_frac, dense)
    _check_connectivity_on_card(bits.to(dev), rows, core, max_iters)


@pytest.mark.gpu
def test_gpu_connectivity_items_reach_their_edges():
    """The launcher's work-item heights on the card put the edge slabs of
    ``GPU_CONNECTIVITY_ITEMS`` where their comment says: one chunk of
    both steps over 20 rows, over a hundred 32-row chunks over 5,000, and
    K3's chunk capped at 512 rows below R = 1,700, with a ragged last."""
    from repro_torch.kernels.label_prop.ops import connectivity_grid

    _card()
    _, _, c2, c3 = connectivity_grid(20, 40)
    assert c2 >= 20 and c3 >= 20
    _, _, c2, c3 = connectivity_grid(5000, 300)
    assert -(-5000 // c2) > 100 and -(-5000 // c3) > 100
    _, _, _, c3 = connectivity_grid(1700, 33800)
    assert c3 == 512 and 1700 % c3 % 32


@pytest.mark.gpu
def test_gpu_packed_connectivity_reaches_max_iters(metrics_on):
    """A path of core columns through core rows (row i joins columns i
    and i + 1), which pointer jumping needs about log2 of its length in
    rounds to close: cut at 3 rounds, the launch stops there with the
    plain version's labels (rounds == max_iters), and uncut it reaches
    the one component."""
    from repro_torch.kernels.label_prop import packed_connectivity
    from repro_torch.kernels.label_prop.ref import packed_connectivity_ref

    dev = _card()
    n = 3000
    hit = np.zeros((n - 1, n), dtype=bool)
    hit[np.arange(n - 1), np.arange(n - 1)] = hit[np.arange(n - 1), np.arange(1, n)] = True
    args = (torch.from_numpy(pack_bitmap(hit).view(np.int32)).to(dev), torch.arange(n - 1, device=dev),
            torch.ones(n - 1, dtype=torch.bool, device=dev), torch.ones(n, dtype=torch.bool, device=dev))
    for max_iters in (3, 64):
        got = packed_connectivity(*args, max_iters=max_iters)
        want = packed_connectivity_ref(*args, max_iters=max_iters)
        for a, b in zip(got, want):
            assert torch.equal(a, b), max_iters
    assert int(packed_connectivity(*args, max_iters=3)[3]) == 3
    assert (packed_connectivity(*args)[0] == 0).all()
