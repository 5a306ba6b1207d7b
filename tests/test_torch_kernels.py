"""Port parity for the modules that hold kernels: ``repro_torch``'s
Hamming filter, sweep engine and packed label propagation against the
JAX package (Pallas kernels in interpret mode) on the same numpy inputs.

The port runs with CPU tensors, i.e. through each kernel's plain
PyTorch version.  Integers must be equal.  Hit bits may differ only for
pairs whose fp32 dot lies within the summation-order bound of the
threshold, ``|dot - (1 - eps)| <= 2 (d - 1) 2**-24`` (two fp32 sums of
the same d products of unit vectors differ by at most that); such pairs
are counted and reported, never avoided by choice of data.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core.range_query import pack_bitmap
from repro.index.signatures import make_projection as jax_make_projection
from repro.index.signatures import hamming_words as jax_hamming_words
from repro.index.signatures import sign_signatures as jax_sign_signatures
from repro.index import sweep as jsweep
from repro.kernels.hamming_filter import ops as jhf
from repro.kernels.label_prop import packed_cluster_labels as jax_packed_cluster_labels
from repro.kernels.label_prop.kernel import col_reduce_pallas, label_prop_rect_pallas
from repro.kernels.label_prop.ref import col_reduce_ref as jax_col_reduce_ref
from repro.kernels.label_prop.ref import label_prop_rect_ref as jax_rect_ref

from repro_torch.index import sweep as tsweep
from repro_torch.index.signatures import hamming_words
from repro_torch.kernels.hamming_filter import ops as thf
from repro_torch.kernels.label_prop import (
    col_reduce,
    label_prop_fixpoint,
    label_prop_rect,
    label_prop_update,
    packed_cluster_labels,
)
from repro_torch.kernels.label_prop.ops import fixpoint_inputs
from repro_torch.kernels.label_prop.ref import label_prop_fixpoint_ref, label_prop_update_ref

BIG = np.iinfo(np.int32).max


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _case(seed, nq, nd, d, n_bits):
    """Clustered unit rows (so every band mode has hits) + signatures."""
    rng = np.random.default_rng(seed)
    centers = _unit(rng, 4, d)
    def draw(n):
        x = centers[rng.integers(0, 4, n)] + 0.35 * rng.standard_normal((n, d)).astype(np.float32)
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    q, db = draw(nq), draw(nd)
    proj = jax_make_projection(d, n_bits, seed)
    return q, db, jax_sign_signatures(q, proj), jax_sign_signatures(db, proj)


def _t(a):
    a = np.array(a)  # a writable copy (JAX hands out read-only buffers)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _flips(ref_bits, got_bits, q, db, eps):
    """(pairs whose hit bit differs, max |dot - (1-eps)| over them)."""
    nd = db.shape[0]
    r = np.unpackbits(np.ascontiguousarray(ref_bits).view(np.uint8), bitorder="little").reshape(len(ref_bits), -1)[:, :nd]
    g = np.unpackbits(np.ascontiguousarray(got_bits).view(np.uint8), bitorder="little").reshape(len(got_bits), -1)[:, :nd]
    pi, pj = np.nonzero(r != g)
    if not len(pi):
        return 0, 0.0
    dots = (q[pi].astype(np.float64) * db[pj].astype(np.float64)).sum(axis=1)
    return len(pi), float(np.abs(dots - (1.0 - eps)).max())


def _assert_parity(jc, jb, tc, tb, q, db, eps):
    jc, tc = np.asarray(jc), tc.numpy()
    n_flip, margin = _flips(np.asarray(jb), tb.numpy().view(np.uint32), q, db, eps)
    print(f"eps={eps}: {n_flip} boundary pairs differ (max margin {margin:.2e})")
    assert margin <= 2 * (q.shape[1] - 1) * 2.0 ** -24
    if n_flip == 0:
        np.testing.assert_array_equal(jc, tc)
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy().view(np.uint32))
    else:
        assert np.abs(jc - tc).sum() <= n_flip


# (nq, nd, d, n_bits, eps, t_lo, t_hi): ragged nq and nd, full-verify
# (t_lo = -1), band, sure-accept-heavy, and eps > 1 (pad rows hit)
CASES = [
    (37, 201, 16, 64, 0.5, -1, 30),
    (70, 300, 32, 128, 0.45, 40, 60),
    (33, 129, 16, 64, 0.9, 20, 45),
    (45, 150, 32, 128, 1.2, 50, 128),
]


@pytest.mark.parametrize("nq,nd,d,n_bits,eps,t_lo,t_hi", CASES)
def test_hamming_filter_bitmap_matches_jax(nq, nd, d, n_bits, eps, t_lo, t_hi):
    q, db, qs, dbs = _case(nq + nd, nq, nd, d, n_bits)
    jc, jb = jhf.hamming_filter_bitmap(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(qs), jnp.asarray(dbs), eps, t_hi,
        t_lo=t_lo, q_tile=32, db_tile=128, interpret=True,
    )
    tc, tb = thf.hamming_filter_bitmap(_t(q), _t(db), _t(qs), _t(dbs), eps, t_hi, t_lo=t_lo)
    assert tb.shape == (nq, -(-nd // 32))
    _assert_parity(jc, jb, tc, tb, q, db, eps)


@pytest.mark.parametrize("nq,nd,d,n_bits,eps,t_lo,t_hi", CASES[1:3])
def test_hamming_filter_count_matches_bitmap_and_jax(nq, nd, d, n_bits, eps, t_lo, t_hi):
    q, db, qs, dbs = _case(nq * nd, nq, nd, d, n_bits)
    jc = jhf.hamming_filter_count(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(qs), jnp.asarray(dbs), eps, t_hi,
        t_lo=t_lo, q_tile=32, db_tile=128, interpret=True,
    )
    tc = thf.hamming_filter_count(_t(q), _t(db), _t(qs), _t(dbs), eps, t_hi, t_lo=t_lo)
    tcb, _ = thf.hamming_filter_bitmap(_t(q), _t(db), _t(qs), _t(dbs), eps, t_hi, t_lo=t_lo)
    np.testing.assert_array_equal(tc.numpy(), tcb.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())


def _plus_minus_one(words: np.ndarray) -> torch.Tensor:
    """The card's expansion of packed LSB-first words (``csrc/
    hamming_filter.cu`` ``plus_minus_one``): bit l of word c becomes the
    int8 1 - 2 bit at column 32 c + l, a nibble at a time,
    (n * 0x204081) & 0x01010101 then * 0xFE + 0x01010101."""
    w = torch.from_numpy(words.astype(np.int64))
    nib = (w[..., None] >> (4 * torch.arange(8))) & 0xF
    four = ((nib * 0x00204081) & 0x01010101) * 0xFE + 0x01010101
    b = (four[..., None] >> (8 * torch.arange(4))) & 0xFF
    return b.to(torch.uint8).view(torch.int8).reshape(words.shape[0], -1)


@pytest.mark.parametrize("n_bits", [32, 64, 512, 1024])
def test_plus_minus_one_dot_is_the_hamming_distance(n_bits):
    """The card's Hamming distances: the int32 dot of the +-1 int8 rows is
    n_bits - 2 ham, exactly the reference's popcount (and the port's), for
    every width the kernel takes; column 32 c + l carries bit l of word c."""
    rng = np.random.default_rng(n_bits)
    words = rng.integers(0, 2**32, (40, n_bits // 32), dtype=np.uint32)
    words[0], words[1] = 0, 0xFFFFFFFF  # all +1, all -1
    pm = _plus_minus_one(words)
    assert pm.shape == (40, n_bits)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little").reshape(40, n_bits)
    np.testing.assert_array_equal(pm.numpy(), 1 - 2 * bits.astype(np.int8))
    dot = pm[:17].to(torch.int32) @ pm[17:].to(torch.int32).T
    ham = (n_bits - dot) // 2
    assert ((n_bits - dot) % 2 == 0).all()
    np.testing.assert_array_equal(ham.numpy(), np.asarray(jax_hamming_words(jnp.asarray(words[:17]), jnp.asarray(words[17:]))))
    np.testing.assert_array_equal(ham.numpy(), hamming_words(_t(words[:17]), _t(words[17:])).numpy())


@pytest.mark.parametrize("eps,t_lo,t_hi", [(0.5, -1, 30), (0.5, 40, 60), (1.2, 10, 40), (1.0, 64, 128)])
def test_pad_col_hits_and_tail_mask_match_jax(eps, t_lo, t_hi):
    rng = np.random.default_rng(5)
    qs = rng.integers(0, 2**32, (19, 4), dtype=np.uint32)
    j = np.asarray(jhf._pad_col_hits(jnp.asarray(qs), eps, t_lo, t_hi, 7))
    t = thf._pad_col_hits(_t(qs), eps, t_lo, t_hi, 7).numpy()
    np.testing.assert_array_equal(j, t)
    for n_words, n in [(4, 100), (3, 96), (5, 129)]:
        jm = np.asarray(jhf._tail_word_mask(n_words, n))
        tm = thf._tail_word_mask(n_words, n, "cpu").numpy().view(np.uint32)
        np.testing.assert_array_equal(jm, tm)


@pytest.mark.parametrize("eps,t_lo,t_hi,slack", [(0.45, 40, 60, 0), (1.2, 50, 128, 37), (0.5, -1, 70, 61)])
def test_sweeps_match_jax_with_capacity_slack(eps, t_lo, t_hi, slack):
    """Whole sweeps against a db whose last ``slack`` rows are zero
    capacity padding: counts are corrected and tail bits cleared exactly
    as the reference does (``eps > 1`` makes every pad row a hit)."""
    nq, n, d = 150, 233, 32
    q, db, qs, dbs = _case(slack + 1, nq, n, d, 128)
    dbp = np.concatenate([db, np.zeros((slack, d), np.float32)])
    dbsp = np.concatenate([dbs, np.zeros((slack, dbs.shape[1]), np.uint32)])
    kw = dict(chunk=64, chunks_per_launch=2)
    jc, jb = jsweep.sweep_bitmap(
        jnp.asarray(q), jnp.asarray(qs), jnp.asarray(dbp), jnp.asarray(dbsp), n, eps, t_lo, t_hi,
        q_tile=32, db_tile=128, interpret=True, **kw)
    tc, tb = tsweep.sweep_bitmap(_t(q), _t(qs), _t(dbp), _t(dbsp), n, eps, t_lo, t_hi, **kw)
    assert tb.shape == jb.shape and tb.dtype == np.uint32
    _assert_parity(jc, jb, torch.from_numpy(tc), torch.from_numpy(tb.view(np.int32)), q, db, eps)
    tcount = tsweep.sweep_counts(_t(q), _t(qs), _t(dbp), _t(dbsp), n, eps, t_lo, t_hi, **kw)
    np.testing.assert_array_equal(tcount, tc)
    slab, plan = tsweep.sweep_bitmap_device(_t(q), _t(qs), _t(dbp), _t(dbsp), n, eps, t_lo, t_hi, **kw)
    assert slab.shape[0] == plan.nq_padded >= nq
    np.testing.assert_array_equal(slab[:nq, : tb.shape[1]].numpy().view(np.uint32), tb)
    assert not slab[nq:].any()


def test_plan_sweep_matches_jax():
    for args in [(1, 256), (300, 64), (4096, 256), (2049, 100)]:
        j, t = jsweep.plan_sweep(*args), tsweep.plan_sweep(*args)
        assert (j.nq, j.chunk, j.cpl, j.n_launches, j.nq_padded) == (
            t.nq, t.chunk, t.cpl, t.n_launches, t.nq_padded)


# ---------------------------------------------------------------------------
# label propagation
# ---------------------------------------------------------------------------


def _fill(bitmap, case):
    """The random slab, or an all-zero / all-ones one of its shape."""
    if case == "zeros":
        return np.zeros_like(bitmap)
    if case == "ones":
        return np.full_like(bitmap, 0xFFFFFFFF)
    return bitmap


# case: False = a random slab against the Pallas kernel in interpret mode;
# True = a random slab of any shape against its jnp oracle; "zeros" /
# "ones" = that slab against the Pallas kernel.  (8, 2048): labels of
# 256 KB, past what the card's kernel stages in shared memory.
@pytest.mark.parametrize("r,w,ragged", [(64, 4, False), (128, 8, False), (77, 3, True), (5, 1, True),
                                        (64, 4, "zeros"), (64, 4, "ones"), (8, 2048, True)])
def test_label_prop_rect_matches_jax(r, w, ragged):
    rng = np.random.default_rng(r * w)
    bitmap = rng.integers(0, 2**32, (r, w), dtype=np.uint32)
    bitmap &= rng.integers(0, 2**32, (r, w), dtype=np.uint32)  # sparser rows
    bitmap = _fill(bitmap, ragged)
    col = rng.permutation(w * 32).astype(np.int32)
    col[rng.random(w * 32) < 0.3] = BIG
    row = np.full(r, BIG, np.int32)
    active = rng.random(r) < 0.5
    row[active] = rng.integers(0, w * 32, active.sum())
    if ragged is True:  # any shape: the jnp oracle of the Pallas kernel
        ref = jax_rect_ref(jnp.asarray(row), jnp.asarray(col), jnp.asarray(bitmap), BIG)
    else:
        ref = label_prop_rect_pallas(jnp.asarray(row), jnp.asarray(col), jnp.asarray(bitmap),
                                     row_tile=32, word_tile=2, interpret=True)
    got = label_prop_rect(_t(row), _t(col), _t(bitmap))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("r,w,ragged", [(64, 4, False), (96, 6, False), (45, 3, True),
                                        (64, 4, "zeros"), (64, 4, "ones"), (8, 2048, True)])
def test_col_reduce_matches_jax(r, w, ragged):
    rng = np.random.default_rng(r + w)
    bitmap = _fill(rng.integers(0, 2**32, (r, w), dtype=np.uint32), ragged)
    vals = np.where(rng.random(r) < 0.4, BIG, rng.integers(0, 10_000, r)).astype(np.int32)
    weights = (rng.random(r) < 0.8).astype(np.int32)
    if ragged is True:
        jmin, jsum = jax_col_reduce_ref(jnp.asarray(bitmap), jnp.asarray(vals), jnp.asarray(weights), BIG)
    else:
        jmin, jsum = col_reduce_pallas(jnp.asarray(bitmap), jnp.asarray(vals), jnp.asarray(weights),
                                       row_tile=32, word_tile=2, interpret=True)
    tmin, tsum = col_reduce(_t(bitmap), _t(vals), _t(weights))
    np.testing.assert_array_equal(np.asarray(jmin), tmin.numpy())
    np.testing.assert_array_equal(np.asarray(jsum), tsum.numpy())


def test_label_prop_update_is_the_reference_round_step():
    """The update kernel's plain version equals the reference round's
    scatter-min + pointer jump (ops.py) written out in numpy."""
    rng = np.random.default_rng(3)
    cap, r = 96, 40
    rows = np.sort(rng.choice(cap, r, replace=False))
    core_r = rng.random(r) < 0.7
    lab = np.where(rng.random(cap) < 0.6, rng.integers(0, cap, cap), BIG).astype(np.int32)
    m = np.where(rng.random(r) < 0.8, rng.integers(0, cap, r), BIG).astype(np.int32)
    new_r = np.where(core_r, np.minimum(lab[rows], m), BIG)
    new = lab.copy()
    np.minimum.at(new, rows, new_r)
    jump = np.where(new < cap, new, 0)
    want = np.where(new < cap, np.minimum(new, new[jump]), new)
    pos = np.full(cap, -1, np.int32)
    pos[rows[core_r]] = np.nonzero(core_r)[0]
    got = label_prop_update_ref(_t(lab), _t(m), _t(pos)).numpy()
    np.testing.assert_array_equal(got, want)
    out, flags = torch.empty(cap, dtype=torch.int32), torch.tensor([1, 0], dtype=torch.int32)
    label_prop_update(_t(lab), _t(m), _t(pos), out, flags, 0)
    np.testing.assert_array_equal(out.numpy(), want)
    assert int(flags[1]) == int((want != lab).any())
    flags[0] = 0  # a clear flag makes the round a no-op
    out2 = torch.full((cap,), -5, dtype=torch.int32)
    label_prop_update(_t(lab), _t(m), _t(pos), out2, flags, 0)
    assert (out2 == -5).all()


@pytest.mark.parametrize("n,pad_rows", [(96, 0), (117, 5), (45, 3)])
def test_packed_cluster_labels_matches_jax(n, pad_rows):
    rng = np.random.default_rng(n)
    adj = rng.random((n, n)) < 0.08
    adj = adj | adj.T
    np.fill_diagonal(adj, True)
    rows = np.sort(rng.choice(n, max(8, n - 7), replace=False))
    slab = pack_bitmap(adj[rows])
    rows_op = np.concatenate([rows, np.full(pad_rows, n)]).astype(np.int32)
    slab = np.concatenate([slab, np.zeros((pad_rows, slab.shape[1]), np.uint32)])
    j = jax.device_get(jax_packed_cluster_labels(
        jnp.asarray(slab), jnp.asarray(rows_op), 5, n=n, row_tile=32, word_tile=2, interpret=True))
    t = [x.numpy() for x in packed_cluster_labels(_t(slab), torch.from_numpy(rows_op), 5, n=n)]
    for a, b in zip(j[:3], t[:3]):  # labels, owner, col_sum over the live columns
        np.testing.assert_array_equal(np.asarray(a)[:n], b[:n])
    np.testing.assert_array_equal(np.asarray(j[3])[: len(rows_op)], t[3])
    assert int(j[4]) == int(t[4])  # identical round count


def test_chain_graph_pointer_jump_round_bound():
    """Path graph (worst-case diameter): the pointer jump keeps rounds
    logarithmic, far under the trip cap, and equal to the reference's."""
    n = 200
    adj = np.zeros((n, n), bool)
    idx = np.arange(n - 1)
    adj[idx, idx + 1] = True
    adj = adj | adj.T
    np.fill_diagonal(adj, True)
    slab, rows = pack_bitmap(adj), np.arange(n, dtype=np.int32)
    labels, _, _, _, rounds = packed_cluster_labels(_t(slab), torch.from_numpy(rows), 2, n=n)
    j = jax.device_get(jax_packed_cluster_labels(
        jnp.asarray(slab), jnp.asarray(rows), 2, n=n, row_tile=64, word_tile=2, interpret=True))
    assert (labels[:n] == 0).all()
    assert int(rounds) < 16
    assert int(rounds) == int(j[4])


def _path_adjacency(n):
    adj = np.zeros((n, n), bool)
    idx = np.arange(n - 1)
    adj[idx, idx + 1] = True
    adj = adj | adj.T
    np.fill_diagonal(adj, True)
    return adj


# (n, graph, max_iters, telemetry): random slabs with every row core or
# some not, and a path graph whose propagation max_iters cuts short
@pytest.mark.parametrize("n,graph,max_iters,telemetry", [
    (96, "random", 64, False), (117, "random", 64, True), (200, "path", 3, False), (200, "path", 3, True),
    (200, "path", 64, True),
])
def test_label_prop_fixpoint_rect_matches_jax(n, graph, max_iters, telemetry):
    """The fixpoint in rect mode (pass 2's, ``packed_cluster_fixpoint``):
    the plain version and the wrapper on the CPU against the JAX
    fixpoint (Pallas K2 in interpret mode) on the same slab: labels,
    rounds and the four telemetry rows."""
    if graph == "path":
        adj, rows, tau = _path_adjacency(n), np.arange(n), 2
    else:
        rng = np.random.default_rng(n)
        adj = rng.random((n, n)) < 0.06
        adj = adj | adj.T
        np.fill_diagonal(adj, True)
        rows, tau = np.sort(rng.choice(n, n - 9, replace=False)), 5
    slab = pack_bitmap(adj[rows])
    rows = rows.astype(np.int32)
    j = jax.device_get(jax_packed_cluster_labels(
        jnp.asarray(slab), jnp.asarray(rows), tau, n=n, max_iters=max_iters, row_tile=32, word_tile=2,
        interpret=True, telemetry=telemetry))
    bitmap = _t(slab)
    cap = bitmap.shape[1] * 32
    _, _, _, _, pos, init = fixpoint_inputs(bitmap, torch.from_numpy(rows), tau, n=n, cap=cap)
    for fixpoint in (label_prop_fixpoint_ref, label_prop_fixpoint):
        bufs = (init.clone(), torch.empty_like(init))
        m = torch.empty(len(rows), dtype=torch.int32)
        flags = torch.zeros(max_iters + 1, dtype=torch.int32)
        flags[0] = 1
        tele = torch.zeros((4, max_iters), dtype=torch.int32) if telemetry else None
        fixpoint(bitmap, bufs, m, pos, flags, tele=tele)
        rounds = int(flags[:max_iters].sum())
        assert rounds == int(j[4])
        np.testing.assert_array_equal(bufs[rounds % 2][:n].numpy(), np.asarray(j[0])[:n])
        if telemetry:
            for k in range(4):
                np.testing.assert_array_equal(tele[k].numpy(), np.asarray(j[5][k]))
    if graph == "path":
        assert (rounds == max_iters) == (max_iters == 3)  # cut short, or converged well inside 64


def test_label_prop_fixpoint_validates_operands():
    bitmap = torch.zeros((4, 2), dtype=torch.int32)
    bufs = (torch.zeros(64, dtype=torch.int32), torch.zeros(64, dtype=torch.int32))
    m, pos, flags = torch.zeros(4, dtype=torch.int32), torch.full((64,), -1, dtype=torch.int32), torch.ones(3, dtype=torch.int32)
    label_prop_fixpoint(bitmap, bufs, m, pos, flags)  # well formed
    with pytest.raises(ValueError, match="distinct"):
        label_prop_fixpoint(bitmap, (bufs[0], bufs[0]), m, pos, flags)
    with pytest.raises(ValueError, match="bufs"):
        label_prop_fixpoint(bitmap, (bufs[0][:32], bufs[1]), m, pos, flags)
    with pytest.raises(ValueError, match="m must"):
        label_prop_fixpoint(bitmap, bufs, m[:3], pos, flags)
    with pytest.raises(ValueError, match="flags"):
        label_prop_fixpoint(bitmap, bufs, m, pos, flags.long())
    with pytest.raises(ValueError, match="tele"):
        label_prop_fixpoint(bitmap, bufs, m, pos, flags, tele=torch.zeros((4, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="square"):
        label_prop_fixpoint(torch.zeros((65, 2), dtype=torch.int32), bufs, torch.zeros(65, dtype=torch.int32),
                            pos, flags, square=True)
