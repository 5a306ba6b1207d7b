"""Port parity for the signed-RP signatures and the packed-word helpers
(``repro_torch.index.signatures``, ``repro_torch.core.range_query``)
against the JAX package on the same numpy inputs.

Packed words must have the reference's bytes (LSB-first uint32 bits
carried in int32 tensors).  A sign bit of ``x @ r`` may differ only
where ``|x . r| < 1e-5``: there the fp32 product's sign depends on the
summation order; such bits are counted and reported.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import range_query as jrq
from repro.index import signatures as jsig

from repro_torch.core import range_query as trq
from repro_torch.index import signatures as tsig


def test_make_projection_same_draws():
    for d, n_bits, seed in [(16, 64, 0), (768, 512, 3)]:
        np.testing.assert_array_equal(
            jsig.make_projection(d, n_bits, seed), tsig.make_projection(d, n_bits, seed))
    with pytest.raises(ValueError):
        tsig.make_projection(8, 48)


@pytest.mark.parametrize("n,nd", [(5, 64), (9, 37), (3, 1), (4, 96)])
def test_pack_unpack_bytes_match(n, nd):
    rng = np.random.default_rng(n * nd)
    hits = rng.random((n, nd)) < 0.4
    ref = jrq.pack_bitmap(hits)
    np.testing.assert_array_equal(trq.pack_bitmap(hits), ref)
    t = trq.pack_bitmap_t(torch.from_numpy(hits))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(trq.unpack_bitmap_t(t, nd).numpy(), hits)
    np.testing.assert_array_equal(trq.unpack_bitmap(ref, nd), jrq.unpack_bitmap(ref, nd))
    if nd % 32 == 0:
        jb = np.array(jsig.pack_bits(jnp.asarray(hits)))
        np.testing.assert_array_equal(tsig.pack_bits(torch.from_numpy(hits)).numpy().view(np.uint32), jb)
        np.testing.assert_array_equal(
            tsig.unpack_bits(torch.from_numpy(jb.view(np.int32)), nd).numpy(),
            np.asarray(jsig.unpack_bits(jnp.asarray(jb), nd)))


def test_popcount_and_hamming_match():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, (13, 4), dtype=np.uint32)
    b = rng.integers(0, 2**32, (21, 4), dtype=np.uint32)
    b[0] = 0xFFFFFFFF  # sign bit set in every word
    want = jsig.hamming_numpy(a, b)
    np.testing.assert_array_equal(np.asarray(jsig.hamming_words(jnp.asarray(a), jnp.asarray(b))), want)
    got = tsig.hamming_words(torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tsig.hamming_numpy(a, b), want)
    pc = tsig.popcount32(torch.from_numpy(b.view(np.int32))).numpy()
    np.testing.assert_array_equal(pc, [[bin(int(v)).count("1") for v in row] for row in b])
    assert (pc[0] == 32).all()


@pytest.mark.parametrize("n,d,n_bits,seed", [(300, 16, 64, 0), (257, 32, 128, 4), (120, 768, 512, 1)])
def test_sign_signatures_match(n, d, n_bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    proj = jsig.make_projection(d, n_bits, seed)
    ref = jsig.sign_signatures(x, proj)
    got = tsig.sign_signatures(x, proj, device="cpu")
    assert got.dtype == torch.int32 and got.shape == ref.shape
    rb = np.asarray(jsig.unpack_bits(jnp.asarray(ref), n_bits))
    gb = tsig.unpack_bits(got, n_bits).numpy()
    diff = rb != gb
    near = np.abs(x.astype(np.float64) @ proj.astype(np.float64)) < 1e-5
    print(f"n={n} d={d}: {int(diff.sum())} sign bits differ, all with |x.r| < 1e-5")
    assert not (diff & ~near).any()
    if not diff.any():
        np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


def test_band_helpers_match():
    for eps in (0.05, 0.3, 0.55, 0.9, 1.0, 1.3):
        assert tsig.collision_fraction(eps) == jsig.collision_fraction(eps)
        for n_bits in (64, 512):
            for margin in (1.0, 3.0):
                assert tsig.hamming_band(eps, n_bits, margin) == jsig.hamming_band(eps, n_bits, margin)
    rng = np.random.default_rng(2)
    dots = rng.uniform(-1, 1, (8, 9)).astype(np.float32)
    ham = rng.integers(0, 64, (8, 9)).astype(np.int32)
    want = np.asarray(jsig.band_hits(jnp.asarray(dots), jnp.asarray(ham), 0.4, 10, 30))
    got = tsig.band_hits(torch.from_numpy(dots), torch.from_numpy(ham), 0.4, 10, 30).numpy()
    np.testing.assert_array_equal(got, want)
