"""Port parity for EmbeddingBag (``repro_torch.kernels.embedding_bag``)
against the JAX package: its wrapper ``embedding_bag`` (the Pallas
kernel in interpret mode, its default) and its oracle
``embedding_bag_ref``, on the same numpy inputs.

Tolerances:
* fp32 tables: rtol = atol = 1e-5, the reference's own tolerance for its
  kernel against the oracle (``tests/test_kernels.py``): the bag sums
  run over at most 39 rows in other orders.
* bf16 tables: both convert the rows exactly to fp32 and sum in fp32,
  so the same 1e-5 holds against the JAX kernel (its oracle sums in
  bf16 and is not compared).
* padding, clamping and an all-padding bag: exact (each is a sum of the
  same rows, or 0).

On the CPU the port's wrapper runs its plain version (``ref.py``); the
``gpu`` tests hold the CUDA kernel to it on the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels.embedding_bag.ops import embedding_bag as jax_embedding_bag
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_ref

from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.ops import LAUNCHES
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.obs import metrics

TOL = 1e-5
SHAPES = [(100, 8, 16, 4), (1000, 16, 37, 9), (5000, 64, 24, 39)]  # (V, D, B, L), tests/test_kernels.py:150


def _inputs(v, d, b, l, seed, low=-1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((v, d)).astype(np.float32),
            rng.integers(low, v, size=(b, l)).astype(np.int32))


def _port(table, ids, combiner, dtype=torch.float32):
    return embedding_bag(torch.from_numpy(table).to(dtype), torch.from_numpy(ids), combiner=combiner)


@pytest.mark.parametrize("v,d,b,l", SHAPES)
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_matches_jax(v, d, b, l, combiner):
    table, ids = _inputs(v, d, b, l, seed=v + b)
    kern = np.asarray(jax_embedding_bag(jnp.asarray(table), jnp.asarray(ids), combiner=combiner, batch_tile=8))
    oracle = np.asarray(jax_ref(jnp.asarray(table), jnp.asarray(ids), combiner=combiner))
    got = _port(table, ids, combiner)
    assert got.shape == (b, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), kern, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_all_padding_bag_is_zero(combiner):
    table = np.ones((10, 4), np.float32)
    ids = np.array([[-1] * 5, [-2, 3, -1, -1, 3], [-1] * 5], np.int32)
    kern = np.asarray(jax_embedding_bag(jnp.asarray(table), jnp.asarray(ids), combiner=combiner, batch_tile=1))
    got = _port(table, ids, combiner).numpy()
    assert (got[[0, 2]] == 0).all() and (got[1] == (2.0 if combiner == "sum" else 1.0)).all()
    np.testing.assert_array_equal(got, kern)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_bf16_table_matches_jax(combiner):
    table, ids = _inputs(50, 8, 8, 3, seed=0, low=0)
    jt = jnp.asarray(table, jnp.bfloat16)
    kern = np.asarray(jax_embedding_bag(jt, jnp.asarray(ids), combiner=combiner, batch_tile=4))
    got = _port(np.array(jt.astype(jnp.float32)), ids, combiner, torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), kern, rtol=TOL, atol=TOL)


def test_every_negative_id_is_padding_and_large_ids_clamp():
    """Ids [-3, 1, 2] sum rows 1 and 2 (every negative id is padding, not
    only -1); an id >= V reads row V - 1, as the TPU kernel's gather
    clamps."""
    table, _ = _inputs(20, 8, 1, 1, seed=4)
    ids = np.array([[-3, 1, 2], [25, -100, 19], [20, 20, -1]], np.int32)
    for combiner in ("sum", "mean"):
        kern = np.asarray(jax_embedding_bag(jnp.asarray(table), jnp.asarray(ids), combiner=combiner, batch_tile=1))
        got = _port(table, ids, combiner).numpy()
        np.testing.assert_allclose(got, kern, rtol=TOL, atol=TOL)
    got = _port(table, ids, "sum").numpy()
    np.testing.assert_array_equal(got[0], table[1] + table[2])
    np.testing.assert_array_equal(got[1], table[19] + table[19])
    np.testing.assert_array_equal(got[2], table[19] + table[19])


def test_embedding_bag_validates_operands():
    table, ids = torch.zeros((10, 4)), torch.zeros((3, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="combiner"):
        embedding_bag(table, ids, combiner="max")
    with pytest.raises(ValueError):
        embedding_bag(table[0], ids)
    with pytest.raises(ValueError):
        embedding_bag(table[:0], ids)
    with pytest.raises(TypeError):
        embedding_bag(table.double(), ids)
    with pytest.raises(TypeError):
        embedding_bag(table, ids.long())
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(table.T, ids)


@pytest.fixture
def metrics_on():
    was = metrics.enabled()
    metrics.enable()
    yield metrics
    if not was:
        metrics.disable()


# (V, D, B, L, lowest id, dtype): the CPU shapes, bst's user tower
# (D 32, L 20), a ragged last block, D above one pass of 256 columns,
# ids past V (clamped) and other negative ids
GPU_CASES = [(v, d, b, l, -1, torch.float32) for v, d, b, l in SHAPES] + [
    (100_000, 32, 4099, 20, 0, torch.float32),
    (5000, 300, 17, 7, -3, torch.float32),
    (5000, 18, 1000, 100, -2, torch.bfloat16),
    (5000, 64, 9, 33, -1, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_gpu_embedding_bag_matches_plain(combiner, metrics_on):
    """Kernel against the plain version on the card: the same fp32 sums
    in another order, within 2·L·2^-24·Σ|row| (+ one rounding of the
    mean) of each other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    launches = metrics.counter(LAUNCHES["embedding_bag"])
    for v, d, b, l, low, dtype in GPU_CASES:
        table, ids = _inputs(v, d, b, l, seed=v + b + d, low=low)
        ids[0, 0] = v + 7  # clamped to row V - 1
        t, i = torch.from_numpy(table).to(dev, dtype), torch.from_numpy(ids).to(dev)
        before = launches.value
        got = embedding_bag(t, i, combiner=combiner)
        torch.cuda.synchronize()
        assert launches.value == before + 1
        want = embedding_bag_ref(t, i, combiner=combiner)
        scale = embedding_bag_ref(t.abs(), i, combiner=combiner)
        err = (got - want).abs()
        assert bool((err <= 2 * l * 2.0 ** -24 * scale + 2.0 ** -23 * want.abs()).all()), (v, d, b, l, dtype)


# The kernel's mapping at its edges (chip_smoke.py's EB_EDGES mirror
# them): (D, L, B, dtype, offset).  D across 16-byte pieces (1, 3: under
# one; 33, 100, 130: not whole pieces or lanes; 256: two passes of 32
# lanes), bf16 with odd D, L across a batch of slots (1, 20, 33, 64), B not
# a multiple of a block's bags, and offset 1: a table view 4 (bf16: 2)
# bytes past a 16-byte boundary.
EDGE_CASES = ([(d, 20, 1003, torch.float32, 0) for d in (1, 3, 4, 32, 33, 64, 100, 128, 130, 256)]
              + [(d, 20, 1003, torch.bfloat16, 0) for d in (1, 3, 33, 129)]
              + [(32, length, 4099, torch.float32, 0) for length in (1, 20, 33, 64)]
              + [(32, 20, 4099, torch.float32, 1), (64, 20, 4099, torch.bfloat16, 1), (33, 7, 1003, torch.float32, 1)])


@pytest.mark.gpu
@pytest.mark.parametrize("d,length,b,dtype,offset", EDGE_CASES)
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_gpu_embedding_bag_edges(d, length, b, dtype, offset, combiner, metrics_on):
    """The same bound as above at the mapping's edges, with bag 0 all
    padding (exactly 0) and bag 1 all past V (row V - 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev, v = torch.device("cuda"), 5000
    g = torch.Generator().manual_seed(d * 1000 + length)
    buf = torch.randn(v * d + offset, generator=g).to(dtype)
    ids = torch.randint(-2, v + 2, (b, length), generator=g, dtype=torch.int32)
    ids[0] = -1
    ids[1] = v + torch.arange(length, dtype=torch.int32) % 3
    t, i = buf.to(dev)[offset:].view(v, d), ids.to(dev)
    assert offset == 0 or t.data_ptr() % 16 != 0
    launches = metrics.counter(LAUNCHES["embedding_bag"])
    before = launches.value
    got = embedding_bag(t, i, combiner=combiner)
    torch.cuda.synchronize()
    assert launches.value == before + 1
    want = embedding_bag_ref(t, i, combiner=combiner)
    scale = embedding_bag_ref(t.abs(), i, combiner=combiner)
    err = (got - want).abs()
    assert bool((err <= 2 * length * 2.0 ** -24 * scale + 2.0 ** -23 * want.abs()).all())
    assert bool((got[0] == 0).all())
    row = t[v - 1].float() * (1 if combiner == "mean" else length)
    assert torch.allclose(got[1], row, rtol=2 * length * 2.0 ** -24, atol=0)
