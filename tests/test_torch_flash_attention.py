"""Port parity for blocked online-softmax attention
(``repro_torch.kernels.flash_attention``) against the JAX package: its
wrapper ``flash_attention`` (the Pallas kernel in interpret mode) and its
oracle ``attention_ref``, on the same numpy inputs.

* fp32: rtol = atol = 2e-5, the reference's own tolerance for its kernel
  against the oracle (``tests/test_kernels.py``): the frameworks sum the
  score and P·V products in different orders.
* ``blockwise_attention`` against the reference's (its jnp scan over
  kv blocks): the same 2e-5, for a v narrower than q/k (MLA's reduced
  widths, d 24 and dv 16) and query offsets off the right-aligned
  prefix view (``q_offset`` below and above ``valid_len - Sq``).
* bf16 inputs: both compute in fp32 and round the output to bf16 once,
  so they differ by at most one bf16 step where the fp32 sums land on
  either side of a rounding boundary: 2^-7 = 7.8e-3 for outputs below 2
  in magnitude, so rtol = atol = 8e-3.

* the decode mapping's merge (``merge_partials_ref``): softmax partials
  (m, l, acc) taken chunk by chunk over the keys and merged equal the
  JAX kernel within the same 2e-5, for uneven chunks, chunks that the
  causal mask or the window masks wholly, an empty chunk and rows that
  no chunk reaches (0, no NaN).
* the bf16 prefill's two-term P·V, emulated in plain torch, holds the
  card's gate (one bf16 step of the fp32-P value, ``flash_gap`` in
  ``chip_smoke.py``); P rounded once to bf16 does not.

On the CPU the port's wrapper runs its plain version (``ref.py``); the
``gpu`` test holds the CUDA kernel to it on the card.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models.layers import blockwise_attention as jax_blockwise

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import (
    DECODE_GROUP, DECODE_TILE, HEAD_DIMS, HEAD_PAIRS, LAUNCHES, SMS, decode_splits,
)
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref, merge_partials_ref
from repro_torch.models import layers
from repro_torch.models.layers import blockwise_attention
from repro_torch.obs import metrics

TOL = 2e-5
TOL_BF16 = 8e-3

# (B, Hq, Hkv, Sq, Sk, D, causal, window)
CASES = [
    (2, 2, 2, 64, 64, 32, True, None),     # causal
    (2, 2, 2, 64, 64, 16, False, None),    # non-causal
    (1, 4, 4, 64, 64, 32, True, 16),       # sliding window 16
    (1, 8, 2, 48, 48, 16, True, None),     # GQA 8/2
    (2, 4, 1, 32, 32, 16, True, None),     # MQA
    (2, 4, 2, 8, 40, 16, True, None),      # Sq < Sk, right-aligned
    (2, 8, 2, 1, 77, 32, True, None),      # decode, ragged Sk
    (2, 4, 1, 1, 77, 16, True, 16),        # decode with a window
    # D 64 (B8d): the LM examples' width, at train_lm's heads (10 over 2)
    (2, 2, 2, 64, 64, 64, True, None),     # causal
    (1, 2, 2, 48, 48, 64, False, None),    # non-causal
    (1, 4, 4, 64, 64, 64, True, 16),       # sliding window 16
    (1, 10, 2, 32, 32, 64, True, None),    # GQA 10/2
    (2, 10, 2, 1, 77, 64, True, None),     # decode, ragged Sk
]


def _qkv(case, seed, dtype=np.float32):
    b, hq, hkv, sq, sk, d = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(dtype),
            rng.standard_normal((b, hkv, sk, d)).astype(dtype),
            rng.standard_normal((b, hkv, sk, d)).astype(dtype))


def _jax_both(q, k, v, causal, window, dtype=jnp.float32):
    """The JAX wrapper (interpret mode) and the oracle (kv heads repeated,
    as the wrapper does)."""
    rep = q.shape[1] // k.shape[1]
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    kern = np.asarray(jax_flash(jq, jk, jv, causal=causal, window=window, interpret=True), np.float32)
    oracle = np.asarray(jax_ref(jq, jnp.repeat(jk, rep, 1), jnp.repeat(jv, rep, 1), causal=causal, window=window),
                        np.float32)
    return kern, oracle


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_matches_jax(case):
    causal, window = case[6], case[7]
    q, k, v = _qkv(case, seed=sum(case[:6]))
    kern, oracle = _jax_both(q, k, v, causal, window)
    np.testing.assert_allclose(kern, oracle, rtol=TOL, atol=TOL)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), kern, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=TOL, atol=TOL)


def test_flash_attention_bf16_matches_jax():
    case = (1, 4, 2, 64, 64, 32, True, None)
    q, k, v = _qkv(case, seed=5)
    kern, _ = _jax_both(q, k, v, True, None, jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), kern, rtol=TOL_BF16, atol=TOL_BF16)


def test_flash_attention_scale_and_strided_views():
    """An explicit scale, and q/k/v as head-major views of (B, S, H, D)
    projections (the model's layout), equal the contiguous call."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 24, 3, 4, 16)).astype(np.float32))
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    got = flash_attention(q, k, v, causal=True, scale=0.3)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True, scale=0.3)
    assert torch.equal(got, want)
    oracle = np.asarray(jax_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=True, scale=0.3))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=TOL, atol=TOL)


def test_fully_masked_rows_are_zero():
    """More queries than keys, causal: the first Sq - Sk queries see no
    key; the kernel's clamped normalizer gives 0 there (the oracle's -inf
    gives NaN), every other row matches the oracle."""
    q, k, v = _qkv((1, 2, 2, 12, 8, 16), seed=7)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True).numpy()
    oracle = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    assert (got[:, :, :4] == 0).all() and np.isnan(oracle[:, :, :4]).all()
    np.testing.assert_allclose(got[:, :, 4:], oracle[:, :, 4:], rtol=TOL, atol=TOL)


def test_flash_attention_validates_operands():
    q = torch.zeros((1, 4, 8, 16))
    kv = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 3, 8, 16)), torch.zeros((1, 3, 8, 16)))
    with pytest.raises(ValueError):
        flash_attention(q, kv, torch.zeros((1, 2, 8, 32)))
    with pytest.raises(ValueError):
        flash_attention(q, kv[:, :, :0], kv[:, :, :0])
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv, window=0)
    with pytest.raises(TypeError):
        flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(TypeError):
        flash_attention(q, kv.to(torch.bfloat16), kv)
    # v narrower than q/k only at an instantiated pair
    for d, dv in ((128, 64), (192, 64), (32, 16)):
        assert (d, dv) not in HEAD_PAIRS
        with pytest.raises(ValueError, match="v width"):
            flash_attention(torch.zeros((1, 2, 8, d)), torch.zeros((1, 2, 8, d)), torch.zeros((1, 2, 8, dv)))


# (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, q_offset, valid_len)
OFFSET_CASES = [
    (2, 4, 4, 16, 40, 24, 16, True, None, None, None),     # MLA's reduced widths, right-aligned
    (1, 4, 2, 1, 40, 24, 16, True, None, 20, 21),          # MLA widths, a decode step into a cache
    (2, 4, 2, 8, 40, 16, 32, True, None, 3, 30),           # dv > d; q_offset < valid_len - Sq
    (2, 4, 2, 6, 40, 16, 16, True, None, 5, 30),           # q_offset < valid_len - Sq
    (2, 4, 2, 6, 40, 16, 16, False, None, 5, 30),
    (2, 4, 2, 6, 40, 16, 16, True, None, 27, 30),          # q_offset + Sq > valid_len
    (2, 4, 2, 6, 40, 16, 16, False, None, 27, 30),
    (1, 2, 1, 12, 24, 32, 32, True, 4, 40, None),          # every query past the keys, windowed: no key left
    (2, 2, 2, 4, 24, 16, 16, True, None, -3, 10),          # queries before the first key: none left
    (2, 2, 1, 5, 24, 16, 16, True, None, 2, 30),           # valid_len past Sk
]


def _offset_inputs(case):
    b, hq, hkv, sq, sk, d, dv = case[:7]
    rng = np.random.default_rng(sum(case[:7]))
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, dv)).astype(np.float32))


@pytest.mark.parametrize("case", OFFSET_CASES, ids=lambda c: "-".join(map(str, c)))
def test_blockwise_attention_general_offsets_match_jax(case):
    causal, window, q_offset, valid_len = case[7:]
    q, k, v = _offset_inputs(case)
    want = np.asarray(jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
                                    q_offset=q_offset, kv_block=8, valid_len=valid_len))
    got = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
                              window=window, q_offset=q_offset, kv_block=8, valid_len=valid_len)
    assert got.shape == q.shape[:3] + (v.shape[-1],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _chunk_partials(q, k, v, bounds, causal, window):
    """``attention_ref``'s arithmetic over each key chunk [lo, hi), queries
    right-aligned: (m, l, acc) in fp32, an empty chunk (-1e30, 0, 0)."""
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    ms, ls, accs = [], [], []
    for lo, hi in bounds:
        if hi == lo:
            ms.append(torch.full((b, h, sq), NEG_INF))
            ls.append(torch.zeros((b, h, sq)))
            accs.append(torch.zeros((b, h, sq, d)))
            continue
        kpos = torch.arange(lo, hi)[None, :]
        mask = torch.ones((sq, hi - lo), dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, lo:hi]).mul_(1 / math.sqrt(d)).masked_fill_(~mask, NEG_INF)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None]).masked_fill_(~mask, 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(p @ v[:, :, lo:hi])
    return torch.stack(ms, dim=-1), torch.stack(ls, dim=-1), torch.stack(accs, dim=-2)


# (B, H, Sq, Sk, D, causal, window, chunk bounds)
MERGE_CASES = {
    "uneven": (1, 2, 16, 40, 16, False, None, [(0, 7), (7, 20), (20, 40)]),
    "causal_masks_a_chunk": (2, 2, 16, 24, 16, True, None, [(0, 8), (8, 16), (16, 24)]),
    "window_masks_a_chunk": (1, 2, 32, 32, 32, True, 8, [(0, 8), (8, 16), (16, 24), (24, 32)]),
    "trailing_empty_chunk": (1, 2, 8, 24, 16, False, None, [(0, 10), (10, 24), (24, 24)]),
    "no_key_left": (1, 2, 12, 8, 16, True, None, [(0, 3), (3, 8)]),
}


@pytest.mark.parametrize("name", list(MERGE_CASES))
def test_merge_partials_matches_jax(name):
    b, h, sq, sk, d, causal, window, bounds = MERGE_CASES[name]
    q, k, v = _qkv((b, h, h, sq, sk, d), seed=sq + sk + d)
    m, l, acc = _chunk_partials(q, k, v, bounds, causal, window)
    got = merge_partials_ref(m, l, acc).numpy()
    want = np.asarray(jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=window, interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if name == "causal_masks_a_chunk":  # rows 0..7 (positions 8..15) see nothing of the last chunk
        assert (m[:, :, :8, 2] == NEG_INF).all() and (l[:, :, :8, 2] == 0).all()
    if name == "window_masks_a_chunk":  # rows 16.. see nothing of the first chunk
        assert (m[:, :, 16:, 0] == NEG_INF).all() and (l[:, :, 16:, 0] == 0).all()
    if name == "no_key_left":  # the first Sq - Sk queries: every chunk masked, output 0
        assert (got[:, :, : sq - sk] == 0).all()


@pytest.mark.parametrize("b, hkv, rep, sk", [(4, 8, 4, 1088), (16, 8, 4, 32768), (4, 8, 4, 1), (4, 8, 4, 385),
                                             (1, 1, 1, 77), (2, 8, 8, 4097), (64, 8, 4, 4096), (33, 8, 1, 500)])
def test_decode_splits_cover_the_keys_in_whole_tiles(b, hkv, rep, sk):
    n_split, per = decode_splits(b, hkv, rep, sk)
    blocks = b * hkv * -(-rep // DECODE_GROUP)
    starts = [i * per * DECODE_TILE for i in range(n_split)]
    ends = [min(x + per * DECODE_TILE, sk) for x in starts]
    assert starts[0] == 0 and ends[-1] == sk and ends[:-1] == starts[1:]
    assert all(lo < hi for lo, hi in zip(starts, ends))  # every split holds a key
    if blocks >= 2 * SMS:  # the grid already fills the card
        assert n_split == 1
    elif -(-sk // DECODE_TILE) >= -(-2 * SMS // blocks):  # keys enough for two blocks an SM
        assert n_split * blocks >= 2 * SMS


def test_decode_splits_at_the_decode_path():
    """B 4, Hkv 8, Sk 1088: 32 blocks become at least two an SM; B 64
    fills the card unsplit."""
    n_split, per = decode_splits(4, 8, 4, 1088)
    assert 4 * 8 * n_split >= 2 * SMS and per >= 1
    assert decode_splits(64, 8, 4, 1088)[0] == 1


def test_two_term_bf16_p_holds_the_card_gate():
    """P·V with P = bf16(p) + bf16(p - bf16(p)) (the tensor-core prefill)
    against fp32 p, at B 1, H 4, S 512, D 128, causal, bf16 inputs: l
    from the fp32 p, sums in fp64 so that only P's rounding differs,
    both outputs rounded to bf16.  Every output is within one bf16 step
    of the plain value (2^-7 |plain| + 1e-5); P rounded once is not."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).double() for a in _qkv((1, 4, 4, 512, 512, 128), seed=17))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() / math.sqrt(128)
    mask = torch.ones((512, 512), dtype=torch.bool).tril_()
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill_(~mask, 0.0)  # fp32 probabilities
    l = p.double().sum(dim=-1, keepdim=True)

    def out(pp):
        return ((pp.double() @ v) / l).to(torch.bfloat16).double()

    plain = out(p)
    hi = p.to(torch.bfloat16).float()
    two_term = out(hi.double() + (p - hi).to(torch.bfloat16).double())
    one_term = out(hi)
    gate = 2.0 ** -7 * plain.abs() + 1e-5
    assert ((two_term - plain).abs() <= gate).all()
    assert ((one_term - plain).abs() > gate).any()


@pytest.fixture
def metrics_on():
    was = metrics.enabled()
    metrics.enable()
    yield metrics
    if not was:
        metrics.disable()


GPU_CASES = CASES + [
    (2, 32, 8, 200, 200, 128, True, None),   # llama3-8b heads, ragged tiles
    (3, 32, 8, 1, 1000, 128, True, None),    # its decode shape
    (1, 8, 8, 130, 300, 128, True, 100),     # window across tiles
    (1, 6, 2, 1, 50, 128, False, None),      # decode, 3 heads a group
    (2, 4, 2, 70, 70, 16, True, None),       # prefill at each head width, S not a multiple of 128
    (2, 4, 2, 200, 200, 32, True, None),
    (2, 4, 4, 70, 70, 128, False, None),     # Hq/Hkv 1
    (2, 16, 2, 200, 200, 128, True, None),   # Hq/Hkv 8
    (2, 16, 2, 1, 300, 128, True, None),     # decode, Hq/Hkv 8: two groups of 4
    (2, 4, 4, 1, 300, 32, True, None),       # decode, Hq/Hkv 1
    (4, 32, 8, 1, 385, 128, True, None),     # decode, 7 splits: the last holds 1 key
    (4, 32, 8, 1, 1088, 128, True, None),    # the decode path's full cache: 9 splits
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_flash_attention_matches_plain(dtype, metrics_on):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    launches = metrics.counter(LAUNCHES["flash_attention"])
    tol = TOL if dtype == torch.float32 else TOL_BF16
    for case in GPU_CASES:
        q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in _qkv(case, seed=sum(case[:6])))
        before = launches.value
        got = flash_attention(q, k, v, causal=case[6], window=case[7])
        torch.cuda.synchronize()
        assert launches.value == before + 1
        want = attention_ref(q, k, v, causal=case[6], window=case[7])
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol,
                                   err_msg=str(case))
    # decode cache prefixes (strided, no copy) and head-major views, one
    # split and several
    rng = np.random.default_rng(1)
    for shape, n in [((2, 2, 2, 64, 32), 37), ((2, 4, 8, 1200, 128), 1089)]:
        cache = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, dtype)
        q = torch.from_numpy(rng.standard_normal((shape[1], 1, 4 * shape[2], shape[4]), np.float32))
        q = q.to(dev, dtype).transpose(1, 2)
        got = flash_attention(q, cache[0][:, :, :n], cache[1][:, :, :n], causal=True)
        want = attention_ref(q, cache[0][:, :, :n], cache[1][:, :, :n], causal=True)
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol,
                                   err_msg=str(shape))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_blockwise_attention_offsets_match_plain(dtype, metrics_on):
    """D 32 with dv 16 (v padded to the kernel's width), shifted query
    offsets and windows with offsets, prefill and decode mappings, D 16,
    32 and 128: kernel against plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    launches = metrics.counter(LAUNCHES["flash_attention"])
    tol = TOL if dtype == torch.float32 else TOL_BF16
    for case in [(2, 8, 2, 70, 200, 32, 16, True, None, 11, 150), (2, 8, 2, 70, 200, 32, 16, False, 40, 120, 150),
                 (3, 8, 2, 1, 200, 32, 16, True, None, 63, 190), (2, 4, 4, 33, 100, 32, 32, True, 16, 90, 64),
                 (2, 8, 2, 150, 300, 128, 128, True, 64, 100, 280),   # window and offset, prefill at D 128
                 (2, 8, 2, 1, 300, 32, 32, True, 40, 250, 280),       # window and offset, decode
                 (2, 8, 2, 200, 300, 16, 16, True, 48, 30, 300)]:     # window and offset, prefill at D 16
        q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in _offset_inputs(case))
        causal, window, q_offset, valid_len = case[7:]
        before = launches.value
        got = blockwise_attention(q, k, v, causal=causal, window=window, q_offset=q_offset, valid_len=valid_len)
        torch.cuda.synchronize()
        assert launches.value == before + 1
        n = valid_len
        want = attention_ref(q, k[:, :, :n], v[:, :, :n], causal=causal, window=window, q_offset=q_offset,
                             scale=1 / np.sqrt(q.shape[-1]))
        assert got.shape == want.shape == q.shape[:3] + (v.shape[-1],)
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol,
                                   err_msg=str(case))


# ---------------------------------------------------------------------------
# D 64 (B8d): the LM examples' width, handed to the kernel as it is
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, S, causal, window)
D64_CASES = [
    (2, 2, 2, 40, True, None),     # causal
    (1, 2, 2, 40, False, None),    # non-causal
    (1, 4, 4, 48, True, 12),       # windowed
    (1, 10, 2, 32, True, None),    # GQA: train_lm's 10 query heads over 2
]


def _kernel_widths(monkeypatch):
    """The (q, k, v) widths each ``flash_attention`` call from
    ``models.layers`` hands the kernel (a spy on the wrapper)."""
    widths, kernel = [], layers.flash_attention

    def spy(q, k, v, **kw):
        widths.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return kernel(q, k, v, **kw)

    monkeypatch.setattr(layers, "flash_attention", spy)
    return widths


@pytest.mark.parametrize("case", D64_CASES, ids=lambda c: "-".join(map(str, c)))
def test_d64_blockwise_attention_matches_jax(case, monkeypatch):
    """``blockwise_attention`` at D 64 against the reference's jnp
    function, with the kernel handed width 64 (no padding to 128)."""
    b, hq, hkv, s, causal, window = case
    rng = np.random.default_rng(64 + sum(case[:4]))
    q = rng.standard_normal((b, hq, s, 64)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, s, 64)).astype(np.float32) for _ in range(2))
    widths = _kernel_widths(monkeypatch)
    got = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
                              window=window)
    assert widths == [(64, 64, 64)]
    want = np.asarray(jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
                                    kv_block=16))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d, width", [(48, 64), (64, 64), (100, 128), (128, 128)])
def test_attention_pads_to_the_narrowest_instantiated_width(d, width, monkeypatch):
    """A width in ``HEAD_DIMS`` reaches the kernel as it is; another is
    zero-padded to the narrowest one that holds it (48 now runs at 64,
    not 128), at the scale of its own width."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 24, d)).astype(np.float32)) for _ in range(3))
    widths = _kernel_widths(monkeypatch)
    got = blockwise_attention(q, k, v, causal=True)
    assert widths == [(width, width, width)] and got.shape == (1, 4, 24, d)
    np.testing.assert_allclose(got.numpy(), attention_ref(q, k, v, causal=True).numpy(), rtol=TOL, atol=TOL)

# ---------------------------------------------------------------------------
# D 192: MLA's concatenated q/k (128 + 64), its v (128) padded to it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_mla_widths_match_jax(causal):
    """q/k 192 and v 128 through ``blockwise_attention`` against the
    reference's jnp function, and the padded call (v 192) through
    ``flash_attention`` against the Pallas kernel in interpret mode and
    its oracle, at small S; the padding runs at the narrowest width in
    ``HEAD_DIMS`` that holds both."""
    assert HEAD_DIMS == (16, 32, 64, 128, 192)
    rng = np.random.default_rng(192)
    q, k = (rng.standard_normal((1, 2, 40, 192)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((1, 2, 40, 128)).astype(np.float32)
    want = np.asarray(jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, kv_block=16))
    got = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal)
    assert got.shape == (1, 2, 40, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    v192 = np.concatenate([v, np.zeros((1, 2, 40, 64), np.float32)], axis=-1)
    kern, oracle = _jax_both(q, k, v192, causal, None)
    np.testing.assert_allclose(kern, oracle, rtol=TOL, atol=TOL)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v192), causal=causal)
    np.testing.assert_allclose(out.numpy(), kern, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out[..., :128].numpy(), want, rtol=TOL, atol=TOL)
    assert not out[..., 128:].any()


# (B, Hq, Hkv, Sq, Sk, causal, window, q_offset): MLA's (192, 128) pair at
# small S: ragged S, GQA, Sq < Sk, a window, offsets off the right-aligned
# default (queries before the keys' end, and past it)
PAIR_CASES = [
    (1, 2, 2, 40, 40, True, None, None),
    (1, 2, 2, 40, 40, False, None, None),
    (2, 4, 2, 33, 33, True, None, None),
    (1, 2, 1, 12, 40, False, None, None),
    (1, 2, 2, 48, 48, True, 10, None),
    (1, 2, 2, 10, 40, True, None, 5),
    (1, 2, 2, 10, 40, True, None, 35),
]


def _pair_inputs(case):
    b, hq, hkv, sq, sk = case[:5]
    rng = np.random.default_rng(sum(case[:5]) + 128)
    return (rng.standard_normal((b, hq, sq, 192)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, 192)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, 128)).astype(np.float32))


@pytest.mark.parametrize("case", PAIR_CASES, ids=lambda c: "-".join(map(str, c)))
def test_head_pair_flash_attention_matches_jax(case):
    """``flash_attention`` takes MLA's (192, 128) pair (``HEAD_PAIRS``)
    with v at its own width and returns (..., 128): on the CPU its plain
    version, against the JAX oracle (kv heads repeated) where the queries
    are right-aligned, and against the port's ``attention_ref`` at any
    offset, 2e-5."""
    assert (192, 128) in HEAD_PAIRS
    b, hq, hkv, sq, sk, causal, window, q_offset = case
    q, k, v = _pair_inputs(case)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
                          window=window, q_offset=q_offset)
    assert got.shape == (b, hq, sq, 128) and got.dtype == torch.float32
    want = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
                         window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    if q_offset is None:
        rep = hq // hkv
        oracle = np.asarray(jax_ref(jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, 1),
                                    jnp.repeat(jnp.asarray(v), rep, 1), causal=causal, window=window))
        np.testing.assert_allclose(got.numpy(), oracle, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", PAIR_CASES, ids=lambda c: "-".join(map(str, c)))
def test_head_pair_blockwise_attention_matches_jax(case):
    """``blockwise_attention`` at (192, 128), which hands the pair to the
    kernel's wrapper unpadded, against the reference's jnp scan, 2e-5."""
    b, hq, hkv, sq, sk, causal, window, q_offset = case
    q, k, v = _pair_inputs(case)
    want = np.asarray(jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
                                    q_offset=q_offset, kv_block=16))
    got = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
                              window=window, q_offset=q_offset)
    assert got.shape == (b, hq, sq, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# (B, Hq, Hkv, Sq, Sk, D, causal, window): the new width's mappings and the
# zoo's decode shapes at small B
GPU_ZOO_CASES = [
    (1, 4, 4, 300, 300, 192, True, None),      # D 192 prefill, ragged S
    (2, 4, 2, 129, 129, 192, True, None),      # two query tiles, GQA
    (1, 4, 4, 70, 200, 192, False, None),      # Sq < Sk, non-causal
    (1, 4, 4, 513, 513, 192, True, 100),       # window across tiles
    (2, 8, 8, 1, 1000, 192, True, None),       # D 192 decode, split over Sk
    (2, 128, 128, 1, 77, 192, True, None),     # deepseek's heads, one split
    (2, 48, 1, 1, 288, 128, True, None),       # granite's MQA decode
    (2, 48, 1, 300, 300, 128, True, None),     # granite's MQA prefill
    (2, 32, 16, 1, 1024, 128, False, None),    # gemma3's full ring: 1024 slots, unmasked
    (2, 10, 2, 256, 256, 64, True, None),      # D 64: train_lm's heads and sequence
    (1, 4, 4, 300, 300, 64, False, None),      # D 64, ragged S, non-causal
    (1, 4, 2, 513, 513, 64, True, 100),        # D 64, window across tiles
    (2, 10, 2, 1, 1000, 64, True, None),       # D 64 decode, split over Sk
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_zoo_shapes_match_plain(dtype, metrics_on):
    """D 192 in the three mappings (bf16 tensor-core prefill, fp32
    prefill, split decode), MQA (Hkv 1, Hq 48), a ring buffer's valid
    prefix (causal off, min(n, W) slots after n steps), the reduced MLA
    widths 24/16 run at 32, and a width outside ``HEAD_DIMS`` raising."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    launches = metrics.counter(LAUNCHES["flash_attention"])
    tol = TOL if dtype == torch.float32 else TOL_BF16
    for case in GPU_ZOO_CASES:
        q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in _qkv(case, seed=sum(case[:6])))
        before = launches.value
        got = flash_attention(q, k, v, causal=case[6], window=case[7])
        torch.cuda.synchronize()
        assert launches.value == before + 1
        want = attention_ref(q, k, v, causal=case[6], window=case[7])
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol,
                                   err_msg=str(case))
    rng = np.random.default_rng(5)
    ring = torch.from_numpy(rng.standard_normal((2, 2, 16, 64, 128), np.float32)).to(dev, dtype)
    q = torch.from_numpy(rng.standard_normal((2, 32, 1, 128), np.float32)).to(dev, dtype)
    for n in (1, 40, 64, 65, 200):   # steps taken: the ring holds min(n, 64) valid slots
        slots = min(n, 64)
        got = blockwise_attention(q, ring[0], ring[1], causal=False, valid_len=slots)
        want = attention_ref(q, ring[0][:, :, :slots], ring[1][:, :, :slots])
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol,
                                   err_msg=f"ring {n}")
    for d, dv, s in ((192, 128, 300), (24, 16, 100)):
        q, k = (torch.from_numpy(rng.standard_normal((2, 4, s, d), np.float32)).to(dev, dtype) for _ in range(2))
        v = torch.from_numpy(rng.standard_normal((2, 4, s, dv), np.float32)).to(dev, dtype)
        got = blockwise_attention(q, k, v, causal=True)
        want = attention_ref(q, k, v, causal=True, scale=1 / np.sqrt(d))
        assert got.shape == (2, 4, s, dv)
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol,
                                   err_msg=f"mla {d}/{dv}")
    x = torch.zeros((1, 2, 8, 96), device=dev, dtype=dtype)
    with pytest.raises(ValueError, match="head width 96"):
        flash_attention(x, x, x)


# (B, Hq, Hkv, Sq, Sk, causal, window, q_offset): the (192, 128) pair's
# bf16 prefill (fp32 and Sq 1 take v padded to 192)
GPU_PAIR_CASES = [
    (1, 4, 4, 300, 300, True, None, None),     # ragged S: three query tiles, the last partial
    (1, 4, 4, 300, 300, False, None, None),
    (2, 8, 2, 129, 129, True, None, None),     # GQA 4, two query tiles
    (1, 4, 4, 70, 300, False, None, None),     # Sq < Sk
    (1, 4, 4, 70, 300, True, None, 100),       # q_offset off the right-aligned default
    (1, 4, 2, 513, 513, True, 100, None),      # window across tiles
    (2, 16, 16, 1, 300, True, None, None),     # decode: v padded to 192
    (2, 128, 128, 256, 256, True, None, None), # deepseek-v2's heads
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_head_pair_matches_plain(dtype, metrics_on):
    """MLA's (192, 128) pair on the card against the plain version, one
    launch a call, the output at Dv 128; ``blockwise_attention`` at the
    pair; a pair that is not instantiated raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    launches = metrics.counter(LAUNCHES["flash_attention"])
    tol = TOL if dtype == torch.float32 else TOL_BF16
    for case in GPU_PAIR_CASES:
        causal, window, q_offset = case[5:]
        q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in _pair_inputs(case))
        before = launches.value
        got = flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
        torch.cuda.synchronize()
        assert launches.value == before + 1
        assert got.shape == q.shape[:3] + (128,)
        want = attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol,
                                   err_msg=str(case))
        got = blockwise_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol,
                                   err_msg=f"blockwise {case}")
    for d, dv in ((128, 64), (192, 64)):
        x, y = torch.zeros((1, 2, 8, d), device=dev, dtype=dtype), torch.zeros((1, 2, 8, dv), device=dev, dtype=dtype)
        with pytest.raises(ValueError, match="v width"):
            flash_attention(x, x, y)


# ---------------------------------------------------------------------------
# the gradient (B11): attention_bwd_ref, the autograd Function's CPU path
# and the card's kernel, against jax.grad of blockwise_attention
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention.ops import BWD_DIMS, BWD_PAIRS, flash_attention_bwd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref  # noqa: E402

TOL_GRAD = 2e-5  # fp32 gradients: sums over at most ~50 keys in other orders

# (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, q_offset)
GRAD_CASES = [
    (2, 4, 2, 24, 24, 16, 16, True, None, None),    # GQA, causal
    (1, 4, 1, 9, 33, 32, 32, True, 7, None),         # MQA, window, Sq < Sk right-aligned
    (1, 2, 2, 12, 20, 8, 8, True, None, 3),          # a query offset
    (1, 4, 4, 10, 10, 16, 16, True, None, -4),       # rows with no key left
    (2, 6, 2, 15, 31, 24, 16, False, None, None),    # Dv != D, padded widths (24 -> 32)
    (1, 2, 1, 7, 7, 12, 12, True, 3, None),          # window, a width padded to 16
    (1, 4, 2, 11, 11, 192, 192, True, None, None),   # q/k 192 (B11b), v as wide
    (1, 2, 2, 9, 14, 192, 192, False, None, None),   # 192, unmasked, Sq < Sk
    (1, 4, 4, 13, 13, 192, 128, True, None, None),   # MLA's (192, 128) pair
    (2, 2, 1, 10, 17, 192, 128, False, None, None),  # the pair, unmasked, GQA
    (1, 4, 2, 15, 15, 192, 128, True, 5, None),      # the pair, a window
    (1, 10, 2, 16, 16, 64, 64, True, None, None),    # D 64 (B8d): train_lm's heads, causal
    (1, 4, 4, 12, 20, 64, 64, False, None, None),    # D 64, unmasked, Sq < Sk
    (1, 4, 2, 15, 15, 64, 64, True, 5, None),        # D 64, a window
]


def _grad_inputs(case, seed):
    b, hq, hkv, sq, sk, d, dv = case[:7]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv), (b, hq, sq, dv))]


def _jax_grads(q, k, v, g, causal, window, q_offset):
    def f(q, k, v):
        out = jax_blockwise(q, k, v, causal=causal, window=window, q_offset=q_offset, kv_block=8)
        return jnp.sum(out * g)

    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_gradient_matches_jax(case):
    """``blockwise_attention``'s gradient through the autograd Function
    (its CPU path: ``attention_ref`` with the log-sum-exp, then
    ``attention_bwd_ref``) and ``attention_bwd_ref`` alone, against
    ``jax.grad`` of the reference's ``blockwise_attention``."""
    causal, window, q_offset = case[7:]
    q, k, v, g = _grad_inputs(case, seed=sum(case[:7]))
    want = _jax_grads(q, k, v, g, causal, window, q_offset)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = blockwise_attention(tq, tk, tv, causal=causal, window=window, q_offset=q_offset)
    (out * torch.from_numpy(g)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=TOL_GRAD, atol=TOL_GRAD)
    if case[5] == case[6] or case[5:7] in BWD_PAIRS:  # the plain backward alone, at the inputs' own widths
        sq, sk = q.shape[2], k.shape[2]
        off = sk - sq if q_offset is None else q_offset
        tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
        o, lse = attention_ref(tq, tk, tv, causal=causal, window=window, q_offset=off, return_lse=True)
        got = attention_bwd_ref(tq, tk, tv, o, lse, tg, causal=causal, window=window, q_offset=off)
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), w, rtol=TOL_GRAD, atol=TOL_GRAD)


def test_log_sum_exp_of_the_plain_version():
    """``attention_ref(..., return_lse=True)``: the log-sum-exp of each
    query's scaled, masked scores (fp64 by hand), +inf on a row with no
    key left; the output unchanged."""
    q, k, v, _ = _grad_inputs((1, 2, 1, 6, 6, 8, 8), seed=3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = attention_ref(tq, tk, tv, causal=True, q_offset=-2, return_lse=True)
    assert torch.equal(out, attention_ref(tq, tk, tv, causal=True, q_offset=-2))
    s = np.einsum("bhqd,bkd->bhqk", q.astype(np.float64), k[:, 0].astype(np.float64)) / math.sqrt(8)
    qpos = np.arange(6)[:, None] - 2
    keep = np.arange(6)[None, :] <= qpos
    with np.errstate(divide="ignore"):
        want = np.where(keep.any(-1), np.log(np.where(keep, np.exp(s), 0).sum(-1)), np.inf)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.isinf(lse.numpy()[..., :2]).all() and np.isfinite(lse.numpy()[..., 2:]).all()


def test_gradient_path_needs_grad_mode():
    """Without grad mode, or with no operand requiring a gradient, the
    call is the serving path (no graph); with one, the output carries
    the Function's backward."""
    q, k, v, _ = _grad_inputs((1, 2, 2, 5, 5, 16, 16), seed=5)
    tq = torch.tensor(q, requires_grad=True)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    assert flash_attention(tq, tk, tv, causal=True).grad_fn is not None
    with torch.no_grad():
        assert flash_attention(tq, tk, tv, causal=True).grad_fn is None
    with torch.inference_mode():
        assert flash_attention(tq, tk, tv, causal=True).grad_fn is None
    assert flash_attention(tq.detach(), tk, tv, causal=True).grad_fn is None
    assert BWD_DIMS == (16, 32, 64, 128, 192) and BWD_PAIRS == ((192, 128),)


# the bf16 mapping's tiles at their edges: S across the 128-key tile (64 at
# q/k 192) and the 64-query step, a window's edge inside a tile, a negative
# query offset (rows with no key), Hq / Hkv of 1, 4 and 8
GPU_GRAD_EDGES = [
    (1, 4, 4, 127, 127, 128, 128, True, None, None), (1, 4, 1, 128, 128, 128, 128, True, None, None),
    (2, 8, 1, 129, 129, 128, 128, True, None, None), (1, 4, 4, 257, 257, 128, 128, False, None, None),
    (1, 8, 2, 300, 300, 128, 128, True, 70, None), (1, 4, 2, 129, 129, 32, 32, True, 40, None),
    (1, 2, 2, 129, 129, 16, 16, True, None, -20), (1, 8, 1, 200, 257, 128, 128, True, None, -30),
    (1, 4, 1, 129, 129, 192, 192, True, None, None), (1, 4, 4, 127, 200, 192, 128, True, 70, None),
    (1, 10, 2, 256, 256, 64, 64, True, None, None), (1, 4, 4, 127, 127, 64, 64, True, 40, None),
    (2, 4, 1, 129, 200, 64, 64, False, None, None), (1, 4, 2, 130, 130, 64, 64, True, None, -20),
    # q/k 192's 64-key tile and 64-query step: Sq and Sk 63, 64, 65, Hq / Hkv
    # of 1 and 4, a window, a negative offset, unmasked with Sk > Sq
    (1, 4, 4, 63, 63, 192, 128, True, None, None), (2, 4, 1, 64, 64, 192, 128, True, None, None),
    (1, 4, 4, 65, 65, 192, 128, True, 64, None), (1, 4, 1, 65, 130, 192, 128, True, None, -10),
    (1, 4, 4, 63, 65, 192, 128, False, None, None), (1, 4, 1, 64, 64, 192, 192, True, None, None),
    (1, 4, 4, 65, 65, 192, 192, True, 40, -5), (1, 4, 4, 63, 129, 192, 192, False, None, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_attention_gradient_matches_plain(dtype, metrics_on):
    """The B11 kernel on the card against ``attention_bwd_ref`` on the
    same inputs, output and log-sum-exp, at each instantiated width: one
    backward launch a call; the autograd path's gradients too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    launches = metrics.counter(LAUNCHES["flash_attention_bwd"])
    tol = 1e-4 if dtype == torch.float32 else TOL_BF16
    for case in [(2, 8, 2, 70, 70, 16, 16, True, None, None), (1, 4, 1, 130, 200, 32, 32, True, 50, None),
                 (2, 8, 8, 129, 129, 128, 128, False, None, None), (1, 4, 4, 64, 100, 128, 128, True, None, -10),
                 *GPU_GRAD_EDGES]:
        causal, window, q_offset = case[7:]
        q, k, v, g = (torch.from_numpy(a).to(dev, dtype) for a in _grad_inputs(case, seed=sum(case[:7])))
        off = k.shape[2] - q.shape[2] if q_offset is None else q_offset
        ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = flash_attention(ql, kl, vl, causal=causal, window=window, q_offset=off)
        before = launches.value
        out.backward(g)
        torch.cuda.synchronize()
        assert launches.value == before + 1
        _, lse = attention_ref(q, k, v, causal=causal, window=window, q_offset=off, return_lse=True)
        want = attention_bwd_ref(q, k, v, out.detach(), lse, g, causal=causal, window=window, q_offset=off)
        direct = flash_attention_bwd(q, k, v, out.detach(), lse, g, causal=causal, window=window, q_offset=off)
        for got, d, w in zip((ql.grad, kl.grad, vl.grad), direct, want):
            w = w.float().cpu().numpy()
            scale = np.sqrt(np.mean(w ** 2))
            np.testing.assert_allclose(got.float().cpu().numpy(), w, rtol=tol, atol=tol * scale, err_msg=str(case))
            np.testing.assert_allclose(d.float().cpu().numpy(), w, rtol=tol, atol=tol * scale, err_msg=str(case))


@pytest.mark.gpu
def test_gpu_attention_gradient_raises_past_its_widths(metrics_on):
    """B11b: the backward takes D 192 and MLA's (192, 128) pair on the
    card (one launch, against the plain version, bf16 and fp32); past its
    mappings it still raises, with no fallback: the decode mapping (Sq =
    1) writes no log-sum-exp, before the forward launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    launches = metrics.counter(LAUNCHES["flash_attention_bwd"])
    for dtype in (torch.float32, torch.bfloat16):
        tol = 1e-4 if dtype == torch.float32 else TOL_BF16
        for d, dv in ((192, 192), (192, 128)):
            case = (1, 4, 2, 150, 150, d, dv, True, None, None)
            q, k, v, g = (torch.from_numpy(a).to("cuda", dtype) for a in _grad_inputs(case, seed=d + dv))
            _, lse = attention_ref(q, k, v, causal=True, return_lse=True)
            out = flash_attention(q, k, v, causal=True)
            before = launches.value
            got = flash_attention_bwd(q, k, v, out, lse, g, causal=True)
            torch.cuda.synchronize()
            assert launches.value == before + 1
            want = attention_bwd_ref(q, k, v, out, lse, g, causal=True)
            for a, w in zip(got, want):
                assert a.shape == w.shape
                w = w.float().cpu().numpy()
                np.testing.assert_allclose(a.float().cpu().numpy(), w, rtol=tol, atol=tol * np.sqrt(np.mean(w ** 2)),
                                           err_msg=str((dtype, d, dv)))
    q = torch.zeros((1, 2, 1, 128), device="cuda", dtype=torch.bfloat16, requires_grad=True)
    kv = torch.zeros((1, 2, 64, 128), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="Sq = 1"):
        flash_attention(q, kv, kv, causal=True)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_term_p_and_ds_hold_the_backward_gate(capsys):
    """The bf16 backward's rounding, emulated in plain torch on every
    ``BWD_CASES`` case with bf16 inputs: P and dS as bf16 hi + lo (hi =
    bf16(x), lo = bf16(x - hi)), the products summed in fp32 and rounded
    to bf16 once, against ``attention_bwd_ref`` under ``BWD_TOL``'s bf16
    gate (``chip_smoke.bwd_grad_gap``).  P and dS rounded once to bf16 are
    counted beside it (printed, not asserted)."""
    smoke = _chip_smoke()
    misses = {}
    for i, (b, hq, hkv, sq, sk, d, dv, causal, window, off) in enumerate(smoke.BWD_CASES):
        rng = np.random.default_rng(100 + i)
        q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
                      for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv), (b, hq, sq, dv)))
        off = sk - sq if off is None else off
        out, lse = attention_ref(q, k, v, causal=causal, window=window, q_offset=off, return_lse=True)
        want = attention_bwd_ref(q, k, v, out, lse, g, causal=causal, window=window, q_offset=off)
        rep, scale = hq // hkv, d ** -0.5
        qf, gf = q.float().reshape(b, hkv, rep, sq, d), g.float().reshape(b, hkv, rep, sq, dv)
        kf, vf = k.float(), v.float()
        keep = torch.ones((sq, sk), dtype=torch.bool)
        qpos, kpos = torch.arange(sq)[:, None] + off, torch.arange(sk)[None, :]
        if causal:
            keep &= kpos <= qpos
        if window is not None:
            keep &= kpos > qpos - window
        s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kf) * scale
        p = torch.exp(s - lse.reshape(b, hkv, rep, sq, 1)).masked_fill(~keep, 0.0)
        delta = (gf * out.float().reshape(b, hkv, rep, sq, dv)).sum(-1, keepdim=True)
        ds = p * (torch.einsum("bgrqd,bgkd->bgrqk", gf, vf) - delta)

        def grads(pp, dd):
            dq = torch.einsum("bgrqk,bgkd->bgrqd", dd, kf) * scale
            dk = torch.einsum("bgrqk,bgrqd->bgkd", dd, qf) * scale
            dv = torch.einsum("bgrqk,bgrqd->bgkd", pp, gf)
            return dq.reshape(b, hq, sq, d).to(torch.bfloat16), dk.to(torch.bfloat16), dv.to(torch.bfloat16)

        def two(x):
            hi = x.to(torch.bfloat16).float()
            return hi + (x - hi).to(torch.bfloat16).float()

        def one(x):
            return x.to(torch.bfloat16).float()

        for got, w in zip(grads(two(p), two(ds)), want):
            assert smoke.bwd_grad_gap(got, w, torch.bfloat16)[0], smoke.BWD_CASES[i]
        misses[i] = sum(not smoke.bwd_grad_gap(got, w, torch.bfloat16)[0]
                        for got, w in zip(grads(one(p), one(ds)), want))
    with capsys.disabled():
        print(f"\none-term P and dS: gradients (dq, dk, dv) outside BWD_TOL per BWD_CASES case: {misses}")


@pytest.mark.parametrize("shape", [(1, 1, 1, 64, 192, 128), (2, 4, 2, 200, 128, 128), (1, 2, 2, 300, 192, 192),
                                   (2, 128, 128, 4096, 192, 128)])
def test_bwd_design_ops_counts_the_kernels_walk(shape):
    """``chip_smoke.bwd_design_ops`` (the smoke's ``design_floor_ms``)
    against every (key block, 64-query tile) pair written out: a causal
    block of TK keys (128; 64 at q/k 192) runs the tiles where some query
    reaches its first key, each head of its group, at 2 TK 64 (D + Dv +
    2 Dv + 2 D + 2 D) operations a tile, and at q/k 192 its last tile's
    S^T and dP^T once more.  At deepseek-v2's training shape the count
    lies between the two-term floor's and the two walks' (S twice)."""
    smoke = _chip_smoke()
    b, hq, hkv, s, d, dv = shape
    tk, tm = (64, 64) if d > 128 else (128, 64)
    want = 0.0
    for k0 in range(0, s, tk):
        tiles = sum(1 for q0 in range(0, s, tm) if k0 <= q0 + tm - 1)
        want += hq * tiles * 2.0 * tk * tm * (5 * d + 3 * dv)
        if d > 128 and tiles:
            want += hkv * 2.0 * tk * tm * (d + dv)
    got = smoke.bwd_design_ops(*shape)
    assert got == b * want
    if shape == smoke.BWD_MLA_ROW:
        pairs = b * hq * s * (s + 1) / 2
        assert 2.0 * pairs * (5 * d + 3 * dv) < got <= 2.0 * pairs * (6 * d + 3 * dv)


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(128, 128), (192, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_attention_gradient_is_reproducible(dtype, dims):
    """Two calls on the same inputs, at D 128 and at MLA's (192, 128)
    pair: dK and dV equal bit for bit (written once from registers); dQ
    too in fp32, and in bf16 (adds into the fp32 accumulator, in a run's
    own order) within ``BWD_TOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    smoke = _chip_smoke()
    case = (2, 8, 2, 300, 300, *dims, True, None, None)
    q, k, v, g = (torch.from_numpy(a).to("cuda", dtype) for a in _grad_inputs(case, seed=7))
    out, lse = attention_ref(q, k, v, causal=True, return_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    second = flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    if dtype == torch.float32:
        assert torch.equal(first[0], second[0])
    else:
        assert smoke.bwd_grad_gap(second[0], first[0], dtype)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_attention_gradient_runs_its_dtypes_mapping(dtype):
    """The mapping is chosen by dtype, with no fallback: a bf16 call
    launches the tensor-core kernel and never the CUDA-core FMA kernels
    (``dkdv_kernel``, ``dq_kernel``, ``delta_kernel``); an fp32 call the
    reverse (the profiler's kernel names)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import re

    from torch.profiler import ProfilerActivity, profile

    case = (1, 8, 2, 200, 200, 128, 128, True, None, None)
    q, k, v, g = (torch.from_numpy(a).to("cuda", dtype) for a in _grad_inputs(case, seed=3))
    out, lse = attention_ref(q, k, v, causal=True, return_lse=True)
    flash_attention_bwd(q, k, v, out, lse, g, causal=True)  # built and loaded outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention_bwd(q, k, v, out, lse, g, causal=True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    fma = [n for n in names if re.search(r"::(dkdv_kernel|dq_kernel|delta_kernel)<", n)]
    tc = [n for n in names if "attn_bwd_" in n]
    if dtype == torch.bfloat16:
        assert not fma and any("attn_bwd_tc_kernel" in n for n in tc), names
    else:
        assert not tc and len({re.search(r"::(\w+)<", n).group(1) for n in fma}) == 3, names

