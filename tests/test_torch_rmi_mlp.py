"""Port parity for the fused RMI-MLP forward (``repro_torch.kernels.rmi_mlp``)
and the estimator's predict path through it, against the JAX package
(the Pallas kernel in interpret mode) on the same numpy inputs.

* z (one net or a stage): rtol/atol 2e-5, the reference's own tolerance
  for its kernel against ``mlp_apply`` (``tests/test_kernels.py``); the
  two frameworks sum the layer products in different orders.
* bf16 parameters: 2e-2, as the reference's bf16 case.
* ``rmi_predict``: each stage's route must agree except where the
  routing quantity lies within that tolerance of an integer boundary;
  such rows are counted and printed, never avoided by choice of data.
* the card's arithmetic (three tf32 products, ``csrc/rmi_mlp.cu``),
  emulated here: within the same 2e-5 of the reference at the MS-150k
  widths, where a single tf32 pass misses it or moves a route; its
  packing (tf32 parts, K-major blocks of 8) gives the weights back.

On the CPU the port's wrappers run the plain version (``ref.py``); the
``gpu`` test holds the CUDA kernel to it on the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core.cardinality import rmi as jrmi
from repro.kernels.rmi_mlp import ops as jops

from repro_torch.core.cardinality import rmi as trmi
from repro_torch.kernels.rmi_mlp import ops as tops
from repro_torch.kernels.rmi_mlp.ref import stage_forward_ref
from repro_torch.obs import metrics

TOL = 2e-5
HIDDEN = (512, 512, 256, 128)


def _mlp_np(rng, d_in, hidden=HIDDEN, experts=None):
    """He-normal (W (in, out), b) pairs, stacked over ``experts`` when given."""
    dims = [d_in, *hidden, 1]
    lead = () if experts is None else (experts,)
    return [
        ((rng.standard_normal(lead + (a, b)) * np.sqrt(2.0 / a)).astype(np.float32),
         (0.1 * rng.standard_normal(lead + (b,))).astype(np.float32))
        for a, b in zip(dims, dims[1:])
    ]


def _jax(params):
    return [(jnp.asarray(w), jnp.asarray(b)) for w, b in params]


def _module(params):
    mlp = trmi.MLP(params[0][0].shape[0], [w.shape[1] for w, _ in params[:-1]])
    trmi._load_mlp(mlp, params)
    return mlp


@pytest.mark.parametrize("d_in", [9, 769])
@pytest.mark.parametrize("batch", [1, 300])
def test_rmi_mlp_forward_matches_jax(d_in, batch):
    rng = np.random.default_rng(d_in * 1000 + batch)
    params = _mlp_np(rng, d_in)
    x = rng.standard_normal((batch, d_in)).astype(np.float32)
    want = np.asarray(jops.rmi_mlp_forward(_jax(params), jnp.asarray(x), batch_tile=128))
    np.testing.assert_allclose(np.asarray(jrmi.mlp_apply(_jax(params), jnp.asarray(x))), want, rtol=TOL, atol=TOL)
    xt = torch.from_numpy(x)
    for got in (tops.rmi_mlp_forward(params, xt), tops.rmi_mlp_forward(_module(params), xt)):
        assert got.shape == (batch,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_rmi_mlp_bf16_params():
    """bf16 parameters (and input) are cast to fp32 before the product."""
    rng = np.random.default_rng(0)
    params = _mlp_np(rng, 33)
    x = rng.standard_normal((64, 33)).astype(np.float32)
    jp = [(jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)) for w, b in params]
    want = np.asarray(jops.rmi_mlp_forward(jp, jnp.asarray(x, jnp.bfloat16), batch_tile=64))
    tp = [(torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)) for w, b in params]
    got = tops.rmi_mlp_forward(tp, torch.from_numpy(x).to(torch.bfloat16)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    fp32 = np.asarray(jrmi.mlp_apply([(w.astype(jnp.float32), b.astype(jnp.float32)) for w, b in jp],
                                     jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_allclose(got, fp32, rtol=2e-2, atol=2e-2)


def test_rmi_stage_forward_matches_jax():
    """A 4-expert stage in both layouts the wrapper takes: the
    reference's stacked numpy pairs and the packed ``MLP`` modules of
    ``rmi_from_jax``; the one-net stage 0 through ``rmi_mlp_forward``."""
    rng = np.random.default_rng(2)
    cfg = trmi.RMIConfig(input_dim=17)
    params = {f"stage{s}": _mlp_np(rng, 17, experts=n) for s, n in enumerate(cfg.stage_sizes)}
    params["stage0"] = [(w[0], b[0]) for w, b in params["stage0"]]
    x = rng.standard_normal((96, 17)).astype(np.float32)
    want = np.asarray(jops.rmi_stage_forward(_jax(params["stage2"]), jnp.asarray(x), batch_tile=32))
    xt = torch.from_numpy(x)
    model = trmi.rmi_from_jax(params, cfg, device="cpu")
    for stacked in (params["stage2"], model.stages[2]):
        got = tops.rmi_stage_forward(stacked, xt)
        assert got.shape == (4, 96)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tops.rmi_mlp_forward(params["stage0"], xt).numpy(),
                               np.asarray(jrmi.mlp_apply(_jax(params["stage0"]), jnp.asarray(x))),
                               rtol=TOL, atol=TOL)


def test_rmi_predict_fused_route_matches_jax():
    """The port's ``rmi_predict`` (one stage forward per stage) against
    the reference's at the MS-150k input width, route flips counted."""
    rng = np.random.default_rng(5)
    d_in = 769
    params = {f"stage{s}": _mlp_np(rng, d_in, experts=n) for s, n in enumerate((1, 2, 4))}
    params["stage0"] = [(w[0], b[0]) for w, b in params["stage0"]]
    x = np.concatenate([rng.standard_normal((256, d_in - 1)), rng.uniform(0.3, 0.6, (256, 1))], axis=1)
    x = x.astype(np.float32)
    p0 = np.asarray(jrmi.mlp_apply(_jax(params["stage0"]), jnp.asarray(x)))
    target_max = float(2.0 * np.abs(p0).max())  # spreads stage 0 over both stage-1 experts
    jcfg = jrmi.RMIConfig(input_dim=d_in, target_max=target_max)
    model = trmi.rmi_from_jax(params, trmi.RMIConfig(input_dim=d_in, target_max=target_max), device="cpu")
    xt = torch.from_numpy(x)
    want = np.asarray(jrmi.rmi_predict(params, jnp.asarray(x), jcfg))
    got = trmi.rmi_predict(model, xt).numpy()

    pj, pt, flips = p0, tops.rmi_stage_forward(model.stages[0], xt)[0].numpy(), 0
    np.testing.assert_allclose(pt, pj, rtol=TOL, atol=TOL)
    for s, n_exp in enumerate((2, 4), start=1):
        rj = np.asarray(jrmi.rmi_route(jnp.asarray(pj), n_exp, target_max))
        rt = trmi.rmi_route(torch.from_numpy(pt), n_exp, target_max).numpy()
        scaled = pj / target_max * n_exp
        near = np.abs(scaled - np.round(scaled)) <= TOL * np.abs(scaled) + TOL * n_exp / target_max
        assert not ((rj != rt) & ~near).any()
        flips += int((rj != rt).sum())
        allj = np.asarray(jops.rmi_stage_forward(_jax(params[f"stage{s}"]), jnp.asarray(x), batch_tile=128))
        allt = tops.rmi_stage_forward(model.stages[s], xt).numpy()
        np.testing.assert_allclose(allt, allj, rtol=TOL, atol=TOL)
        pj, pt = allj[rj, np.arange(len(x))], allt[rt, np.arange(len(x))]
    print(f"{flips} rows routed differently at a boundary")
    ok = np.isclose(got, want, rtol=TOL, atol=TOL)
    assert ok.all() or (~ok).sum() <= flips
    np.testing.assert_allclose(got, pt, rtol=0, atol=0)
    # the autograd path (nn.Linear) that training uses computes the same z
    np.testing.assert_allclose(model(xt).detach().numpy(), got, rtol=TOL, atol=TOL)


def test_packed_modules_follow_training():
    """The packed (E, in, out) buffers hold the experts' weights after
    an optimizer step and after a ``copy_`` into a weight."""
    torch.manual_seed(0)
    experts = torch.nn.ModuleList(trmi.MLP(9, HIDDEN) for _ in range(2))
    x = torch.randn(40, 9)
    ws, _ = tops.stage_params(experts, x.device)
    assert ws[0].shape == (2, 9, 512) and ws[0].is_contiguous()
    assert torch.equal(ws[0][1], experts[1].layers[0].weight.T)
    opt = torch.optim.Adam(experts.parameters(), lr=1e-2)
    loss = sum(m(x).square().mean() for m in experts)
    loss.backward()
    opt.step()
    got = tops.rmi_stage_forward(experts, x)
    with torch.no_grad():
        want = torch.stack([m(x) for m in experts])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    with torch.no_grad():
        experts[1].layers[0].bias.copy_(torch.full((512,), 0.5))
        want = torch.stack([m(x) for m in experts])
    np.testing.assert_allclose(tops.rmi_stage_forward(experts, x).numpy(), want.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hidden,match", [((512, 512, 256), "4 hidden layers"),
                                          ((512, 384, 256, 128), "hidden widths")])
def test_kernel_shape_checks(hidden, match):
    """Shapes the CUDA kernel does not hold raise before any launch (the
    plain version on the CPU takes them)."""
    experts = [_module(_mlp_np(np.random.default_rng(1), 9, hidden))]
    with pytest.raises(ValueError, match=match):
        tops._check_shapes(*tops.pack_stage(experts, torch.device("cpu")), torch.zeros(3, 9))
    ws, bs = tops.stage_params(experts, torch.device("cpu"))
    assert tops.rmi_stage_forward([(w, b) for w, b in zip(ws, bs)], torch.zeros(3, 9)).shape == (1, 3)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 by bit masking: 10 mantissa bits, to nearest
    with ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _emulate_tf32(params, x, terms: int) -> np.ndarray:
    """The card's forward on the CPU: each hidden layer's product from
    tf32 parts of both operands, ``terms`` 3 (a_hi b_hi + a_hi b_lo +
    a_lo b_hi, the kernel's) or 1 (a_hi b_hi: one tf32 pass), each a
    product of exact tf32 values summed in fp32 (TF32 off); the head in
    fp32, as the kernel's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    h = torch.from_numpy(x)
    for w, b in params[:-1]:
        w = torch.from_numpy(w)
        ah, bh = _tf32(h), _tf32(w)
        y = ah @ bh
        if terms == 3:
            y = y + ah @ _tf32(w - bh) + _tf32(h - ah) @ bh
        h = torch.relu(y + torch.from_numpy(b))
    w, b = params[-1]
    return (h @ torch.from_numpy(w) + torch.from_numpy(b))[:, 0].numpy()


def test_three_tf32_products_hold_the_card_gate():
    """Three tf32 products a layer stay within the card's gate, 2e-5
    (1 + |z|), of the reference's Pallas kernel at the MS-150k widths
    (d_in 769, 512-512-256-128); one tf32 pass misses the gate or routes
    a row to another expert."""
    rng = np.random.default_rng(18)
    d_in = 769
    params = _mlp_np(rng, d_in)
    x = np.concatenate([rng.standard_normal((192, d_in - 1)), rng.uniform(0.3, 0.6, (192, 1))], axis=1)
    x = x.astype(np.float32)
    want = np.asarray(jops.rmi_mlp_forward(_jax(params), jnp.asarray(x), batch_tile=64))
    gaps = {t: float((np.abs(_emulate_tf32(params, x, t) - want) / (1 + np.abs(want))).max()) for t in (3, 1)}
    target_max = float(2.0 * np.abs(want).max())

    def routes(z):
        return np.clip(np.floor(z / target_max * 4), 0, 3)

    moved = int((routes(_emulate_tf32(params, x, 1)) != routes(want)).sum())
    print(f"3xTF32 gap {gaps[3]:.2e}, one tf32 pass gap {gaps[1]:.2e}, {moved} routes moved by one pass")
    assert gaps[3] <= TOL
    assert gaps[1] > TOL or moved > 0


def test_kernel_packing_reconstructs_weights():
    """``pack_stage`` (modules or the reference's pairs): each hidden
    layer as tf32 parts (13 low bits zero) in K-major blocks of 8 k, the
    blocks inverted exactly, hi + lo within 2^-22 of each weight; the
    head and the biases as they are."""
    torch.manual_seed(3)
    experts = [trmi.MLP(33, (256, 512, 128, 256)) for _ in range(3)]
    ws, bs = tops.pack_stage(experts, torch.device("cpu"))
    pairs = [(w.numpy(), b.numpy()) for w, b in zip(*tops.stage_params(experts, torch.device("cpu")))]
    ws2, bs2 = tops.pack_stage(pairs, torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(ws + bs, ws2 + bs2))
    with torch.no_grad():
        for l, (w, k) in enumerate(zip(ws[:-1], (33, 256, 512, 128))):
            want = torch.stack([m.layers[l].weight for m in experts])
            e, n, kb = want.shape[0], want.shape[1], -(-k // 8)
            assert w.shape == (2, e, kb, n, 8)
            assert not (w.view(torch.int32) & 0x1FFF).any()
            padded = torch.nn.functional.pad(want, (0, 8 * kb - k))
            hi = _tf32(padded)
            assert torch.equal(w[0], hi.view(e, n, kb, 8).transpose(1, 2))
            assert torch.equal(w[1], _tf32(padded - hi).view(e, n, kb, 8).transpose(1, 2))
            got = (w[0] + w[1]).transpose(1, 2).reshape(e, n, 8 * kb)[..., :k]
            assert ((got - want).abs() <= 2.0 ** -22 * want.abs()).all()
            assert torch.equal(bs[l], torch.stack([m.layers[l].bias for m in experts]))
        assert torch.equal(ws[-1], torch.stack([m.layers[-1].weight for m in experts]))


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


# (d_in, batch, experts, hidden): the d_in tail (9, 33, 769 = 96 x 8 + 1),
# ragged 64-row tiles (1, 63, 65, 1000), 1-4 experts, each width in each
# place (a 512-wide layer runs in two passes)
GPU_CASES = [
    (769, 1000, 4, HIDDEN), (33, 1, 1, HIDDEN), (769, 77, 2, HIDDEN),
    (9, 1, 1, (128, 128, 128, 128)), (9, 65, 4, (512, 128, 256, 512)),
    (33, 63, 2, (256, 512, 128, 256)), (33, 1000, 3, (512, 256, 512, 128)),
    (769, 63, 3, HIDDEN), (769, 65, 1, (128, 512, 512, 256)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("d_in,batch,experts,hidden", GPU_CASES)
def test_gpu_rmi_mlp_matches_plain(d_in, batch, experts, hidden, metrics_on):
    dev = _card()
    rng = np.random.default_rng(d_in + batch)
    params = [(torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev))
              for w, b in _mlp_np(rng, d_in, hidden, experts=experts)]
    x = torch.from_numpy(rng.standard_normal((batch, d_in)).astype(np.float32)).to(dev)
    launches = metrics.counter("kernel.rmi_mlp.launches")
    before = launches.value
    got = tops.rmi_stage_forward(params, x)
    torch.cuda.synchronize()
    assert launches.value == before + 1
    want = stage_forward_ref(x, [w for w, _ in params], [b for _, b in params])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=TOL, atol=TOL)
