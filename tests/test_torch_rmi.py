"""Port parity for the cardinality estimator (``repro_torch.core.cardinality``)
against the JAX package.

* Features and training targets: equal (same fp32 comparisons; the
  log2 of an integer count is taken in float64 as numpy does).
* Forward pass: the JAX estimator's parameters carried across with
  ``rmi_from_jax`` give the same predictions within fp32 rtol 1e-5
  (atol 1e-5): the two frameworks sum the layer products in different
  orders.  A stage's route (``rmi_route``) must agree except where the
  routing quantity ``pred / target_max * n_next`` lies within that
  tolerance of an integer boundary; such rows are counted.
* Training is held to estimator quality in ``test_torch_laf.py``, which
  trains both estimators on the same split.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core.cardinality import features as jfeat
from repro.core.cardinality import rmi as jrmi

from repro_torch.core.cardinality import features as tfeat
from repro_torch.core.cardinality import rmi as trmi

RTOL = ATOL = 1e-5


def _unit(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_training_set_matches():
    x = _unit(150, 8, 0)
    grid = (0.3, 0.6, 0.9)
    jf, jt = jfeat.build_training_set(x, grid, query_batch=64, block_size=32)
    tf, tt = tfeat.build_training_set(x, grid, query_batch=64, block_size=32, device="cpu")
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tt.numpy(), jt)
    jc = np.asarray(jfeat.multi_eps_counts(jnp.asarray(x), jnp.asarray(x), grid, block_size=48))
    tc = tfeat.multi_eps_counts(torch.from_numpy(x), torch.from_numpy(x), grid, block_size=48)
    np.testing.assert_array_equal(tc.numpy(), jc)


@pytest.mark.parametrize("d,seed", [(16, 0), (32, 1)])
def test_rmi_from_jax_forward_and_routes(d, seed):
    cfg = jrmi.RMIConfig(input_dim=d + 1)
    params = jrmi.init_rmi(jax.random.PRNGKey(seed), cfg)
    x = np.concatenate([_unit(400, d, seed), np.random.default_rng(seed).uniform(0.1, 0.9, (400, 1))],
                       axis=1).astype(np.float32)
    p0 = np.asarray(jrmi.mlp_apply(params["stage0"], jnp.asarray(x)))
    # spread the stage-0 outputs over both stage-1 experts
    target_max = float(2.0 * np.abs(p0).max())
    cfg = jrmi.RMIConfig(input_dim=d + 1, target_max=target_max)
    tcfg = trmi.RMIConfig(input_dim=d + 1, target_max=target_max)
    model = trmi.rmi_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(model.stages[0][0](xt).detach().numpy(), p0, rtol=RTOL, atol=ATOL)
    want = np.asarray(jrmi.rmi_predict(params, jnp.asarray(x), cfg))
    got = trmi.rmi_predict(model, xt).numpy()

    # walk the stages with each framework's own predictions and count
    # route disagreements; each must sit at a routing boundary
    pj, pt, boundary_rows = p0, model.stages[0][0](xt).detach().numpy(), 0
    for s, n_exp in enumerate(cfg.stage_sizes[1:], start=1):
        rj = np.asarray(jrmi.rmi_route(jnp.asarray(pj), n_exp, target_max))
        rt = trmi.rmi_route(torch.from_numpy(pt), n_exp, target_max).numpy()
        scaled = pj / target_max * n_exp
        near = np.abs(scaled - np.round(scaled)) <= RTOL * np.abs(scaled) + ATOL * n_exp / target_max
        assert not ((rj != rt) & ~near).any()
        boundary_rows += int((rj != rt).sum())
        allj = np.stack([np.asarray(jrmi.mlp_apply(jax.tree_util.tree_map(lambda a: a[e], params[f"stage{s}"]),
                                                    jnp.asarray(x))) for e in range(n_exp)])
        allt = np.stack([m(xt).detach().numpy() for m in model.stages[s]])
        np.testing.assert_allclose(allt, allj, rtol=RTOL, atol=ATOL)
        pj, pt = allj[rj, np.arange(len(x))], allt[rt, np.arange(len(x))]
    print(f"{boundary_rows} rows routed differently at a boundary")
    if boundary_rows == 0:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    counts = trmi.rmi_predict_counts(model, xt).numpy()
    np.testing.assert_allclose(
        counts, np.asarray(jrmi.rmi_predict_counts(params, jnp.asarray(x), cfg)), rtol=1e-4, atol=1e-4)
