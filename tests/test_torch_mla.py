"""Port parity for Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package's ``repro.models.mla``, with the reference's own
``mla_init`` draws carried across as numpy.

* ``mla_attention`` (the prefill: q/k concatenated to nope + rope, v
  zero-padded to that width inside ``blockwise_attention``) and its
  returned (c_kv, k_rope);
* ``mla_decode_step`` (the absorbed decode) step by step: the output and
  both caches, written in place in the port at ``cur_len``, against the
  reference's ``dynamic_update_slice`` caches; and the decode against
  the prefill at each position (the reference's own invariant).

Tolerance: fp32 rtol = atol = 1e-4 (``TOL_MODEL`` of
``tests/test_torch_models.py``): products summed in other orders
through the low-rank projections, the norms and the softmax.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.models import mla as jmla

from repro_torch.models import mla as tmla

TOL = 1e-4

# the reduced config's widths (deepseek-v2's make_reduced_config) and the
# published head widths at two heads (q/k 128 + 64 = 192, v 128)
WIDTHS = {
    "reduced": dict(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                    v_dim=16),
    "published_heads": dict(d_model=64, n_heads=2, q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=128,
                            qk_rope_dim=64, v_dim=128),
}


def _setup(name, seed):
    kw = WIDTHS[name]
    jcfg, tcfg = jmla.MLAConfig(**kw), tmla.MLAConfig(**kw)
    jparams = jmla.mla_init(jax.random.PRNGKey(seed), jcfg)
    tparams = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jparams)
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("name", list(WIDTHS))
def test_mla_attention_matches_jax(name):
    jcfg, tcfg, jparams, tparams = _setup(name, 0)
    b, s = 2, 12
    x = np.random.default_rng(1).standard_normal((b, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    attend = jax.jit(lambda p, x, c: jmla.mla_attention(p, jcfg, x, jnp.asarray(pos), causal=c, kv_block=8),
                     static_argnums=2)
    want, (wc, wr) = attend(jparams, jnp.asarray(x), True)
    got, (c, r) = tmla.mla_attention(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(pos.copy()).long())
    assert got.shape == (b, s, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(wc), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(wr), rtol=TOL, atol=TOL)
    # non-causal too
    want_nc, _ = attend(jparams, jnp.asarray(x), False)
    got_nc, _ = tmla.mla_attention(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(pos.copy()).long(),
                                   causal=False)
    np.testing.assert_allclose(got_nc.numpy(), np.asarray(want_nc), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list(WIDTHS))
def test_mla_decode_step_matches_jax(name):
    jcfg, tcfg, jparams, tparams = _setup(name, 2)
    b, s_max, steps = 2, 10, 7
    x = np.random.default_rng(3).standard_normal((b, steps, 64)).astype(np.float32)
    jckv = jnp.zeros((b, s_max, jcfg.kv_lora_rank), jnp.float32)
    jkr = jnp.zeros((b, s_max, jcfg.qk_rope_dim), jnp.float32)
    ckv, kr = torch.zeros(tuple(jckv.shape)), torch.zeros(tuple(jkr.shape))
    jstep = jax.jit(lambda p, x, c, r, n: jmla.mla_decode_step(p, jcfg, x, c, r, n))
    pos = np.broadcast_to(np.arange(steps, dtype=np.int32)[None], (b, steps))
    prefill, _ = tmla.mla_attention(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(pos.copy()).long())
    for t in range(steps):
        want, jckv, jkr = jstep(jparams, jnp.asarray(x[:, t : t + 1]), jckv, jkr, t)
        got, c_out, r_out = tmla.mla_decode_step(tparams, tcfg, torch.from_numpy(x[:, t : t + 1]), ckv, kr, t)
        assert c_out is ckv and r_out is kr
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ckv.numpy(), np.asarray(jckv), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(kr.numpy(), np.asarray(jkr), rtol=TOL, atol=TOL)
        # the absorbed decode equals the expanded prefill at its position
        np.testing.assert_allclose(got[:, 0].numpy(), prefill[:, t].numpy(), rtol=TOL, atol=TOL)
    assert not ckv[:, steps:].any() and not kr[:, steps:].any()


def test_mla_init_shapes_and_scale():
    tcfg = tmla.MLAConfig(**WIDTHS["published_heads"])
    p = tmla.mla_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    jp = jax.eval_shape(lambda: jmla.mla_init(jax.random.PRNGKey(0), jmla.MLAConfig(**WIDTHS["published_heads"])))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), jp) == \
        {k: ({n: tuple(t.shape) for n, t in v.items()} if isinstance(v, dict) else tuple(v.shape))
         for k, v in p.items()}
    assert p["q_norm"]["scale"].eq(1).all() and p["wk_b"].dtype == torch.bfloat16
    assert abs(float(p["wk_b"].float().std()) - 32 ** -0.5) < 0.01
