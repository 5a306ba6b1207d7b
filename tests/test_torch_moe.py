"""Port parity for the MoE FFN (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe``, on the same numpy inputs and the
reference's own ``moe_init`` draws.

Tolerances:
* fp32 (experts and router): rtol = atol = 1e-5 on the output and the
  aux stats; the routes (top-k experts) and the kept entries are equal
  exactly (the router's logits are one fp32 product apart, and no case
  here has two probabilities within that of a tie).
* bf16 experts (the router stays fp32): the aux stats within 1e-5 and
  the routes exact, as they depend on the fp32 router only; the output
  within 2^-6 relative + 2^-5 absolute (a bf16 step at 2-4, the
  outputs' largest magnitudes: the routed and shared sums cancel, so a
  small output carries the rounding of larger terms), since the port
  multiplies bf16 weights in bf16 and rounds the gate and up
  projections and the down-projection's input to bf16 where the
  reference computes in fp32 (``moe.py``'s docstring).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.models import moe as jm

from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt

TOL = 1e-5


def _tree(params, dtype=None):
    if isinstance(params, dict):
        return {k: _tree(v, dtype) for k, v in params.items()}
    a = np.array(params.astype(jnp.float32))
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def _cfgs(dtype=jnp.float32, **kw):
    base = dict(d_model=32, d_ff=48, n_experts=4, top_k=2, capacity_factor=1.25)
    base.update(kw)
    jcfg = jm.MoEConfig(**base, dtype=dtype)
    tcfg = tm.MoEConfig(**base, dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    return jcfg, tcfg


def _port_params(jparams, tcfg):
    """The reference's draws in the port's layout: experts in the
    config's dtype, the router fp32."""
    out = _tree(jparams)
    for name in ("wi_gate", "wi_up", "wo"):
        out[name] = out[name].to(tcfg.dtype)
    if "shared" in out:
        out["shared"] = {k: v.to(tcfg.dtype) for k, v in out["shared"].items()}
    return out


# (tokens, groups, capacity_factor, n_shared, top_k): drops at 0.25 as the
# reference's own test (tests/test_models.py:168); none at 2.0 and 4.0
CASES = [
    (32, 1, 2.0, 0, 2),
    (32, 2, 2.0, 0, 2),
    (64, 1, 0.25, 0, 2),
    (64, 2, 0.25, 1, 2),
    (48, 2, 4.0, 2, 1),
    (40, 1, 1.25, 1, 3),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_moe_apply_matches_jax(case):
    t, g, cf, n_shared, k = case
    jcfg, tcfg = _cfgs(groups=g, capacity_factor=cf, n_shared=n_shared, top_k=k)
    jparams = jm.moe_init(jax.random.PRNGKey(t + g), jcfg)
    x = np.random.default_rng(t * g).standard_normal((t, 32)).astype(np.float32)
    want, jaux = jax.jit(lambda p, x: jm.moe_apply(p, jcfg, x))(jparams, jnp.asarray(x))
    got, aux = tm.moe_apply(_port_params(jparams, tcfg), tcfg, torch.from_numpy(x))
    assert got.shape == (t, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert set(aux) == set(jaux) == {"drop_fraction", "router_entropy", "lb_loss"}
    for name in aux:
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]), rtol=TOL, atol=TOL)
    if cf == 0.25:
        assert float(aux["drop_fraction"]) > 0.3     # the drops are exercised
    if cf >= 2.0:
        assert float(aux["drop_fraction"]) == 0.0


def test_routes_match_jax_top_k_including_ties():
    """The port's top-k equals ``jax.lax.top_k``: descending, ties to the
    lower expert index.  A zero router makes every probability equal."""
    jcfg, tcfg = _cfgs(n_experts=8, top_k=3)
    x = np.random.default_rng(3).standard_normal((2, 16, 32)).astype(np.float32)
    for router in (np.random.default_rng(4).standard_normal((32, 8)).astype(np.float32),
                   np.zeros((32, 8), np.float32),
                   np.repeat(np.random.default_rng(5).standard_normal((32, 4)).astype(np.float32), 2, axis=1)):
        probs, gate_vals, idx = tm.route(torch.from_numpy(router), tcfg, torch.from_numpy(x))
        jprobs = jax.nn.softmax(jnp.einsum("gtd,de->gte", jnp.asarray(x), jnp.asarray(router)), axis=-1)
        jvals, jidx = jax.lax.top_k(jprobs, 3)
        differ = int((idx.numpy() != np.asarray(jidx)).sum())
        assert differ == 0, differ
        if not router.any():
            assert (idx.numpy() == [0, 1, 2]).all()
        jvals = jvals / jnp.maximum(jvals.sum(-1, keepdims=True), 1e-9)
        np.testing.assert_allclose(gate_vals.numpy(), np.asarray(jvals), rtol=TOL, atol=TOL)


def test_bf16_experts_keep_an_fp32_router():
    """A bf16 model keeps the router in fp32 (transformer_init and
    transformer_from_jax), so the routes and aux equal the reference's;
    the output is within the bf16 GEMMs' rounding."""
    jcfg, tcfg = _cfgs(dtype=jnp.bfloat16, n_shared=1, capacity_factor=0.5)
    kw = dict(vocab=64, d_model=32, n_layers=1, n_heads=2, kv_heads=1, d_head=16, d_ff=64)
    cfg = tt.TransformerConfig(**kw, moe=tcfg, dtype=torch.bfloat16)
    model = tt.transformer_init(0, cfg, device="cpu")
    layer = model.layers[0]["moe"]
    assert layer["router"].dtype == torch.float32 and layer["wi_gate"].dtype == torch.bfloat16
    assert layer["shared"]["wo"].dtype == torch.bfloat16 and model.embed.dtype == torch.bfloat16

    jparams = jm.moe_init(jax.random.PRNGKey(7), jcfg)
    x = np.random.default_rng(8).standard_normal((64, 32)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, jaux = jax.jit(lambda p, x: jm.moe_apply(p, jcfg, x))(jparams, xb)
    params = _port_params(jparams, tcfg)
    assert params["router"].dtype == torch.float32
    got, aux = tm.moe_apply(params, tcfg, torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    for name in aux:
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]), rtol=TOL, atol=TOL)
    assert float(aux["drop_fraction"]) > 0
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -6, atol=2 ** -5)

    # the module carried across from the reference's bf16 pytree keeps each leaf's dtype
    jtree = {"embed": np.zeros((64, 32), np.float32), "lm_head": np.zeros((32, 64), np.float32),
             "ln_f": {"scale": np.ones(32, np.float32)},
             "layers": {"ln1": {"scale": np.ones((1, 32), np.float32)}, "ln2": {"scale": np.ones((1, 32), np.float32)},
                        "attn": {n: np.asarray(p.float())[None] for n, p in model.layers[0]["attn"].items()},
                        "moe": jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32))[None], jparams)}}
    carried = tt.transformer_from_jax(jtree, cfg, device="cpu")
    moe = carried.layers[0]["moe"]
    assert moe["router"].dtype == torch.float32 and moe["wi_up"].dtype == torch.bfloat16
    assert torch.equal(moe["router"], params["router"]) and torch.equal(moe["wi_up"], params["wi_up"])


def test_moe_init_shapes_dtypes_and_scale():
    _, tcfg = _cfgs(dtype=jnp.bfloat16, d_model=64, d_ff=256, n_experts=3, n_shared=2)
    p = tm.moe_init(0, tcfg, device="cpu")
    assert p["router"].shape == (64, 3) and p["router"].dtype == torch.float32
    assert p["wi_gate"].shape == p["wi_up"].shape == (3, 64, 256) and p["wo"].shape == (3, 256, 64)
    assert p["shared"]["wi_gate"].shape == (64, 512) and p["shared"]["wo"].shape == (512, 64)
    assert all(p[n].dtype == torch.bfloat16 for n in ("wi_gate", "wi_up", "wo"))
    assert abs(float(p["wi_up"].float().std()) - 64 ** -0.5) < 0.01
    assert abs(float(p["wo"].float().std()) - 256 ** -0.5) < 0.005
    q = tm.moe_init(0, tcfg, device="cpu")
    assert torch.equal(p["wo"], q["wo"])
    assert tm._capacity(64, tcfg) == jm._capacity(64, _cfgs(d_model=64, d_ff=256, n_experts=3, n_shared=2)[0])


def test_moe_refuses_what_it_cannot_run():
    _, tcfg = _cfgs(groups=3)
    p = tm.moe_init(0, tcfg, device="cpu")
    with pytest.raises(ValueError, match="groups"):
        tm.moe_apply(p, tcfg, torch.zeros(32, 32))


HOOKS = ("shard_tokens", "shard_entries", "shard_dispatch", "shard_buffers")


def test_moe_calls_each_hook_on_the_reference_shapes():
    """The four sharding hooks are called, at groups 2, on the shapes the
    reference passes them: the tokens (G, Tg, d), the entries (G, T·k,
    d), and the (G, E, C, d) buffers (``shard_dispatch`` and
    ``shard_buffers``, each before and after the experts); identity hooks
    leave the output as it is without them."""
    jcfg, tcfg = _cfgs(groups=2, n_experts=4, top_k=2)
    jparams = jm.moe_init(jax.random.PRNGKey(4), jcfg)
    x = np.random.default_rng(4).standard_normal((32, 32)).astype(np.float32)
    seen, jseen = {h: [] for h in HOOKS}, {h: [] for h in HOOKS}

    def recorder(store, name):
        return lambda a: store[name].append(tuple(a.shape)) or a

    out, _ = tm.moe_apply(_port_params(jparams, tcfg), dataclasses.replace(
        tcfg, **{h: recorder(seen, h) for h in HOOKS}), torch.from_numpy(x))
    jm.moe_apply(jparams, dataclasses.replace(jcfg, **{h: recorder(jseen, h) for h in HOOKS}), jnp.asarray(x))
    cap = tm._capacity(16, tcfg)
    want = {"shard_tokens": {(2, 16, 32)}, "shard_entries": {(2, 32, 32)},
            "shard_dispatch": {(2, 4, cap, 32)}, "shard_buffers": {(2, 4, cap, 32)}}
    for h in HOOKS:
        assert seen[h] and set(seen[h]) == set(jseen[h]) == want[h], (h, seen[h], jseen[h])
    assert len(seen["shard_dispatch"]) == len(seen["shard_buffers"]) == 2
    plain, _ = tm.moe_apply(_port_params(jparams, tcfg), tcfg, torch.from_numpy(x))
    assert torch.equal(out, plain)
