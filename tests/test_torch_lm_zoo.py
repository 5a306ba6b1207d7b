"""Port parity for the rest of the LM serving stack against the JAX
package: the gemma3-27b, granite-20b, grok-1-314b and deepseek-v2-236b
configs (full and reduced), their reduced models end to end (forward,
prefill, loss, 8 decode steps with their caches), and the windowed
ring-buffer decode of hybrid local:global configs.

The weights are the JAX package's own ``transformer_init`` draws carried
across by ``transformer_from_jax``; token inputs come from numpy seeds.
Tolerance: fp32 rtol = atol = 1e-4 (``TOL_MODEL`` of
``tests/test_torch_models.py``).  The windowed decode runs ``2 W + 3``
steps (each ring wraps twice) against the reference's
``transformer_decode_step_windowed`` and against the port's own
``transformer_decode_step`` on a full cache, for a config with local
suffix layers after the last full block and one without.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as jl
from repro.models import transformer as jt

from repro_torch.configs import get_arch
from repro_torch.models import transformer as tt

TOL = 1e-4
ZOO = ["gemma3-27b", "granite-20b", "grok-1-314b", "deepseek-v2-236b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _fields(cfg):
    """A config's fields as plain values, dtypes dropped at every level
    (jnp against torch dtypes are compared apart)."""
    def strip(d):
        return {k: strip(v) if isinstance(v, dict) else v for k, v in d.items() if k != "dtype"}
    return strip(dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", ZOO)
def test_zoo_configs_match_jax(name):
    spec, jspec = get_arch(name), jax_get_arch(name)
    assert spec.family == jspec.family == "lm" and dict(spec.skips) == dict(jspec.skips)
    assert spec.notes == jspec.notes
    assert {k: (s.kind, dict(s.meta)) for k, s in spec.shapes.items()} == \
        {k: (s.kind, dict(s.meta)) for k, s in jspec.shapes.items()}
    for make, dtype in (("make_config", torch.bfloat16), ("make_reduced_config", torch.float32)):
        cfg, jcfg = getattr(spec, make)(), getattr(jspec, make)()
        assert _fields(cfg) == _fields(jcfg)
        assert cfg.dtype == dtype
        if cfg.moe is not None:
            assert cfg.moe.dtype == dtype and type(cfg.moe).__module__ == "repro_torch.models.moe"
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()


def test_zoo_full_configs_build_on_meta():
    """The published widths build as the reference's pytree: the numel
    equals ``param_count`` (MLA adds its two norm scales a layer, which
    the reference's count leaves out) and the bytes fit one 80 GB card
    at the depths the chip phase runs."""
    gib = {}
    for name in ZOO:
        cfg = get_arch(name).make_config()
        model = tt.transformer_init(0, cfg, device="meta")
        extra = cfg.n_layers * (cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank) if cfg.mla else 0
        assert sum(p.numel() for p in model.parameters()) == cfg.param_count() + extra
        if cfg.moe is not None:
            assert model.layers[0]["moe"]["router"].dtype == torch.float32
            cfg = dataclasses.replace(cfg, n_layers=4 if cfg.attention == "gqa" else 5)
            model = tt.transformer_init(0, cfg, device="meta")
        gib[name] = sum(p.numel() * p.element_size() for p in model.parameters()) / 2 ** 30
    assert 52 < gib["gemma3-27b"] < 53 and 52 < gib["granite-20b"] < 53
    assert 39 < gib["grok-1-314b"] < 40 and 32 < gib["deepseek-v2-236b"] < 33


@pytest.mark.parametrize("name", ZOO)
def test_zoo_reduced_models_match_jax(name):
    """Forward logits, prefill logits, loss, and 8 decode steps (logits
    and caches) of each reduced config."""
    jcfg, cfg = jax_get_arch(name).make_reduced_config(), get_arch(name).make_reduced_config()
    jparams = jt.transformer_init(jax.random.PRNGKey(0), jcfg)
    model = tt.transformer_from_jax(_np(jparams), cfg, device="cpu")
    b, s, steps = 2, 16, 8
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)

    fwd = np.asarray(jax.jit(lambda p, t: jt.transformer_forward(p, jcfg, t))(jparams, toks))
    aux = []
    got = tt.transformer_forward(model, cfg, toks, moe_aux=aux)
    assert got.shape == (b, s, cfg.vocab)
    _close(got, fwd)
    assert len(aux) == (cfg.n_layers - cfg.n_dense_layers if cfg.moe else 0)
    _close(tt.transformer_prefill(model, cfg, toks), fwd[:, -1])
    # the reference's loss is its cross-entropy of these forward logits
    want_loss = jl.cross_entropy_loss(jnp.asarray(fwd), jnp.asarray(toks))
    _close(tt.transformer_loss(model, cfg, toks, toks), want_loss)

    jstep = jax.jit(lambda p, t, c, n: jt.transformer_decode_step(p, jcfg, t, c, n))
    jcache = jt.make_cache(jcfg, b, s, dtype=jnp.float32)
    cache = tt.make_cache(cfg, b, s, device="cpu")
    assert set(cache) == set(jcache)
    for t in range(steps):
        want, jcache = jstep(jparams, jnp.asarray(toks[:, t : t + 1]), jcache, t)
        logits, out = tt.transformer_decode_step(model, cfg, toks[:, t : t + 1], cache, t)
        assert out is cache
        _close(logits, want)
    for key in cache:
        _close(cache[key], jcache[key])


def _hybrid(n_layers):
    jcfg = dataclasses.replace(jax_get_arch("gemma3-27b").make_reduced_config(), n_layers=n_layers)
    cfg = dataclasses.replace(get_arch("gemma3-27b").make_reduced_config(), n_layers=n_layers)
    return jcfg, cfg


@pytest.mark.parametrize("n_layers", [6, 8], ids=["blocks-only", "with-suffix"])
def test_windowed_decode_matches_jax_and_full_cache(n_layers):
    """2 W + 3 steps (the 8-slot rings wrap twice): the windowed step
    against the reference's and against the port's plain decode on a
    full cache, logits every step, the rings and global caches at the
    end, and the last step against the forward."""
    jcfg, cfg = _hybrid(n_layers)
    w = cfg.window
    steps = 2 * w + 3
    nb, ge, ns = tt._hybrid_blocks(cfg)
    assert (nb, ge, ns) == (1, 6, n_layers - 6)
    jparams = jt.transformer_init(jax.random.PRNGKey(3), jcfg)
    model = tt.transformer_from_jax(_np(jparams), cfg, device="cpu")
    b = 2
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=(b, steps)).astype(np.int32)

    jstep = jax.jit(lambda p, t, c, n: jt.transformer_decode_step_windowed(p, jcfg, t, c, n))
    jcache = jt.make_cache_windowed(jcfg, b, steps, dtype=jnp.float32)
    cache = tt.make_cache_windowed(cfg, b, steps, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: tuple(v.shape) for k, v in jcache.items()}
    full = tt.make_cache(cfg, b, steps, device="cpu")
    for t in range(steps):
        tok = toks[:, t : t + 1]
        want, jcache = jstep(jparams, jnp.asarray(tok), jcache, t)
        logits, out = tt.transformer_decode_step_windowed(model, cfg, tok, cache, t)
        plain, _ = tt.transformer_decode_step(model, cfg, tok, full, t)
        assert out is cache
        _close(logits, want)
        _close(logits, plain)
    for key in cache:
        _close(cache[key], jcache[key])
    fwd = tt.transformer_forward(model, cfg, toks)
    _close(logits, fwd[:, -1])


@pytest.mark.parametrize("n_fill", [5, 8, 11], ids=["short-of-the-ring", "to-the-ring-edge", "past-it"])
def test_windowed_prefill_leaves_the_caches_of_its_decode_steps(n_fill):
    """The windowed prefill of the first ``n_fill`` tokens, then decode
    steps past 2 W: its logits are the forward's at the last filled
    position, its caches the reference's after ``n_fill`` decode steps,
    and every later step's logits and the final caches the reference's
    decode all the way."""
    jcfg, cfg = _hybrid(8)
    w = cfg.window
    steps = 2 * w + 3
    jparams = jt.transformer_init(jax.random.PRNGKey(5), jcfg)
    model = tt.transformer_from_jax(_np(jparams), cfg, device="cpu")
    b = 2
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(b, steps)).astype(np.int32)
    jstep = jax.jit(lambda p, t, c, n: jt.transformer_decode_step_windowed(p, jcfg, t, c, n))
    jcache = jt.make_cache_windowed(jcfg, b, steps, dtype=jnp.float32)
    for t in range(n_fill):
        want, jcache = jstep(jparams, jnp.asarray(toks[:, t : t + 1]), jcache, t)
    cache = tt.make_cache_windowed(cfg, b, steps, device="cpu")
    logits, out = tt.transformer_prefill_windowed(model, cfg, toks[:, :n_fill], cache)
    assert out is cache
    _close(logits, want)
    for key in cache:
        _close(cache[key], jcache[key])
    for t in range(n_fill, steps):
        want, jcache = jstep(jparams, jnp.asarray(toks[:, t : t + 1]), jcache, t)
        logits, cache = tt.transformer_decode_step_windowed(model, cfg, toks[:, t : t + 1], cache, t)
        _close(logits, want)
    for key in cache:
        _close(cache[key], jcache[key])


def test_windowed_decode_refuses_other_configs():
    cfg = get_arch("granite-20b").make_reduced_config()   # no window
    with pytest.raises(ValueError, match="window"):
        tt.make_cache_windowed(cfg, 1, 8, device="cpu")
    gemma = get_arch("gemma3-27b").make_reduced_config()
    model = tt.transformer_init(0, gemma, device="cpu")
    with pytest.raises(ValueError, match="prefix"):
        tt.transformer_decode_step_windowed(model, dataclasses.replace(gemma, n_dense_layers=1), [[0]], {}, 0)
    # the window wider than the cache: rings of max_len slots
    cache = tt.make_cache_windowed(gemma, 1, 5, device="cpu")
    assert cache["loc_k"].shape[-2] == 5 and cache["glob_k"].shape[-2] == 5


def test_zoo_entry_points_default_to_cuda():
    """Without a card the slice's entry points raise unless told
    device='cpu'; with one, the default is cuda."""
    from repro_torch.models import moe as tm

    gemma = get_arch("gemma3-27b").make_reduced_config()
    deepseek = get_arch("deepseek-v2-236b").make_reduced_config()
    calls = (lambda: tt.make_cache_windowed(gemma, 1, 8)["loc_k"], lambda: tt.make_cache(deepseek, 1, 8)["ckv"],
             lambda: tt.transformer_init(0, deepseek).embed, lambda: tm.moe_init(0, deepseek.moe)["router"])
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
            continue
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tt.make_cache(deepseek, 1, 8, device="cpu")["prefix_ckv"].shape == (1, 1, 8, 16)
