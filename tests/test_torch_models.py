"""Port parity for the model slice (``repro_torch.models.layers``,
``repro_torch.models.transformer``, ``repro_torch.configs``,
``repro_torch.data.synthetic.token_stream``) against the JAX package.

Inputs come from numpy seeds; the transformer's weights are the JAX
package's own ``transformer_init`` draws, carried across by
``transformer_from_jax``, so both packages run the same model.

Tolerances (fp32 throughout):
* layers: rtol = atol = 1e-5 (one or two fp32 operations apart; cos/sin
  of the rotary angles come from two math libraries);
* attention: 2e-5, the reference's own tolerance for its kernel;
* the transformer (logits of forward, prefill and 8 decode steps, and
  the caches): rtol = atol = 1e-4, from fp32 products summed in other
  orders through 2-4 layers.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_arch as jax_get_arch
from repro.data.synthetic import token_stream as jax_token_stream
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.models.moe import MoEConfig

from repro_torch.configs import get_arch, list_archs
from repro_torch.data.synthetic import token_stream
from repro_torch.models import layers as tl
from repro_torch.models import mla as tmla_mod
from repro_torch.models import moe as tmoe_mod
from repro_torch.models import transformer as tt

TOL_LAYER = 1e-5
TOL_ATTN = 2e-5
TOL_MODEL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------


def test_registry_and_llama3_configs_match_jax():
    assert list_archs() == ["autoint", "bst", "deepfm", "deepseek-v2-236b", "dien", "gat-cora", "gemma3-27b",
                            "granite-20b", "grok-1-314b", "laf_dbscan", "llama3-8b"]
    spec, jspec = get_arch("llama3-8b"), jax_get_arch("llama3-8b")
    assert spec.family == jspec.family and dict(spec.skips) == dict(jspec.skips)
    assert {k: (s.kind, dict(s.meta)) for k, s in spec.shapes.items()} == \
        {k: (s.kind, dict(s.meta)) for k, s in jspec.shapes.items()}
    for make, jmake, dtype in [("make_config", "make_config", torch.bfloat16),
                               ("make_reduced_config", "make_reduced_config", torch.float32)]:
        cfg, jcfg = getattr(spec, make)(), getattr(jspec, jmake)()
        assert cfg.dtype == dtype
        ours = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}
        theirs = {k: v for k, v in dataclasses.asdict(jcfg).items() if k != "dtype"}
        assert ours == theirs
        assert cfg.param_count() == jcfg.param_count()
    assert get_arch("laf_dbscan").family == "cluster"  # ported with the sharded plane
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_token_stream_matches_jax():
    a = token_stream(np.random.default_rng(0), 4, 64, 128256)
    b = jax_token_stream(np.random.default_rng(0), 4, 64, 128256)
    for x, y in zip(a, b):
        assert x.dtype == np.int32 and np.array_equal(x, y)


def test_param_count_is_the_meta_models_numel():
    cfg = get_arch("llama3-8b").make_config()
    model = tt.transformer_init(0, cfg, device="meta")
    assert cfg.param_count() == 8_030_261_248
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert all(p.device.type == "meta" and p.dtype == torch.bfloat16 for p in model.parameters())


def test_param_count_moe_and_mla_arithmetic_and_refusal():
    """The MoE/MLA counts follow the reference's arithmetic, and such
    configs now build and run (they raised NotImplementedError before
    MoE and MLA were ported); an unknown attention still raises."""
    moe = MoEConfig(d_model=64, d_ff=32, n_experts=4, top_k=2, n_shared=1, dtype=jnp.float32)
    kw = dict(vocab=256, d_model=64, n_layers=4, n_heads=4, kv_heads=2, d_head=16, d_ff=128, n_dense_layers=1)
    jcfg = jt.TransformerConfig(**kw, moe=moe, dtype=jnp.float32)
    tmoe = tmoe_mod.MoEConfig(d_model=64, d_ff=32, n_experts=4, top_k=2, n_shared=1, dtype=torch.float32)
    cfg = tt.TransformerConfig(**kw, moe=tmoe, dtype=torch.float32)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count() < cfg.param_count()
    mla = tmla_mod.MLAConfig(d_model=64, q_lora_rank=32, n_heads=4, qk_nope_dim=16, qk_rope_dim=8, kv_lora_rank=16,
                             v_dim=16)
    jmla = types.SimpleNamespace(**dataclasses.asdict(mla))
    cfg_mla = tt.TransformerConfig(**kw, attention="mla", mla=mla, dtype=torch.float32)
    assert cfg_mla.param_count() == jt.TransformerConfig(**kw, attention="mla", mla=jmla).param_count()
    toks = np.random.default_rng(0).integers(0, 256, size=(2, 8))
    for good, extra in ((cfg, 0), (cfg_mla, kw["n_layers"] * (mla.q_lora_rank + mla.kv_lora_rank))):
        model = tt.transformer_init(0, good, device="cpu")
        # the reference's count leaves out MLA's two norm scales a layer
        assert sum(p.numel() for p in model.parameters()) == good.param_count() + extra
        assert torch.isfinite(tt.transformer_forward(model, good, toks)).all()
        cache = tt.make_cache(good, 2, 8, device="cpu")
        logits, _ = tt.transformer_decode_step(model, good, toks[:, :1], cache, 0)
        assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="attention"):
        tt.transformer_init(0, dataclasses.replace(cfg, attention="linear"), device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_norms_rope_and_mlps_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    scale, bias = (rng.standard_normal(32).astype(np.float32) for _ in range(2))
    _close(tl.rmsnorm({"scale": _t(scale)}, _t(x)), jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
           TOL_LAYER)
    jp, tp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, {"scale": _t(scale), "bias": _t(bias)}
    _close(tl.layernorm(tp, _t(x)), jl.layernorm(jp, jnp.asarray(x)), TOL_LAYER)

    pos = rng.integers(0, 64, size=(2, 5, 3)).astype(np.int32)
    for theta in (10000.0, 500000.0):
        _close(tl.apply_rope(_t(x), _t(pos), theta), jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), TOL_LAYER)
    _close(tl.rope_frequencies(32, 500000.0, device="cpu"), jl.rope_frequencies(32, 500000.0), TOL_LAYER)

    h = rng.standard_normal((4, 7, 32)).astype(np.float32)
    ffn = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
           for k, s in {"wi_gate": (32, 48), "wi_up": (32, 48), "wo": (48, 32)}.items()}
    jffn, tffn = {k: jnp.asarray(v) for k, v in ffn.items()}, {k: _t(v) for k, v in ffn.items()}
    _close(tl.swiglu(tffn, _t(h)), jl.swiglu(jffn, jnp.asarray(h)), TOL_LAYER)
    _close(tl.geglu(tffn, _t(h)), jl.geglu(jffn, jnp.asarray(h)), TOL_LAYER)

    tower = [{"w": rng.standard_normal((32, 16)).astype(np.float32), "b": rng.standard_normal(16).astype(np.float32)},
             {"w": rng.standard_normal((16, 8)).astype(np.float32)}]
    jt_ = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in tower]
    tt_ = [{k: _t(v) for k, v in layer.items()} for layer in tower]
    for final in (False, True):
        _close(tl.mlp_apply(tt_, _t(h), final), jl.mlp_apply(jt_, jnp.asarray(h), final), TOL_LAYER)


def test_init_helpers_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, 256, 64, torch.bfloat16, device="cpu")
    assert w.shape == (256, 64) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) - 1 / 16) < 0.01
    assert tl.rmsnorm_init(8, device="cpu")["scale"].eq(1).all()
    assert tl.layernorm_init(8, device="cpu")["bias"].eq(0).all()
    assert set(tl.swiglu_init(gen, 8, 16, device="cpu")) == set(tl.geglu_init(gen, 8, 16, device="cpu")) == \
        {"wi_gate", "wi_up", "wo"}
    tower = tl.mlp_init(gen, [8, 4, 2], bias=True, device="cpu")
    assert [tuple(p["w"].shape) for p in tower] == [(8, 4), (4, 2)] and "b" in tower[0]


def test_cross_entropy_losses_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 16, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(2, 16)).astype(np.int32)
    _close(tl.cross_entropy_loss(_t(logits), _t(labels)),
           jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)), TOL_LAYER)
    h = rng.standard_normal((2, 16, 24)).astype(np.float32)
    w = rng.standard_normal((24, 50)).astype(np.float32) / 5
    for chunk in (4, 16, 512):
        _close(tl.chunked_cross_entropy(_t(w), _t(h), _t(labels), chunk=chunk),
               jl.chunked_cross_entropy(jnp.asarray(w), jnp.asarray(h), jnp.asarray(labels), chunk=chunk), TOL_LAYER)


# (B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset, valid_len)
ATTN_CASES = [
    (2, 4, 4, 64, 64, 16, True, None, None, None),
    (2, 4, 4, 64, 64, 16, True, 16, None, None),
    (2, 4, 4, 64, 64, 16, False, None, None, None),
    (2, 8, 2, 32, 32, 16, True, None, None, None),     # GQA
    (2, 4, 2, 1, 24, 16, True, None, 9, 10),           # decode into a cache of 24 slots
    (2, 4, 1, 1, 24, 32, True, 4, 17, 18),             # decode with a window
    (1, 4, 2, 4, 24, 16, True, None, 12, 16),          # 4 queries into a cache prefix
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_blockwise_attention_matches_jax(case):
    b, hq, hkv, sq, sk, d, causal, window, q_offset, valid_len = case
    rng = np.random.default_rng(sk + sq + d)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, sk, d)).astype(np.float32) for _ in range(2))
    want = jl.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
                                  q_offset=q_offset, kv_block=8, valid_len=valid_len)
    got = tl.blockwise_attention(_t(q), _t(k), _t(v), causal=causal, window=window, q_offset=q_offset,
                                 kv_block=8, valid_len=valid_len)
    _close(got, want, TOL_ATTN)


def test_blockwise_attention_refuses_unaligned_offsets():
    """Offsets off the right-aligned prefix view (one query at q_offset 5
    against valid_len 10 of 24 keys; valid_len past Sk) are taken as the
    reference takes them, with its result."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((1, 2, 1, 16)).astype(np.float32)
    kv = rng.standard_normal((1, 2, 24, 16)).astype(np.float32)
    for kw in (dict(q_offset=5, valid_len=10), dict(valid_len=30)):
        want = jl.blockwise_attention(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), kv_block=8, **kw)
        _close(tl.blockwise_attention(_t(q), _t(kv), _t(kv), kv_block=8, **kw), want, TOL_ATTN)


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------


def tiny_kw(**kw):
    base = dict(vocab=256, d_model=64, n_layers=4, n_heads=4, kv_heads=2, d_head=16, d_ff=128)
    base.update(kw)
    return base


def _pair(kind, kw):
    """(JAX config, port config) of one case."""
    if kind == "llama3-reduced":
        return jax_get_arch("llama3-8b").make_reduced_config(), get_arch("llama3-8b").make_reduced_config()
    return (jt.TransformerConfig(**tiny_kw(**kw), dtype=jnp.float32),
            tt.TransformerConfig(**tiny_kw(**kw), dtype=torch.float32))


MODEL_CASES = [
    ("llama3-reduced", {}),
    ("tiny", {}),                                  # dense GQA
    ("tiny", {"window": 4, "global_every": 2}),    # gemma-style hybrid (narrow enough to mask in 8 steps)
    ("tiny", {"kv_heads": 1}),                     # MQA (granite)
]


@pytest.mark.parametrize("kind,kw", MODEL_CASES, ids=["llama3-reduced", "gqa", "window", "mqa"])
def test_transformer_serving_matches_jax(kind, kw):
    """Forward logits, prefill logits, loss, and 8 decode steps (logits
    and caches) against the JAX package with the same weights."""
    jcfg, cfg = _pair(kind, kw)
    jparams = jt.transformer_init(jax.random.PRNGKey(0), jcfg)
    model = tt.transformer_from_jax(_np(jparams), cfg, device="cpu")
    b, s, steps = 2, 16, 8
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)

    fwd = np.asarray(jax.jit(lambda p, t: jt.transformer_forward(p, jcfg, t))(jparams, toks))
    got = tt.transformer_forward(model, cfg, torch.from_numpy(toks))
    assert got.shape == (b, s, cfg.vocab) and got.dtype == torch.float32
    _close(got, fwd, TOL_MODEL)
    _close(tt.transformer_prefill(model, cfg, toks), fwd[:, -1], TOL_MODEL)
    _close(tt.transformer_loss(model, cfg, toks, toks),
           jt.transformer_loss(jparams, jcfg, jnp.asarray(toks), jnp.asarray(toks)), TOL_MODEL)

    jstep = jax.jit(lambda p, t, c, n: jt.transformer_decode_step(p, jcfg, t, c, n))
    jcache = jt.make_cache(jcfg, b, s, dtype=jnp.float32)
    cache = tt.make_cache(cfg, b, s, device="cpu")
    for t in range(steps):
        want, jcache = jstep(jparams, jnp.asarray(toks[:, t : t + 1]), jcache, t)
        logits, out = tt.transformer_decode_step(model, cfg, toks[:, t : t + 1], cache, t)
        assert out is cache and logits.shape == (b, cfg.vocab)
        _close(logits, want, TOL_MODEL)
        _close(logits, fwd[:, t], TOL_MODEL)   # the reference's own decode == forward invariant
    for name in ("k", "v"):
        _close(cache[name], jcache[name], TOL_MODEL)
        assert not cache[name][:, :, :, steps:].any()


def test_transformer_with_prefix_layers_matches_jax():
    """``prefix_layers`` (the unstacked leading dense layers) carry across
    and run before the stack, in forward and decode."""
    jcfg, cfg = _pair("tiny", {"n_layers": 3})
    jparams = jt.transformer_init(jax.random.PRNGKey(2), jcfg)
    # one stacked layer moved to the prefix: the reference runs prefix
    # layers unstacked before the scan, whatever made them
    params = _np(jparams)
    params["prefix_layers"] = [jax.tree_util.tree_map(lambda a: a[0], params["layers"])]
    params["layers"] = jax.tree_util.tree_map(lambda a: a[1:], params["layers"])
    jcfg_p = dataclasses.replace(jcfg, n_dense_layers=1)
    cfg_p = dataclasses.replace(cfg, n_dense_layers=1)
    model = tt.transformer_from_jax(params, cfg_p, device="cpu")
    assert len(model.prefix_layers) == 1 and len(model.layers) == 2
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    fwd = np.asarray(jt.transformer_forward(jp, jcfg_p, jnp.asarray(toks)))
    _close(tt.transformer_forward(model, cfg_p, toks), fwd, TOL_MODEL)
    _close(tt.transformer_forward(tt.transformer_from_jax(_np(jparams), cfg, device="cpu"), cfg, toks), fwd,
           TOL_MODEL)
    cache = tt.make_cache(cfg_p, 2, 8, device="cpu")
    assert cache["prefix_k"].shape == (1, 2, 2, 8, 16) and cache["k"].shape == (2, 2, 2, 8, 16)
    for t in range(4):
        logits, cache = tt.transformer_decode_step(model, cfg_p, toks[:, t : t + 1], cache, t)
        _close(logits, fwd[:, t], TOL_MODEL)


def test_transformer_init_draws_the_reference_distribution():
    cfg = tt.TransformerConfig(**tiny_kw(vocab=512, d_model=128), dtype=torch.bfloat16)
    a, b = tt.transformer_init(0, cfg, device="cpu"), tt.transformer_init(0, cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in a.parameters())
    assert abs(float(a.embed.float().std()) - 0.02) < 0.002
    assert abs(float(a.layers[0]["attn"]["wq"].float().std()) - 128 ** -0.5) < 0.01
    assert abs(float(a.layers[0]["ffn"]["wo"].float().std()) - 128 ** -0.5) < 0.01
    assert a.ln_f["scale"].eq(1).all() and a.layers[1]["ln2"]["scale"].eq(1).all()
    assert sum(p.numel() for p in a.parameters()) == cfg.param_count()
    gen = torch.Generator().manual_seed(0)
    c = tt.transformer_init(gen, cfg, device="cpu")
    assert torch.equal(c.lm_head, a.lm_head)
