"""Port parity for the recsys slice (``repro_torch.models.recsys``, the
four recsys configs, ``repro_torch.data.synthetic.ctr_batch``) against
the JAX package.

Inputs and weights come from numpy seeds: each model's weights fill the
reference's own parameter pytree (``jax.eval_shape`` of its ``*_init``)
and are carried across by ``recsys_from_jax``, so both packages run the
same model; one test carries the reference's own ``bst_init`` draws.

Tolerances (fp32 throughout):
* logits of the four forwards: rtol = 1e-5, atol = 1e-6 (the logits are
  O(0.01-1); fp32 products summed in other orders through at most four
  dense layers, 100 GRU steps for DIEN);
* user embeddings, lookups, the loss and retrieval scores: rtol = atol
  = 1e-6 (gathers are exact; a mean, a sum over fields or one dot
  product apart).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_arch as jax_get_arch
from repro.data.synthetic import ctr_batch as jax_ctr_batch
from repro.models import recsys as jr

from repro_torch.configs import get_arch, list_archs
from repro_torch.data.synthetic import ctr_batch
from repro_torch.models import recsys as tr

TOL_LOGIT = (1e-5, 1e-6)  # (rtol, atol)
TOL_EMB = 1e-6
RECSYS = ("autoint", "bst", "deepfm", "dien")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------


def test_list_archs_names_the_five_configs():
    """The recsys rankers, the LMs, the GNN and laf_dbscan: every arch
    of the reference's registry."""
    from repro.configs.registry import list_archs as jax_list_archs

    assert list_archs() == ["autoint", "bst", "deepfm", "deepseek-v2-236b", "dien", "gat-cora", "gemma3-27b",
                            "granite-20b", "grok-1-314b", "laf_dbscan", "llama3-8b"]
    assert set(list_archs()) == set(jax_list_archs())


@pytest.mark.parametrize("name", RECSYS)
def test_recsys_configs_match_jax(name):
    spec, jspec = get_arch(name), jax_get_arch(name)
    assert spec.family == jspec.family == "recsys" and dict(spec.skips) == dict(jspec.skips)
    assert {k: (s.kind, dict(s.meta)) for k, s in spec.shapes.items()} == \
        {k: (s.kind, dict(s.meta)) for k, s in jspec.shapes.items()}
    for make in ("make_config", "make_reduced_config"):
        cfg, jcfg = getattr(spec, make)(), getattr(jspec, make)()
        assert cfg.dtype == torch.float32 and type(cfg).__name__ == type(jcfg).__name__
        ours = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}
        theirs = {k: v for k, v in dataclasses.asdict(jcfg).items() if k != "dtype"}
        assert ours == theirs


@pytest.mark.parametrize("seq_len", [0, 20])
def test_ctr_batch_matches_jax(seq_len):
    vocabs = np.asarray([5_000_000, 1000, 7])
    a = ctr_batch(np.random.default_rng(2), 64, 3, vocabs, seq_len=seq_len)
    b = jax_ctr_batch(np.random.default_rng(2), 64, 3, vocabs, seq_len=seq_len)
    assert a.keys() == b.keys() == ({"ids", "label", "hist"} if seq_len else {"ids", "label"})
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# models with the reference's weights
# ---------------------------------------------------------------------------


def _reference_params(name, jcfg, seed):
    """A parameter pytree of the reference's ``{name}_init`` for ``jcfg``
    (its structure and shapes, from ``jax.eval_shape``), filled from a
    numpy seed: the reference's own draws cost a compile per table shape
    (about a minute for 39 fields), and the parity holds for any weights.
    Tables get N(0, 0.05^2), dense weights N(0, 1/d_in), vectors and
    scalars (biases, norm scales) N(0, 0.1^2) around their init (0, or 1
    for a norm scale), so no parameter is left at a constant."""
    shapes = jax.eval_shape(lambda key: getattr(jr, f"{name}_init")(key, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        keys = [str(getattr(p, "key", getattr(p, "idx", ""))) for p in path]
        x = rng.standard_normal(s.shape).astype(np.float32)
        if any("table" in k or k == "first_order" for k in keys):
            return x * 0.05
        if len(s.shape) == 2:
            return x / np.sqrt(s.shape[0])
        return x * 0.1 + (1.0 if keys[-1] == "scale" else 0.0)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _test_models_shapes(name):
    """``tests/test_models.py``'s configs and batches for ``name``."""
    if name in ("deepfm", "autoint"):
        rng = np.random.default_rng(3)
        vocabs = tuple(rng.integers(50, 500, size=39).tolist())
        batch = ctr_batch(rng, 32, 39, np.asarray(vocabs))
        cfg_cls = {"deepfm": "DeepFMConfig", "autoint": "AutoIntConfig"}[name]
        return (getattr(tr, cfg_cls)(vocab_sizes=vocabs), getattr(jr, cfg_cls)(vocab_sizes=vocabs),
                {"ids": batch["ids"]})
    rng = np.random.default_rng(4)
    inputs = {"hist": rng.integers(0, 1000, (16, 20)).astype(np.int32),
              "target": rng.integers(0, 1000, 16).astype(np.int32)}
    cfg_cls = {"dien": "DIENConfig", "bst": "BSTConfig"}[name]
    return getattr(tr, cfg_cls)(item_vocab=1000, seq_len=20), getattr(jr, cfg_cls)(item_vocab=1000, seq_len=20), inputs


def _reduced_shapes(name):
    cfg, jcfg = get_arch(name).make_reduced_config(), jax_get_arch(name).make_reduced_config()
    rng = np.random.default_rng(7)
    if name in ("deepfm", "autoint"):
        return cfg, jcfg, {"ids": ctr_batch(rng, 24, cfg.n_fields, np.asarray(cfg.vocab_sizes))["ids"]}
    batch = ctr_batch(rng, 24, 1, np.asarray([cfg.item_vocab]), seq_len=cfg.seq_len)
    return cfg, jcfg, {"hist": batch["hist"], "target": batch["ids"][:, 0]}


@pytest.mark.parametrize("sizes", ["reduced", "test_models"])
@pytest.mark.parametrize("name", RECSYS)
def test_forward_and_user_embedding_match_jax(name, sizes):
    cfg, jcfg, inputs = (_reduced_shapes if sizes == "reduced" else _test_models_shapes)(name)
    jparams = _reference_params(name, jcfg, seed=len(name) + len(sizes))
    params = tr.recsys_from_jax(jparams, cfg, device="cpu")
    assert isinstance(params, {"deepfm": tr.DeepFM, "autoint": tr.AutoInt, "dien": tr.DIEN, "bst": tr.BST}[name])
    n_ref = sum(a.size for a in jax.tree_util.tree_leaves(jparams))
    assert sum(p.numel() for p in params.parameters()) == n_ref
    assert sum(p.numel() for p in getattr(tr, f"{name}_init")(1, cfg, device="cpu").parameters()) == n_ref

    jin = [jnp.asarray(v) for v in inputs.values()]
    want = jax.jit(getattr(jr, f"{name}_forward"), static_argnums=1)(jparams, jcfg, *jin)
    got = getattr(tr, f"{name}_forward")(params, cfg, *inputs.values())
    assert got.shape == (jin[0].shape[0],) and got.dtype == torch.float32
    _close(got, want, *TOL_LOGIT)

    want_u = jax.jit(getattr(jr, f"{name}_user_embedding"), static_argnums=1)(jparams, jcfg, jin[0])
    got_u = getattr(tr, f"{name}_user_embedding")(params, cfg, inputs["ids" if "ids" in inputs else "hist"])
    assert got_u.shape == want_u.shape
    _close(got_u, want_u, TOL_EMB, TOL_EMB)


def test_bst_user_embedding_is_one_embedding_bag_call(monkeypatch):
    """``bst_user_embedding`` goes through ``embedding_bag(...,
    combiner="mean")`` once a call and equals the reference's ``take`` +
    mean, with the reference's own ``bst_init`` draws carried across."""
    cfg, jcfg, inputs = _reduced_shapes("bst")
    jparams = jr.bst_init(jax.random.PRNGKey(1), jcfg)
    params = tr.recsys_from_jax(_np(jparams), cfg, device="cpu")
    calls = []
    route = tr.embedding_bag

    def spy(table, ids, *, combiner="sum"):
        calls.append((tuple(table.shape), tuple(ids.shape), ids.dtype, combiner))
        return route(table, ids, combiner=combiner)

    monkeypatch.setattr(tr, "embedding_bag", spy)
    got = tr.bst_user_embedding(params, cfg, inputs["hist"])
    assert calls == [((cfg.item_vocab, cfg.embed_dim), inputs["hist"].shape, torch.int32, "mean")]
    want = jnp.take(jnp.asarray(np.asarray(jparams["item_table"])), jnp.asarray(inputs["hist"]), axis=0).mean(axis=1)
    _close(got, want, TOL_EMB, TOL_EMB)
    _close(got, jr.bst_user_embedding(jparams, jcfg, jnp.asarray(inputs["hist"])), TOL_EMB, TOL_EMB)


def test_lookup_bce_and_retrieval_match_jax():
    rng = np.random.default_rng(5)
    tables = [rng.standard_normal((v, 6)).astype(np.float32) for v in (30, 7, 100)]
    ids = np.stack([rng.integers(0, v, 40) for v in (30, 7, 100)], axis=1).astype(np.int32)
    _close(tr.lookup_fields([torch.from_numpy(t) for t in tables], ids),
           jr.lookup_fields([jnp.asarray(t) for t in tables], jnp.asarray(ids)), TOL_EMB, TOL_EMB)
    logits = (rng.standard_normal(64) * 4).astype(np.float32)
    labels = rng.integers(0, 2, 64).astype(np.float32)
    _close(tr.bce_loss(torch.from_numpy(logits), labels), jr.bce_loss(jnp.asarray(logits), jnp.asarray(labels)),
           TOL_EMB, TOL_EMB)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    cands = rng.standard_normal((500, 32)).astype(np.float32)
    got = tr.retrieval_scores(torch.from_numpy(q), torch.from_numpy(cands))
    assert got.shape == (3, 500)
    _close(got, jr.retrieval_scores(jnp.asarray(q), jnp.asarray(cands)), 1e-5, 1e-5)


def test_dien_attention_changes_output():
    """The AUGRU's attention makes the target item matter (the
    reference's ``test_dien_attention_changes_output``)."""
    cfg = tr.DIENConfig(item_vocab=100, seq_len=10)
    params = tr.dien_init(0, cfg, device="cpu")
    hist = np.random.default_rng(5).integers(0, 100, (4, 10)).astype(np.int32)
    a = tr.dien_forward(params, cfg, hist, np.zeros(4, np.int32))
    b = tr.dien_forward(params, cfg, hist, np.full(4, 7, np.int32))
    assert not torch.allclose(a, b)


def test_inits_take_a_generator_of_their_device():
    cfg = get_arch("bst").make_reduced_config()
    gen = torch.Generator().manual_seed(3)
    a = tr.bst_init(gen, cfg, device="cpu")
    b = tr.bst_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert a["blocks"][0]["ln1"]["scale"].eq(1).all() and a["mlp"][0]["b"].eq(0).all()
    with pytest.raises(TypeError, match="recsys"):
        tr.recsys_from_jax({}, object(), device="cpu")


# ---------------------------------------------------------------------------
# training: gradients and one train step against the reference
# ---------------------------------------------------------------------------

from repro.train import optimizer as jopt  # noqa: E402

from repro_torch.launch.steps import recsys_optimizer, recsys_train_step  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

TOL_GRAD = 1e-4   # relative L2 of each parameter's gradient
TOL_STEP = 1e-6   # parameters after one AdamW step, of their scale (|g| >= 1e-6; else 2 lr)


def _ref_leaf(tree, name):
    x = tree
    for part in name.split("."):
        x = x[int(part)] if isinstance(x, (list, tuple)) else x[part]
    return np.asarray(x)


def _fwd(name, jcfg):
    return {"deepfm": lambda p, b: jr.deepfm_forward(p, jcfg, b["ids"]),
            "autoint": lambda p, b: jr.autoint_forward(p, jcfg, b["ids"]),
            "dien": lambda p, b: jr.dien_forward(p, jcfg, b["hist"], b["target"]),
            "bst": lambda p, b: jr.bst_forward(p, jcfg, b["hist"], b["target"])}[name]


def _train_inputs(name):
    cfg, jcfg, inputs = _reduced_shapes(name)
    label = np.random.default_rng(11).integers(0, 2, next(iter(inputs.values())).shape[0]).astype(np.float32)
    return cfg, jcfg, {**inputs, "label": label}


@pytest.mark.parametrize("name", RECSYS)
def test_recsys_gradients_match_jax(name):
    """``bce_loss(recsys_logits(...))`` and every parameter's gradient
    against ``jax.value_and_grad`` of the reference's loss (BST through
    its ``take`` path)."""
    cfg, jcfg, batch = _train_inputs(name)
    jparams = _reference_params(name, jcfg, seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    fwd = _fwd(name, jcfg)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: jr.bce_loss(fwd(p, jbatch), jbatch["label"])))(jparams)
    params = tr.recsys_from_jax(jparams, cfg, device="cpu")
    params.requires_grad_(True)
    loss = tr.bce_loss(tr.recsys_logits(params, cfg, batch), batch["label"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    names = [n for n, _ in params.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(want))
    for n, p in params.named_parameters():
        w = _ref_leaf(want, n)
        rel = np.linalg.norm(p.grad.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= TOL_GRAD, (n, rel)


@pytest.mark.parametrize("name", RECSYS)
def test_recsys_train_step_matches_the_reference_step(name):
    """One ``recsys_train_step`` (``adamw(lr=1e-3)``) against the
    reference's ``build_recsys_train`` step body: the loss and the
    updated parameters; the serving forward builds no graph."""
    cfg, jcfg, batch = _train_inputs(name)
    jparams = _reference_params(name, jcfg, seed=6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    fwd = _fwd(name, jcfg)

    def jstep(p):
        loss, grads = jax.value_and_grad(lambda q: jr.bce_loss(fwd(q, jbatch), jbatch["label"]))(p)
        opt = jopt.adamw(lr=1e-3)
        updates, _ = opt.update(grads, opt.init(p), p)
        return jopt.apply_updates(p, updates), loss, grads

    want_p, want_loss, want_g = jax.jit(jstep)(jparams)
    params = tr.recsys_from_jax(jparams, cfg, device="cpu")
    tree = dict(params.named_parameters())
    tree, state, metrics = recsys_train_step(params, cfg, tree, recsys_optimizer().init(tree), batch)
    np.testing.assert_allclose(metrics["loss"].item(), float(want_loss), rtol=1e-6)
    assert int(state["step"]) == 1
    for n, p in params.named_parameters():
        w, g = _ref_leaf(want_p, n), _ref_leaf(want_g, n)
        atol = np.where(np.abs(g) >= 1e-6, TOL_STEP * max(1.0, float(np.abs(w).max())), 2e-3)
        assert (np.abs(p.detach().numpy() - w) <= atol).all(), n
    serve_in = [batch[k] for k in (("ids",) if "ids" in batch else ("hist", "target"))]
    assert getattr(tr, f"{name}_forward")(params, cfg, *serve_in).grad_fn is None
