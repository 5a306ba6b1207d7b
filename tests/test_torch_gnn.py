"""Port parity for the GNN slice (``repro_torch.models.gnn``,
``repro_torch.configs.gat_cora``, ``repro_torch.data.graph_sampler``,
the graph generators of ``repro_torch.data.synthetic`` and
``launch.steps.gnn_train_step``) against the JAX package.

The weights are the reference's own ``gat_init`` draws carried across
by ``gnn_from_jax``; graphs and features come from numpy seeds.
Tolerances (fp32): logits, losses and gradients rtol = atol = 1e-5
(segment sums over at most ~20 edges a node and two dense layers, in
other orders; the segment max's gradient is taken as 0, where the
reference hands it rounding noise); parameters after a train step 1e-6
relative; generators and the sampler byte-equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_arch as jax_get_arch
from repro.configs.gat_cora import config_for_shape as jax_config_for_shape
from repro.data import graph_sampler as jgs
from repro.data.synthetic import powerlaw_graph as jax_powerlaw_graph
from repro.data.synthetic import random_small_graphs as jax_small_graphs
from repro.models import gnn as jgnn
from repro.train import optimizer as jopt

from repro_torch.configs import get_arch
from repro_torch.configs.gat_cora import config_for_shape
from repro_torch.data import graph_sampler as tgs
from repro_torch.data.synthetic import powerlaw_graph, random_small_graphs
from repro_torch.launch.steps import gnn_optimizer, gnn_train_step
from repro_torch.models import gnn as tgnn
from repro_torch.train.optimizer import tree_leaves

TOL = 1e-5
TOL_STEP = 1e-6


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


def test_gat_cora_config_and_shapes_match_jax():
    spec, jspec = get_arch("gat-cora"), jax_get_arch("gat-cora")
    assert spec.family == jspec.family == "gnn" and spec.notes == jspec.notes
    assert {k: (s.kind, dict(s.meta)) for k, s in spec.shapes.items()} == \
        {k: (s.kind, dict(s.meta)) for k, s in jspec.shapes.items()}
    for make in ("make_config", "make_reduced_config"):
        cfg, jcfg = getattr(spec, make)(), getattr(jspec, make)()
        assert cfg.dtype == torch.float32 and _fields(cfg) == _fields(jcfg)
    for shape in spec.shapes:
        assert _fields(config_for_shape(shape)) == _fields(jax_config_for_shape(shape))


def test_graph_generators_are_byte_equal():
    want = jax_powerlaw_graph(np.random.default_rng(5), 300, 2000, 12)
    got = powerlaw_graph(np.random.default_rng(5), 300, 2000, 12)
    want_b = jax_small_graphs(np.random.default_rng(6), 4, 30, 64, 16)
    got_b = random_small_graphs(np.random.default_rng(6), 4, 30, 64, 16)
    for w, g in ((want, got), (want_b, got_b)):
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes()


@pytest.mark.parametrize("n_nodes", [500, 150_000])  # the second past 2^16: the CSR order's high pass
def test_csr_and_fanout_sample_equal_under_one_rng(n_nodes):
    """``build_csr`` and ``sample_fanout`` (isolated nodes among the seeds:
    masked self-edges) give the reference's arrays, sample for sample."""
    graph = powerlaw_graph(np.random.default_rng(1), n_nodes, 3000, 8)
    live = n_nodes * 4 // 5
    src, dst = graph["src"] % live, graph["dst"] % live  # the last fifth of the nodes has no edge
    g, jg = tgs.build_csr(src, dst, n_nodes), jgs.build_csr(src, dst, n_nodes)
    assert g.n_nodes == jg.n_nodes
    for a, b in ((g.indptr, jg.indptr), (g.indices, jg.indices)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    seeds = np.concatenate([np.arange(0, 40), np.arange(n_nodes - 10, n_nodes)]).astype(np.int32)
    got = tgs.sample_fanout(g, seeds, (5, 3), graph["feats"], np.random.default_rng(9))
    want = jgs.sample_fanout(jg, seeds, (5, 3), graph["feats"], np.random.default_rng(9))
    assert sorted(got) == sorted(want) and got["n_seeds"] == want["n_seeds"]
    for k in want:
        if k != "n_seeds":
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
    assert not got["edge_mask"].all()


@pytest.fixture(scope="module")
def graph():
    return powerlaw_graph(np.random.default_rng(0), 100, 400, 16)


def _params(cfg, seed=0):
    jparams = jgnn.gat_init(jax.random.PRNGKey(seed), cfg)
    return jparams, tgnn.gnn_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _jax_cfg():
    return jgnn.GATConfig(d_in=16, d_hidden=8, n_heads=4, n_classes=7)


def _cfg():
    return tgnn.GATConfig(d_in=16, d_hidden=8, n_heads=4, n_classes=7)


def _trainable(params):
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return tree_leaves(params)


@pytest.mark.parametrize("variant", ["full", "isolated", "masked"])
def test_gat_forward_loss_and_grads_match_jax(graph, variant):
    """Logits, loss and every parameter's gradient: the whole graph; with
    nodes 50..99 isolated as destinations; with edge and label masks
    (a node whose every edge is masked among them)."""
    jcfg, cfg = _jax_cfg(), _cfg()
    jparams, params = _params(jcfg)
    src, dst = graph["src"], graph["dst"]
    if variant == "isolated":
        src, dst = src % 50, dst % 50
    kw, jkw = {}, {}
    if variant == "masked":
        rng = np.random.default_rng(3)
        edge_mask = rng.random(len(src)) < 0.7
        edge_mask[dst == dst[0]] = False
        label_mask = (rng.random(100) < 0.5).astype(np.float32)
        kw = {"edge_mask": edge_mask, "label_mask": label_mask}
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    args = (graph["feats"], src, dst)
    jargs = tuple(jnp.asarray(a) for a in args)
    fwd = jax.jit(lambda p, *a, edge_mask: jgnn.gat_forward(p, jcfg, *a, edge_mask=edge_mask))
    want_logits = fwd(jparams, *jargs, edge_mask=jkw.get("edge_mask"))
    got_logits = tgnn.gat_forward(params, cfg, *args, edge_mask=kw.get("edge_mask"))
    assert got_logits.shape == (100, 7) and bool(torch.isfinite(got_logits).all())
    _close(got_logits.numpy(), want_logits)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, *a, **k: jgnn.gat_loss(p, jcfg, *a, **k)))(
        jparams, *jargs, jnp.asarray(graph["labels"]), **jkw)
    leaves = _trainable(params)
    loss = tgnn.gat_loss(params, cfg, *args, graph["labels"], **kw)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss.detach().numpy(), jloss)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        assert bool(torch.isfinite(g).all())
        _close(g.numpy(), w)


def test_gat_forward_batched_matches_jax_vmap():
    """The disjoint union of the B graphs against the reference's vmap:
    graph logits and their gradients."""
    bg = random_small_graphs(np.random.default_rng(2), 4, 30, 64, 16)
    jcfg, cfg = _jax_cfg(), _cfg()
    jparams, params = _params(jcfg, seed=1)
    jargs = tuple(jnp.asarray(bg[k]) for k in ("feats", "src", "dst"))

    def jloss(p):
        return jnp.sum(jnp.sin(jgnn.gat_forward_batched(p, jcfg, *jargs)))

    want = jax.jit(lambda p: jgnn.gat_forward_batched(p, jcfg, *jargs))(jparams)
    got = tgnn.gat_forward_batched(params, cfg, bg["feats"], bg["src"], bg["dst"])
    assert got.shape == (4, 7)
    _close(got.numpy(), want)
    leaves = _trainable(params)
    grads = torch.autograd.grad(torch.sum(torch.sin(tgnn.gat_forward_batched(
        params, cfg, bg["feats"], bg["src"], bg["dst"]))), leaves)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jax.jit(jax.grad(jloss))(jparams))):
        _close(g.numpy(), w)


def _jax_step(jcfg, jparams, batch):
    """The reference's ``build_gnn_train`` step body (``steps.py:503-549``)."""
    opt = jopt.adamw(lr=1e-3)
    if "y" in batch:
        def loss_fn(p):
            logits = jgnn.gat_forward_batched(p, jcfg, batch["feats"], batch["src"], batch["dst"])
            return jnp.mean(jnp.square(logits.sum(-1) - batch["y"]))
    else:
        def loss_fn(p):
            return jgnn.gat_loss(p, jcfg, batch["feats"], batch["src"], batch["dst"], batch["labels"],
                                 label_mask=batch["label_mask"], edge_mask=batch["edge_mask"])
    loss, grads = jax.value_and_grad(loss_fn)(jparams)
    updates, state = opt.update(grads, opt.init(jparams), jparams)
    return jopt.apply_updates(jparams, updates), state, loss


def _sampled_batch():
    """A ``minibatch_lg``-style block from the sampler: 16 seeds, fanout 4-3."""
    graph = powerlaw_graph(np.random.default_rng(8), 400, 2500, 16)
    csr = tgs.build_csr(graph["src"], graph["dst"], 400)
    blk = tgs.sample_fanout(csr, np.arange(16, dtype=np.int32), (4, 3), graph["feats"], np.random.default_rng(2))
    n = len(blk["node_ids"])
    label_mask = np.zeros(n, np.float32)
    label_mask[: blk["n_seeds"]] = 1.0
    return {"feats": blk["feats"], "src": blk["src"], "dst": blk["dst"],
            "labels": graph["labels"][blk["node_ids"]], "label_mask": label_mask, "edge_mask": blk["edge_mask"]}


@pytest.mark.parametrize("shape", ["full_graph", "minibatch", "molecule"])
def test_gnn_train_step_matches_jax(graph, shape):
    """One ``gnn_train_step`` (loss, adamw(lr=1e-3)) against the
    reference's step body: the loss, the updated parameters and state."""
    jcfg, cfg = _jax_cfg(), _cfg()
    jparams, params = _params(jcfg, seed=2)
    if shape == "full_graph":
        batch = {"feats": graph["feats"], "src": graph["src"], "dst": graph["dst"], "labels": graph["labels"],
                 "label_mask": np.ones(100, np.float32), "edge_mask": np.ones(400, bool)}
    elif shape == "minibatch":
        batch = _sampled_batch()
    else:
        batch = random_small_graphs(np.random.default_rng(4), 8, 30, 64, 16)
    want_p, want_s, want_loss = jax.jit(lambda p, b: _jax_step(jcfg, p, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    opt = gnn_optimizer()
    state = opt.init(params)
    got_p, got_s, metrics = gnn_train_step(cfg, params, state, batch)
    assert got_p is params
    _close(metrics["loss"].numpy(), want_loss)
    for g, w in zip(tree_leaves((got_p, got_s)), jax.tree_util.tree_leaves((want_p, want_s))):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=TOL_STEP,
                                   atol=TOL_STEP * max(1.0, float(np.abs(np.asarray(w)).max())))


def test_gnn_entry_points_need_a_card_or_cpu():
    """``gat_init`` and ``gnn_from_jax`` run on cuda unless the caller
    passes ``device="cpu"``: without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.gat_init(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.gnn_from_jax({"layers": [{"w": np.zeros((2, 2), np.float32)}]})
    params = tgnn.gat_init(0, cfg, device="cpu")
    assert params["layers"][0]["w"].shape == (16, 32) and params["layers"][1]["w"].shape == (32, 7)


@pytest.mark.gpu
def test_gpu_gnn_train_step_matches_cpu(graph):
    """One train step of each shape kind on the card against the same
    step on a CPU copy (TF32 off: fp32 products)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = _cfg()
    for batch in ({"feats": graph["feats"], "src": graph["src"], "dst": graph["dst"], "labels": graph["labels"],
                   "label_mask": np.ones(100, np.float32), "edge_mask": np.ones(400, bool)},
                  _sampled_batch(), random_small_graphs(np.random.default_rng(4), 8, 30, 64, 16)):
        cpu = tgnn.gat_init(0, cfg, device="cpu")
        card = tgnn.gnn_from_jax(jax.tree_util.tree_map(lambda t: t.numpy(), cpu), device="cuda")
        _, _, m_cpu = gnn_train_step(cfg, cpu, gnn_optimizer().init(cpu), batch)
        _, _, m_card = gnn_train_step(cfg, card, gnn_optimizer().init(card), batch)
        _close(m_card["loss"].cpu().numpy(), m_cpu["loss"].numpy())
        for a, b in zip(tree_leaves(card), tree_leaves(cpu)):
            _close(a.detach().cpu().numpy(), b.detach().numpy())
