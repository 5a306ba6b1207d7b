"""Sharded LM steps (``repro_torch.launch.steps`` with ``mesh=``) over gloo
ranks on the CPU, held to the JAX package's own step cells.

The oracle is the reference's ``build_lm_train``, ``build_lm_prefill``
and ``build_lm_decode`` step functions, built on a (1, 1) ``("data",
"model")`` mesh of this process's one CPU device for the reduced configs
(the arch's ``make_config`` replaced by ``make_reduced_config``) and
jitted; the reference never runs a step on more devices (its forced
multi-device tests are ROADMAP C4).  The weights are its own
``transformer_init`` draws, carried across by ``transformer_from_jax``;
tokens come from a numpy seed.

Each mesh, (1, 2), (1, 4), (2, 1) and (2, 2), is one spawn of CPU ranks
(``repro_torch.testing.ranks``; the four are spawned at once, while the
oracles are built) that runs every case: for each config a
train step (``lm_loss_and_grads``, then ``lm_train_step``), a prefill
and ``DECODE`` decode steps (the batch's own tokens fed one by one into
a ``MAX_LEN``-slot cache).  At model-only meshes, and for
the dense configs at every mesh, the sharded results equal the
reference's cells.  At dp > 1 a MoE config's train and prefill cells
have ``groups = dp`` (``_moe_group_config``), which changes the
arithmetic (capacity is per group): they are held to the port's
single-device step at that ``groups`` (``tests/test_torch_moe.py`` holds
``moe_apply`` at any ``groups`` to the reference's); the reference's
decode cell takes no groups, so decode is held to it everywhere.

Both MoE regimes run: expert parallel with grok-1 (4 experts) and
deepseek-v2 (8) at model 2 and 4, tensor parallel with grok-1's experts
replaced by 3 at (1, 2) (the reduced config's 4 divide every model axis
here, so the regime would not otherwise run).  A microbatched train step
(``n_microbatches=2``) runs at (2, 2): equal microbatches average to the
full batch's loss, so it is held to the same cell.  MoE routes are
recorded on every rank (``_Routes``) and compared with the port's
single-device prefill's: flipped positions are counted, reported and
left out of the prefill logits' comparison, with at least 90% kept
(none flip at these seeds in fp32; a flip would move the train step's
loss and gradients past their tolerances, which are not masked).

Tolerances, fp32: loss rtol 1e-5; grad norm rtol 1e-4; each leaf's
gradient relative L2 <= 1e-4 (``TOL_GRAD``); the updated parameters by
``tests/test_torch_train_lm.py``'s rule (1e-6 of the scale, but within
2 lr where AdamW's first step maps g to lr g / (|g| + 1e-8) with |g| <
1e-6), with g the gradient AdamW sees: clipped by the global norm
(these steps' norms are above 1, so an unclipped 1e-6 is a clipped 1e-7,
where rounding moves the update by up to its size); prefill and decode
logits and the caches rtol = atol = 1e-4.

This module imports no JAX at import time: its rank bodies run in
spawned children that import it.
"""

import contextlib
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from repro_torch.testing.ranks import run_ranks

CONFIGS = ("llama3-8b", "gemma3-27b", "grok-1-314b", "deepseek-v2-236b")
TP_CASE = "grok-1-314b:tp"  # grok-1 with 3 experts: the tensor-parallel regime at model 2
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x1": (2, 1), "2x2": (2, 2)}
B, S, MAX_LEN, DECODE = 4, 16, 8, 4
TOL, TOL_GRAD, TOL_STEP, LR = 1e-4, 1e-4, 1e-6, 3e-4


def _cfg(case):
    """The port's reduced config of a case (``name`` or ``name:tp``)."""
    from repro_torch.configs import get_arch

    name, _, variant = case.partition(":")
    cfg = get_arch(name).make_reduced_config()
    if variant == "tp":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=3))
    return cfg


def _cases(shape):
    return CONFIGS + ((TP_CASE,) if shape == (1, 2) else ())


def _batch(vocab):
    rng = np.random.default_rng(5)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")}


class _Routes:
    """Every ``moe.route`` call's experts (G, Tg, k), sorted within k."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._moe, self._route = [], moe, moe.route

        def wrapped(router, cfg, xg):
            out = self._route(router, cfg, xg)
            self.calls.append(out[2].sort(dim=-1).values.numpy())
            return out

        moe.route = wrapped
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


# ---------------------------------------------------------------------------
# the rank body: every case's sharded steps, once a mesh
# ---------------------------------------------------------------------------


def _full(x):
    return x.full_tensor().detach().numpy() if hasattr(x, "full_tensor") else x.detach().numpy()


def _rank_body(rank, world, shape, payload, staged):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import obs
    from repro_torch.distributed.sharding import mesh_coordinate, stage_gloo_collectives
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tt
    from repro_torch.obs import metrics
    from repro_torch.train.optimizer import param_tree

    torch.manual_seed(0)
    obs.enable(trace=False, metrics_on=True)
    if staged:  # DTensor's all-gathers through the staging function, as the card's gloo ranks run them
        stage_gloo_collectives("cpu")
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    out = {"coord": (mesh_coordinate(mesh, "data"), mesh_coordinate(mesh, "model")), "shape": shape}
    for case in _cases(shape):
        cfg, p = _cfg(case), payload[case]
        res, t0 = {}, time.perf_counter()

        def model():
            m = tt.transformer_from_jax(p["weights"], cfg, device="cpu")
            m.requires_grad_(True)
            return steps.shard_lm_params(m, cfg, mesh)

        m = model()
        if cfg.moe is not None:
            wo = m.layers[-1]["moe"]["wo"]
            res["moe_wo"] = [str(q) for q in wo.placements]
        comm = CommDebugMode()
        with comm if cfg.moe is not None else contextlib.nullcontext():  # the MoE steps' collectives
            loss, grads = steps.lm_loss_and_grads(m, cfg, payload["batch"][case], mesh=mesh)
        res["comms"] = {str(k).split(".")[-1]: int(v) for k, v in comm.get_comm_counts().items()}
        res["loss_g"] = float(loss)
        res["grads"] = [_full(g) for g in grads]
        params = param_tree(m)
        opt = steps.lm_optimizer(cfg)
        state = opt.init(params)
        params, state, met = steps.lm_train_step(m, cfg, params, state, payload["batch"][case], mesh=mesh)
        res["loss"], res["grad_norm"] = float(met["loss"]), float(met["grad_norm"])
        res["params"] = {n: _full(v) for n, v in params.items()}
        if case == "llama3-8b" and shape == (2, 2):  # the microbatched step
            m2 = model()
            loss2, grads2 = steps.lm_loss_and_grads(m2, cfg, payload["batch"][case], mesh=mesh, n_microbatches=2)
            res["mb_loss"], res["mb_grads"] = float(loss2), [_full(g) for g in grads2]
            res["prefill_chunked"] = _full(steps.lm_prefill_step(model(), cfg, payload["batch"][case]["tokens"],
                                                                 mesh=mesh, n_chunks=2))
            layer = m2.layers[0]
            with CommDebugMode() as c:  # already laid out: no collective
                steps._lm_shard_layer_params(mesh)(layer)
            res["noop_comms"] = c.get_total_counts()
            with torch.no_grad():  # rows over "model" where the rule puts columns: an all-to-all away
                from torch.distributed.tensor import Replicate, Shard

                wq = layer["attn"]["wq"].redistribute(mesh, (Replicate(), Shard(0)))
                layer["attn"]["wq"] = torch.nn.Parameter(wq)
            with CommDebugMode() as c:
                steps._lm_shard_layer_params(mesh)(layer)
            res["moved_comms"] = c.get_total_counts()

        m = model()
        with _Routes() as routes:
            res["prefill"] = _full(steps.lm_prefill_step(m, cfg, payload["batch"][case]["tokens"], mesh=mesh))
        res["routes"] = routes.calls
        cache = steps.shard_lm_cache(tt.make_cache(cfg, B, MAX_LEN, device="cpu"), cfg, mesh)
        res["cache_pl"] = {k: [str(q) for q in v.placements] for k, v in cache.items()}
        logits = []
        for t in range(DECODE):
            lg, cache = steps.lm_decode_step(m, cfg, payload["batch"][case]["tokens"][:, t : t + 1], cache, t,
                                             mesh=mesh)
            logits.append(_full(lg))
        res["decode"] = np.stack(logits)
        res["cache"] = {k: _full(v) for k, v in cache.items()}
        res["seconds"] = time.perf_counter() - t0
        out[case] = res if rank == 0 else {"routes": res["routes"], "seconds": res["seconds"]}
    out["staged_calls"] = metrics.snapshot().get("sharded.staged.all_gather.calls", 0)
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# the oracles: the reference's cells at (1, 1), the port's single device at dp groups
# ---------------------------------------------------------------------------


def _ref_cells(case, weights, batch):
    """The reference's train, prefill and decode cells at (1, 1), jitted."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_arch as jax_get_arch
    from repro.configs.registry import ShapeSpec
    from repro.launch import steps as jsteps
    from repro.models import transformer as jt
    from repro.train import optimizer as jopt

    name, _, variant = case.partition(":")
    arch = jax_get_arch(name)
    jcfg = arch.make_reduced_config()
    if variant == "tp":
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, n_experts=3))
    arch = dataclasses.replace(arch, make_config=lambda: jcfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    params = jax.tree_util.tree_map(jnp.asarray, weights)
    train = jsteps.build_lm_train(arch, ShapeSpec("t", "train", {"seq_len": S, "global_batch": B}), mesh)
    new_p, _, met = jax.jit(train.step_fn)(params, jopt.adamw(lr=LR).init(params), batch)
    grads = jax.jit(jax.grad(lambda q: jt.transformer_loss(q, jcfg, batch["tokens"], batch["labels"],
                                                           ce_chunk=512)))(params)
    prefill = jsteps.build_lm_prefill(arch, ShapeSpec("p", "prefill", {"seq_len": S, "global_batch": B}), mesh)
    logits = jax.jit(prefill.step_fn)(params, batch["tokens"])
    decode = jsteps.build_lm_decode(arch, ShapeSpec("d", "decode", {"seq_len": MAX_LEN, "global_batch": B}), mesh)
    step = jax.jit(decode.step_fn)
    cache = jt.make_cache(jcfg, B, MAX_LEN)
    dec = []
    for t in range(DECODE):
        lg, cache = step(params, batch["tokens"][:, t : t + 1], cache, jnp.int32(t))
        dec.append(np.asarray(lg))
    np_ = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return {"params": np_(new_p), "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "grads": np_(grads), "prefill": np.asarray(logits), "decode": np.stack(dec), "cache": np_(cache)}


def _port_single(case, weights, batch, groups):
    """The port's single-device train step and prefill at ``groups``
    (the dp > 1 oracle of a MoE config), with its prefill's routes."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tt
    from repro_torch.train.optimizer import param_tree

    cfg = _cfg(case)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, groups=groups))
    model = tt.transformer_from_jax(weights, cfg, device="cpu")
    model.requires_grad_(True)
    loss, grads = steps.lm_loss_and_grads(model, cfg, batch)
    names = [n for n, _ in sorted(param_tree(model).items())]
    params = param_tree(model)
    opt = steps.lm_optimizer(cfg)
    params, _, met = steps.lm_train_step(model, cfg, params, opt.init(params), batch)
    model = tt.transformer_from_jax(weights, cfg, device="cpu")
    with _Routes() as routes:
        logits = steps.lm_prefill_step(model, cfg, batch["tokens"])
    return {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "grads": dict(zip(names, (g.numpy() for g in grads))),
            "params": {n: v.detach().numpy() for n, v in params.items()}, "prefill": logits.numpy(),
            "routes": routes.calls}


def _ref_leaf(tree, name):
    """The reference's leaf for a port parameter name (``layers.i.*`` is
    row i of the stacked leaf)."""
    parts = name.split(".")
    if parts[0] == "layers":
        x = tree["layers"]
        for q in parts[2:]:
            x = x[q]
        return np.asarray(x)[int(parts[1])]
    x = tree["prefix_layers"][int(parts[1])] if parts[0] == "prefix_layers" else tree
    for q in parts[2:] if parts[0] == "prefix_layers" else parts:
        x = x[q]
    return np.asarray(x)


@pytest.fixture(scope="module")
def oracle():
    """The cases' weights and batches, every mesh's ranks (spawned at once,
    each in a thread, while this process builds the oracles), the
    reference's cells and the port's single-device steps."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_arch as jax_get_arch
    from repro.models import transformer as jt

    cases = CONFIGS + (TP_CASE,)
    weights, batch = {}, {}
    for case in cases:
        name, _, variant = case.partition(":")
        jcfg = jax_get_arch(name).make_reduced_config()
        if variant == "tp":
            jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, n_experts=3))
        init = jax.jit(lambda key, c=jcfg: jt.transformer_init(key, c))
        weights[case] = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
        batch[case] = _batch(jcfg.vocab)
    payload = {c: {"weights": weights[c]} for c in cases}
    payload["batch"] = batch
    with ThreadPoolExecutor(len(MESHES)) as pool:
        spawned = {name: pool.submit(run_ranks, _rank_body, shape[0] * shape[1], shape, payload, name == "2x2",
                                     timeout=600, threads=1) for name, shape in MESHES.items()}
        ref = {c: _ref_cells(c, weights[c], batch[c]) for c in cases}
        single = {c: {g: _port_single(c, weights[c], batch[c], g) for g in ((1, 2) if _cfg(c).moe else (1,))}
                  for c in cases}
        ranks = {name: f.result() for name, f in spawned.items()}
    return SimpleNamespace(ref=ref, single=single, ranks=ranks)


@pytest.fixture
def ranks(oracle, request):
    """Every rank's results at one mesh (the (2, 2) ranks ran DTensor's
    all-gathers through the staging function)."""
    return oracle.ranks[request.param]


def _on(meshes=tuple(MESHES)):
    return pytest.mark.parametrize("ranks", list(meshes), indirect=True)


def _want(oracle, ranks, case):
    """The oracle of ``case`` at this mesh: the reference's cells, or the
    port's single device at groups = dp for a MoE train step or prefill
    at dp > 1; and the routes to count flips against."""
    dp = max(o["coord"][0] for o in ranks) + 1
    moe = _cfg(case).moe is not None
    single = oracle.single[case][dp if moe else 1]
    return (single if moe and dp > 1 else None), oracle.ref[case], single["routes"]


def _flips(ranks, case, routes_want):
    """(positions whose experts differ from the oracle's, positions):
    each rank's routes (its groups, G over the data axis) concatenated in
    data order at model coordinate 0."""
    by_dp = sorted((o for o in ranks if o["coord"][1] == 0), key=lambda o: o["coord"][0])
    flips = total = 0
    for i, want in enumerate(routes_want):
        got = np.concatenate([o[case]["routes"][i] for o in by_dp], axis=0).reshape(want.shape)
        bad = (got != want).any(-1)
        flips, total = flips + int(bad.sum()), total + bad.size
    return flips, total


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@_on()
@pytest.mark.parametrize("case", CONFIGS)
def test_sharded_train_step_matches_the_reference(ranks, oracle, case):
    """Loss, grad norm, every leaf's gradient and every updated parameter
    of the sharded train step."""
    r = ranks[0][case]
    single, ref, _ = _want(oracle, ranks, case)
    np.testing.assert_allclose(r["loss_g"], r["loss"], rtol=1e-6)
    names = sorted(r["params"])
    if single is None:
        want_loss, want_norm = ref["loss"], ref["grad_norm"]
        want_g = {n: _ref_leaf(ref["grads"], n) for n in names}
        want_p = {n: _ref_leaf(ref["params"], n) for n in names}
    else:
        want_loss, want_norm, want_g, want_p = single["loss"], single["grad_norm"], single["grads"], single["params"]
    np.testing.assert_allclose(r["loss"], want_loss, rtol=1e-5)
    np.testing.assert_allclose(r["grad_norm"], want_norm, rtol=1e-4)
    for n, g in zip(names, r["grads"]):
        rel = np.linalg.norm(g - want_g[n]) / max(np.linalg.norm(want_g[n]), 1e-30)
        assert rel <= TOL_GRAD, (n, rel)
    clip = min(1.0, 1.0 / want_norm)  # AdamW sees the gradient clipped by the global norm
    for n in names:
        w = want_p[n]
        atol = np.where(np.abs(want_g[n]) * clip >= 1e-6, TOL_STEP * max(1.0, float(np.abs(w).max())), 2 * LR)
        assert (np.abs(r["params"][n] - w) <= atol).all(), (n, float(np.abs(r["params"][n] - w).max()))


@_on()
@pytest.mark.parametrize("case", CONFIGS)
def test_sharded_prefill_and_decode_match_the_reference(ranks, oracle, case):
    """Prefill logits (rows whose MoE routes flipped left out, at least
    90% kept), every decode step's logits and the caches after them."""
    r = ranks[0][case]
    single, ref, routes = _want(oracle, ranks, case)
    flips, total = _flips(ranks, case, routes)
    assert 10 * (total - flips) >= 9 * total, (flips, total)
    want = (single or ref)["prefill"]
    keep = np.ones(B, bool)
    if flips:
        print(f"{case}: {flips} of {total} routed positions flipped; their rows are left out")
        keep = ~np.any([_flip_rows(ranks, case, routes, i) for i in range(len(routes))], axis=0)
    _close(r["prefill"][keep], want[keep])
    _close(r["decode"], ref["decode"])
    assert set(r["cache"]) == set(ref["cache"])
    for k, v in r["cache"].items():
        _close(v, ref["cache"][k])


def _flip_rows(ranks, case, routes_want, i):
    by_dp = sorted((o for o in ranks if o["coord"][1] == 0), key=lambda o: o["coord"][0])
    got = np.concatenate([o[case]["routes"][i] for o in by_dp], axis=0).reshape(routes_want[i].shape)
    return (got != routes_want[i]).any(-1).reshape(B, -1).any(-1)


@_on(("1x2",))
def test_tensor_parallel_moe_regime_matches_the_reference(ranks, oracle):
    """grok-1 with 3 experts at model 2: the experts' f over ``"model"``
    (wo row-parallel), the reference's cells held as above."""
    r = ranks[0][TP_CASE]
    assert r["moe_wo"] == [str(Shard(2)), str(Shard(1))]  # wo (E, f, d): d over "data", f over "model"
    ref = oracle.ref[TP_CASE]
    np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(r["grad_norm"], ref["grad_norm"], rtol=1e-4)
    for n, g in zip(sorted(r["params"]), r["grads"]):
        w = _ref_leaf(ref["grads"], n)
        assert np.linalg.norm(g - w) <= TOL_GRAD * max(np.linalg.norm(w), 1e-30), n
    _close(r["prefill"], ref["prefill"])
    _close(r["decode"], ref["decode"])


@_on(("1x2", "1x4", "2x2"))
@pytest.mark.parametrize("case", ["grok-1-314b", "deepseek-v2-236b"])
def test_expert_parallel_regime_ran(ranks, case):
    """Experts over ``"model"`` at model 2 and 4, and the step's
    collectives include the exchange's all-to-all and the reductions."""
    r = ranks[0][case]
    assert r["moe_wo"][1] == str(Shard(0))  # wo (E, f, d): the experts over "model"
    assert r["comms"].get("all_reduce", 0) + r["comms"].get("reduce_scatter_tensor", 0) > 0


@_on(("2x2",))
def test_microbatched_step_and_layer_params_noop(ranks, oracle):
    """``n_microbatches=2`` at (2, 2): the microbatches stay on their data
    shards and average to the reference cell's loss and gradients; the
    prefill in two chunks of rows (the path above 1e11 parameters) gives
    the cell's logits.
    ``_lm_shard_layer_params`` on a layer already laid out issues no
    collective, and one on a leaf laid out otherwise."""
    r, ref = ranks[0]["llama3-8b"], oracle.ref["llama3-8b"]
    np.testing.assert_allclose(r["mb_loss"], ref["loss"], rtol=1e-5)
    for n, g in zip(sorted(r["params"]), r["mb_grads"]):
        w = _ref_leaf(ref["grads"], n)
        assert np.linalg.norm(g - w) <= TOL_GRAD * max(np.linalg.norm(w), 1e-30), n
    assert r["noop_comms"] == 0 and r["moved_comms"] > 0
    _close(r["prefill_chunked"], ref["prefill"])


@_on()
def test_cache_layouts_and_staging(ranks):
    """The caches as ``_cache_shardings`` lays them out: the batch over
    ``"data"``; GQA heads over ``"model"`` where the kv heads divide,
    else the sequence (llama's single kv head); MLA's latent the
    sequence.  At (2, 2) DTensor's all-gathers ran through
    ``staged_collective``, on every rank; elsewhere it was not called."""
    r = ranks[0]
    model = r["shape"][1]
    for case in CONFIGS:
        cfg = _cfg(case)
        dim = 2 if cfg.attention == "mla" or cfg.kv_heads % model == 0 else 3
        for pl in r[case]["cache_pl"].values():
            assert pl == [str(Shard(1)), str(Shard(dim))], (case, pl)
    staged = [o["staged_calls"] for o in ranks]
    assert all(n > 0 for n in staged) if r["shape"] == (2, 2) else all(n == 0 for n in staged)
