"""Port parity for LM training (``transformer_loss`` with gradients,
``launch.steps.lm_train_step``, ``examples/train_lm_torch.py``) against
the JAX package.

The weights are the reference's own ``transformer_init`` draws carried
across by ``transformer_from_jax``; tokens come from numpy seeds.
Tolerances (fp32): the loss rtol = 1e-5; each parameter's gradient
relative L2 <= 1e-4 (products summed in other orders through 2 layers,
the attention backward's recomputed probabilities); the parameters
after a train step 1e-6 of their scale (one AdamW step of ~3e-4), but
where the gradient is below 1e-6: AdamW's first step maps g to
lr g / (|g| + 1e-8), so there the rounding of g moves the update by up
to its size, and those elements are held within 2 lr.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_arch as jax_get_arch
from repro.data.pipeline import lm_batches as jax_lm_batches
from repro.models import transformer as jt
from repro.train import optimizer as jopt

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import lm_batches
from repro_torch.launch import steps
from repro_torch.models import transformer as tt
from repro_torch.train import optimizer as topt
from repro_torch.train.optimizer import param_tree

ROOT = Path(__file__).resolve().parents[1]
TOL_GRAD = 1e-4
TOL_STEP = 1e-6
FAMILIES = ["llama3-8b", "gemma3-27b", "grok-1-314b", "deepseek-v2-236b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_leaf(tree, name):
    """The reference's leaf for a port parameter name: ``layers.i.*`` is
    row i of the stacked ``layers`` leaf, ``prefix_layers.i.*`` the
    i-th prefix layer's."""
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


def _models(name, remat=True):
    jcfg = dataclasses.replace(jax_get_arch(name).make_reduced_config(), remat=remat)
    cfg = dataclasses.replace(get_arch(name).make_reduced_config(), remat=remat)
    jparams = jt.transformer_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, tt.transformer_from_jax(_np(jparams), cfg, device="cpu")


def _tokens(cfg, b=2, s=16, seed=1):
    batch = lm_batches(seed, b, s, cfg.vocab)(0)
    return batch["tokens"], batch["labels"]


@pytest.mark.parametrize("remat,ce_chunk", [(True, 8), (False, None)], ids=["remat-chunked", "plain"])
@pytest.mark.parametrize("name", FAMILIES)
def test_transformer_loss_gradients_match_jax(name, remat, ce_chunk):
    """``transformer_loss`` and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's: GQA (llama), windowed
    (gemma3), MoE (grok-1), MLA (deepseek-v2), with remat and the
    chunked loss on and off."""
    jcfg, cfg, jparams, model = _models(name, remat)
    tokens, labels = _tokens(cfg)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jt.transformer_loss(p, jcfg, tokens, labels, ce_chunk=ce_chunk)))(jparams)
    model.requires_grad_(True)
    loss = tt.transformer_loss(model, cfg, tokens, labels, ce_chunk=ce_chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    n = 0
    for pname, p in model.named_parameters():
        w = _ref_leaf(want, pname)
        assert p.grad is not None and p.grad.shape == w.shape, pname
        rel = np.linalg.norm(p.grad.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= TOL_GRAD, (pname, rel)
        n += 1
    assert n == len(list(model.parameters()))


def test_serving_entry_points_build_no_graph():
    """The serving functions run the same body under inference mode:
    no graph even with trainable parameters."""
    _, cfg, _, model = _models("llama3-8b")
    model.requires_grad_(True)
    tokens, _ = _tokens(cfg)
    for out in (tt.transformer_forward(model, cfg, tokens), tt.transformer_prefill(model, cfg, tokens)):
        assert out.grad_fn is None and out.is_inference()


def _jax_step(jcfg, jparams, batch, ce_chunk):
    """The reference's ``build_lm_train`` step body at one microbatch
    (``steps.py:259-305``)."""
    loss, grads = jax.value_and_grad(
        lambda p: jt.transformer_loss(p, jcfg, batch["tokens"], batch["labels"], ce_chunk=ce_chunk))(jparams)
    grads, gnorm = jopt.clip_by_global_norm(grads, 1.0)
    opt = jopt.adamw(lr=3e-4)
    updates, state = opt.update(grads, opt.init(jparams), jparams)
    return jopt.apply_updates(jparams, updates), state, loss, gnorm


def _check_params(got, want, grads, lr=3e-4):
    """Parameters after one AdamW step: ``got`` and ``want`` map names to
    arrays, ``grads`` to the step's gradients (``TOL_STEP`` of the scale
    where |g| >= 1e-6, else 2 lr)."""
    for pname in got:
        w = want[pname]
        atol = np.where(np.abs(grads[pname]) >= 1e-6, TOL_STEP * max(1.0, float(np.abs(w).max())), 2 * lr)
        assert (np.abs(got[pname] - w) <= atol).all(), (pname, float(np.abs(got[pname] - w).max()))


def _port_grads(model, cfg, batch, ce_chunk):
    model.requires_grad_(True)
    tt.transformer_loss(model, cfg, batch["tokens"], batch["labels"], ce_chunk=ce_chunk or None).backward()
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def test_lm_train_step_matches_the_reference_step():
    """One ``lm_train_step`` (clip 1.0, adamw(lr=3e-4)) against the
    reference's step body: the loss, the gradient norm, the updated
    parameters and the optimizer step."""
    jcfg, cfg, jparams, model = _models("llama3-8b")
    batch = lm_batches(3, 4, 16, cfg.vocab)(0)
    assert all(batch[k].tobytes() == jax_lm_batches(3, 4, 16, cfg.vocab)(0)[k].tobytes() for k in batch)
    want_p, want_s, want_loss, want_norm = jax.jit(lambda p: _jax_step(jcfg, p, batch, 8))(jparams)
    grads = _port_grads(tt.transformer_from_jax(_np(jparams), cfg, device="cpu"), cfg, batch, 8)
    params = param_tree(model)
    opt = steps.lm_optimizer(cfg)
    state = opt.init(params)
    params, state, metrics = steps.lm_train_step(model, cfg, params, state, batch, ce_chunk=8)
    np.testing.assert_allclose(metrics["loss"].item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(want_norm), rtol=1e-4)
    assert int(state["step"]) == int(want_s["step"]) == 1
    _check_params({n: p.detach().numpy() for n, p in model.named_parameters()},
                  {n: _ref_leaf(want_p, n) for n in grads}, grads)


def _bits(tree):
    return [t.detach().reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32).clone()
            for t in topt.tree_leaves(tree)]


@pytest.mark.parametrize("dtype,state_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                               (torch.bfloat16, torch.bfloat16)], ids=["fp32", "bf16", "bf16-state"])
@pytest.mark.parametrize("name", FAMILIES)
def test_lm_train_step_applies_each_leaf_as_the_old_step(name, dtype, state_dtype):
    """``lm_train_step`` adds each leaf's AdamW update as soon as it is
    computed (the optimizer's ``apply``): two steps give the parameters
    and the optimizer state of the old path (the whole tree of fp32
    updates from ``update``, then ``apply_updates``) bit for bit, in fp32
    and bf16, with fp32 and bf16 state, for every family."""
    cfg = dataclasses.replace(get_arch(name).make_reduced_config(), dtype=dtype)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dtype=dtype))
    batch = lm_batches(6, 2, 16, cfg.vocab)(0)
    opt = topt.adamw(lr=3e-4, state_dtype=state_dtype)
    assert opt.apply is not None
    outs = []
    for o in (opt, topt.Optimizer(opt.init, opt.update)):
        model = tt.transformer_init(0, cfg, device="cpu")
        params = param_tree(model)
        state = o.init(params)
        for _ in range(2):
            params, state, _ = steps.lm_train_step(model, cfg, params, state, batch, ce_chunk=8, opt=o)
        outs.append(_bits((params, state["m"], state["v"])))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16], ids=["fp32-state", "bf16-state"])
def test_row_block_chunking_equals_the_unchunked_update(monkeypatch, state_dtype):
    """``row_blocks`` cuts a leaf larger than the threshold into blocks of
    rows (an expert stack's 3-d leaf as rows of its last axis, at least one
    row a block): AdamW's ``apply`` and ``adamw_update_params`` over the
    blocks equal the same over whole leaves bit for bit, and ``apply``
    equals ``update`` + ``apply_updates``."""
    rng = np.random.default_rng(9)
    shapes = {"stack": (3, 5, 7), "embed": (11, 6), "bias": (6,), "scale": ()}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    blocks = topt.row_blocks(torch.zeros(3, 5, 7), threshold_bytes=4 * 7 * 2)
    assert [tuple(b.shape) for b in blocks] == [(2, 7)] * 7 + [(1, 7)]
    assert len(topt.row_blocks(torch.zeros(3, 5, 7), threshold_bytes=1)) == 15

    def run(chunk, fn):
        monkeypatch.setattr(topt, "CHUNK_BYTES", chunk)
        tree = {k: torch.from_numpy(v.copy()).to(torch.bfloat16) for k, v in params.items()}
        opt = topt.adamw(lr=1e-2, state_dtype=state_dtype)
        state = opt.init(tree)
        for g in grads:
            gt = {k: torch.from_numpy(v) for k, v in g.items()}
            state = fn(opt, gt, state, tree, chunk)
        return _bits((tree, state["m"], state["v"]))

    def apply(opt, g, state, tree, chunk):
        return opt.apply(g, state, tree)

    def old(opt, g, state, tree, chunk):
        u, state = opt.update(g, state, tree)
        topt.apply_updates(tree, u)
        return state

    def fused(opt, g, state, tree, chunk):
        return topt.adamw_update_params(tree, g, state, lr=1e-2, chunk_threshold_bytes=chunk)[1]

    whole = run(2 ** 30, apply)
    for got in (run(8, apply), run(56, apply), run(2 ** 30, old)):
        assert all(torch.equal(a, b) for a, b in zip(got, whole))
    fused_whole = run(2 ** 30, fused)
    assert all(torch.equal(a, b) for a, b in zip(run(8, fused), fused_whole))


def test_lm_train_step_two_microbatches_equal_one():
    """Two microbatches accumulated in fp32 give the one-microbatch
    step: the loss (a mean of equal halves), the gradient norm and the
    updated parameters."""
    _, cfg, jparams, model = _models("gemma3-27b")
    model2 = tt.transformer_from_jax(_np(jparams), cfg, device="cpu")
    batch = lm_batches(4, 4, 16, cfg.vocab)(2)
    grads = _port_grads(tt.transformer_from_jax(_np(jparams), cfg, device="cpu"), cfg, batch, 0)
    assert steps.lm_microbatches(cfg, 4) == 1
    outs = []
    for m, n_mb in ((model, 1), (model2, 2)):
        params = param_tree(m)
        state = steps.lm_optimizer(cfg).init(params)
        outs.append(steps.lm_train_step(m, cfg, params, state, batch, n_microbatches=n_mb, ce_chunk=0)[2])
    np.testing.assert_allclose(outs[1]["loss"].item(), outs[0]["loss"].item(), rtol=1e-5)
    np.testing.assert_allclose(outs[1]["grad_norm"].item(), outs[0]["grad_norm"].item(), rtol=1e-4)
    _check_params({n: p.detach().numpy() for n, p in model2.named_parameters()},
                  {n: p.detach().numpy() for n, p in model.named_parameters()}, grads)


def test_lm_microbatch_rule_matches_the_reference():
    """``lm_microbatches`` is the reference's ``_lm_microbatches`` on one
    data shard: 16 above 1e11 parameters, 2 above 3e10, halved until it
    divides the batch; the optimizer state is bf16 above 1e11."""
    expect = {"llama3-8b": 1, "gemma3-27b": 1, "grok-1-314b": 16, "deepseek-v2-236b": 16, "granite-20b": 1}
    for name, n_mb in expect.items():
        cfg = get_arch(name).make_config()
        assert steps.lm_microbatches(cfg, 256) == n_mb, name
        assert steps.lm_microbatches(cfg, 8) == min(n_mb, 8)
        assert steps.lm_ce_chunk(cfg) == (256 if n_mb == 16 else 512)


# The first step's gradient at 1 and 8 microbatches in bf16: llama3-8b's
# reduced width, its vocab and token count (128,256 and 8 x 4,096 on the
# card) both cut by 16, the same zipf draw (lm_batches seed 0).  bf16
# gradients of the two packages per leaf within relative L2 GRAD_BF16 (bf16
# rounds at other places in the two frameworks; 5.1e-3 seen).
C6_VOCAB, C6_BATCH, C6_SEQ, GRAD_BF16 = 128256 // 16, 8, 4096 // 16, 2e-2


def _c6_grads(n_mb, jcfg, cfg, jparams, model, batch):
    """Both packages' gradients of the first step at ``n_mb`` microbatches,
    accumulated as their train steps do (the reference's fp32 scan sum,
    ``steps.py:277-290``; the port's ``lm_train_step``) and divided by
    ``n_mb``; the port's embedding gradient also as an fp32 scatter-add of
    the gradient at its gathered rows (the first layer's input)."""
    tokens, labels = batch["tokens"], batch["labels"]
    gfn = jax.jit(jax.grad(lambda p, t, l: jt.transformer_loss(p, jcfg, t, l, ce_chunk=512)))
    layer_forward, armed, rows = tt._layer_forward, [False], {}

    def capture(p, c, h, *args, **kw):
        if armed[0]:
            armed[0] = False
            h.register_hook(lambda g: rows.__setitem__("dh", g))
        return layer_forward(p, c, h, *args, **kw)

    ref, port = None, {}
    emb32 = torch.zeros(model.embed.shape, dtype=torch.float32)
    tt._layer_forward = capture
    try:
        for i in range(n_mb):  # row r of microbatch i is batch row r * n_mb + i, in both
            g = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), gfn(jparams, tokens[i::n_mb],
                                                                                   labels[i::n_mb]))
            ref = g if ref is None else jax.tree_util.tree_map(np.add, ref, g)
            for p in model.parameters():
                p.grad = None
            armed[0] = True
            tt.transformer_loss(model, cfg, tokens[i::n_mb], labels[i::n_mb], ce_chunk=512).backward()
            for n, p in model.named_parameters():
                port[n] = port.get(n, 0) + p.grad.float()
            emb32.index_add_(0, torch.from_numpy(tokens[i::n_mb]).long().reshape(-1),
                             rows.pop("dh").float().reshape(-1, cfg.d_model))
    finally:
        tt._layer_forward = layer_forward
    ref = {n: _ref_leaf(ref, n) / n_mb for n in port}
    return ref, {n: (g / n_mb).numpy() for n, g in port.items()}, (emb32 / n_mb).numpy()


def test_first_gradient_norm_gap_is_the_bf16_embedding_scatter():
    """The first gradient norm of a bf16 llama step differs between 1 and
    8 microbatches (84.27 and 85.38 on the card at full width).  Both
    packages show the same gap, their gradients agreeing leaf by leaf at
    each count; the embedding carries it (its bf16 scatter-add over the
    gathered rows stagnates on token 0's hundreds of duplicates, fewer in
    each microbatch); an fp32 scatter-add of the same rows' gradients
    gives the same embedding gradient at both counts."""
    jcfg = dataclasses.replace(jax_get_arch("llama3-8b").make_reduced_config(), dtype=jax.numpy.bfloat16,
                               vocab=C6_VOCAB, remat=False)
    cfg = dataclasses.replace(get_arch("llama3-8b").make_reduced_config(), dtype=torch.bfloat16, vocab=C6_VOCAB,
                              remat=False)
    jparams = jt.transformer_init(jax.random.PRNGKey(0), jcfg)
    model = tt.transformer_from_jax(_np(jparams), cfg, device="cpu").requires_grad_(True)
    batch = lm_batches(0, C6_BATCH, C6_SEQ, C6_VOCAB)(0)
    assert (batch["tokens"] == 0).sum() > 400  # token 0's duplicates
    norms, emb32 = {}, {}
    for n_mb in (1, 8):
        ref, port, emb32[n_mb] = _c6_grads(n_mb, jcfg, cfg, jparams, model, batch)
        for n in port:
            rel = np.linalg.norm(port[n] - ref[n]) / max(np.linalg.norm(ref[n]), 1e-30)
            assert rel <= GRAD_BF16, (n_mb, n, rel)
        norms[n_mb] = {pkg: {n: float(np.linalg.norm(g[n])) for n in g} for pkg, g in (("ref", ref), ("port", port))}
    for pkg in ("ref", "port"):
        n1, n8 = norms[1][pkg], norms[8][pkg]
        gap = sum(n8[n] ** 2 for n in n8) - sum(n1[n] ** 2 for n in n1)
        assert n8["embed"] > 1.03 * n1["embed"], pkg  # the gap
        assert n8["embed"] ** 2 - n1["embed"] ** 2 >= 0.9 * gap, pkg  # carried by the embedding
    assert abs(norms[8]["port"]["embed"] / norms[1]["port"]["embed"]
               - norms[8]["ref"]["embed"] / norms[1]["ref"]["embed"]) <= 0.01  # the same gap in both
    a, b = emb32[1], emb32[8]
    assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(a)  # fp32 sums: no gap
    assert abs(np.linalg.norm(a) / norms[8]["port"]["embed"] - 1) <= 0.01


def test_train_lm_example_runs_on_the_cpu_and_needs_a_card_otherwise(tmp_path):
    """``examples/train_lm_torch.py --small --device cpu`` trains, saves
    and resumes; without ``--device`` it asks for a card and raises
    where none is present."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    cmd = [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"), "--small", "--steps", "4",
           "--ckpt-dir", str(tmp_path / "ck")]
    out = subprocess.run(cmd + ["--device", "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step 0: loss=" in out.stdout and "loss: first=" in out.stdout
    out = subprocess.run(cmd + ["--device", "cpu", "--steps", "6"], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0 and "resumed from step 3" in out.stdout, out.stdout + out.stderr
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
        assert out.returncode != 0 and "device='cpu'" in out.stderr


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", FAMILIES)
def test_gradient_check_runs_on_the_cpu(name):
    """``chip_smoke.model_grads`` (phase 14's full-width gradient check)
    at each family's reduced config on the CPU, where both passes are
    plain versions: no position flips its experts (MoE at the no-drop
    capacity), every leaf within 1e-6, no launch; its masked loss and
    ``route_log``'s routes (B, S, k) a MoE layer run as on the card."""
    smoke = _chip_smoke()
    cfg = get_arch(name).make_reduced_config()
    ok, line = smoke.model_grads(name, cfg, 2, 16, torch.device("cpu"))
    assert ok, line
    assert line["route_flips"] == 0 and line["positions_kept"] == line["positions"] == 32
    assert line["max_rel_l2"] <= 1e-6 and line["leaves"] == len(list(tt.transformer_init(0, cfg, device="cpu")
                                                                      .parameters()))
    assert line["launches"] == {"flash_attention": 0, "flash_attention_bwd": 0}
    if cfg.moe is not None:
        assert line["capacity_factor"] == cfg.moe.n_experts / cfg.moe.top_k
        model = tt.transformer_init(0, cfg, device="cpu")
        tokens, _ = _tokens(cfg)
        with torch.no_grad(), smoke.route_log() as log:
            tt._hidden(model, cfg, tokens)
        assert len(log.calls) == cfg.n_layers - cfg.n_dense_layers
        assert all(c.reshape(2, 16, -1).shape[-1] == cfg.moe.top_k for c in log.calls)


def test_gradient_check_loss_leaves_out_the_masked_positions():
    """The check's loss is the mean cross-entropy of the kept positions
    alone: a masked position's logits get no gradient, and the loss
    equals the plain mean over the kept rows."""
    smoke = _chip_smoke()
    cfg = get_arch("grok-1-314b").make_reduced_config()
    model = tt.transformer_init(0, cfg, device="cpu")
    tokens, labels = _tokens(cfg)
    h = tt._hidden(model, cfg, tokens).detach().requires_grad_(True)
    labels = torch.from_numpy(labels).long()
    keep = torch.ones(labels.shape, dtype=torch.bool)
    keep[0, 3] = keep[1, 10] = False
    loss = smoke.grad_check_loss(model, h, labels, keep)
    loss.backward()
    assert h.grad[0, 3].abs().max() == 0 and h.grad[1, 10].abs().max() == 0 and h.grad[0, 4].abs().max() > 0
    logits = (h[keep] @ model.lm_head).double()
    want = (torch.logsumexp(logits, -1) - logits.gather(-1, labels[keep][:, None])[:, 0]).mean()
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-6)


@pytest.mark.gpu
def test_gpu_lm_train_step_matches_cpu():
    """One ``lm_train_step`` of the reduced llama on the card (the
    attention forward and backward kernels) against the same step on the
    CPU (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, cfg, jparams, cpu = _models("llama3-8b")
    card = tt.transformer_from_jax(_np(jparams), cfg, device="cuda")
    batch = lm_batches(5, 2, 64, cfg.vocab)(0)
    grads = _port_grads(tt.transformer_from_jax(_np(jparams), cfg, device="cpu"), cfg, batch, 16)
    res = []
    for m in (cpu, card):
        params = param_tree(m)
        res.append(steps.lm_train_step(m, cfg, params, steps.lm_optimizer(cfg).init(params), batch, ce_chunk=16)[2])
    np.testing.assert_allclose(res[1]["loss"].item(), res[0]["loss"].item(), rtol=1e-5)
    _check_params({n: p.detach().cpu().numpy() for n, p in card.named_parameters()},
                  {n: p.detach().numpy() for n, p in cpu.named_parameters()}, grads)
