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
