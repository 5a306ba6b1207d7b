"""Train steps (port of the step bodies of ``repro.launch.steps``): for
the LM, recsys and GNN families, ``step(params, opt_state, batch) ->
(params, opt_state, metrics)`` as ``train.trainer.train_loop`` calls
it.  The reference builds each step with its mesh, shardings and
abstract arguments for ``jax.jit(...).lower``; the port runs on one
device and keeps only the bodies: loss, gradients, the optimizer.

* ``lm_train_step`` (``build_lm_train`` ``:259-305``): the loss through
  ``transformer_loss`` (chunked cross-entropy, remat as the config
  says), microbatches accumulated in fp32 when ``lm_microbatches`` asks
  for more than one (bf16 above 1e11 parameters, as the reference),
  ``clip_by_global_norm(1.0)``, ``adamw(lr=3e-4)`` (bf16 state above
  1e11 parameters), ``apply_updates`` (through the optimizer's ``apply``
  where it has one: each leaf's update added as soon as it is computed,
  over blocks of rows, bit for bit the same);
* ``recsys_train_step`` (``build_recsys_train`` ``:655-661``):
  ``bce_loss`` of ``recsys_logits``, ``adamw(lr=1e-3)``;
* ``gnn_train_step`` (``build_gnn_train`` ``:503-549``): the molecule
  shape's squared error of the graph logits' sum against ``y``, the
  others' ``gat_loss`` with label and edge masks, ``adamw(lr=1e-3)``.

``params`` is a tree of the model's own tensors (``param_tree(model)``
for a module, the dict of ``gat_init``): the steps make them require a
gradient, take the gradients with ``torch.autograd.grad`` and update
the tensors in place.  Batches are dicts of numpy arrays or tensors;
they go to the parameters' device.  The loss in ``metrics`` is a 0-d
tensor on the device (read it when needed: reading syncs).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..models import gnn as gnn_mod
from ..models.recsys import bce_loss, recsys_logits
from ..models.transformer import TransformerConfig, transformer_loss
from ..train.optimizer import Optimizer, adamw, apply_updates, clip_by_global_norm, tree_leaves, tree_map

__all__ = [
    "lm_microbatches", "lm_optimizer", "lm_ce_chunk", "lm_train_step", "recsys_optimizer", "recsys_train_step",
    "gnn_optimizer", "gnn_train_step",
]

F32 = torch.float32


def _huge(cfg: TransformerConfig) -> bool:
    return cfg.param_count() > 1e11


def lm_microbatches(cfg: TransformerConfig, batch: int) -> int:
    """Gradient-accumulation factor (the reference's ``_lm_microbatches``
    on one data shard): 16 above 1e11 parameters, 2 above 3e10, else 1,
    halved until it divides the batch."""
    n = cfg.param_count()
    want = 16 if n > 1e11 else (2 if n > 3e10 else 1)
    while batch % want:
        want //= 2
    return max(want, 1)


def lm_optimizer(cfg: TransformerConfig) -> Optimizer:
    """``adamw(lr=3e-4)``, its state in bf16 above 1e11 parameters."""
    return adamw(lr=3e-4, state_dtype=torch.bfloat16 if _huge(cfg) else F32)


def lm_ce_chunk(cfg: TransformerConfig) -> int:
    """The loss's sequence chunk: 256 above 1e11 parameters, else 512."""
    return 256 if _huge(cfg) else 512


def _to_device(batch, device):
    return {k: torch.as_tensor(v, device=device) if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in batch.items()}


def _leaves(params):
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    return leaves


def _value_and_grad(loss_fn, leaves):
    """(loss, gradients): a leaf the loss does not reach gets zeros, as
    under ``jax.value_and_grad``."""
    loss = loss_fn()
    return loss.detach(), list(torch.autograd.grad(loss, leaves, materialize_grads=True))


def _unflatten(params, flat):
    it = iter(flat)
    return tree_map(lambda _: next(it), params)


def lm_train_step(model: nn.Module, cfg: TransformerConfig, params, opt_state, batch, *,
                  n_microbatches: Optional[int] = None, ce_chunk: Optional[int] = None,
                  opt: Optional[Optimizer] = None):
    """One LM train step on ``model`` (whose parameters ``params``, a
    ``param_tree(model)``, are): ``batch`` holds ``tokens`` and
    ``labels`` (B, S).  ``n_microbatches`` defaults to
    ``lm_microbatches``, ``ce_chunk`` to ``lm_ce_chunk`` (0: the whole
    logits), ``opt`` to ``lm_optimizer``.  Returns (params, opt_state,
    {"loss", "grad_norm"})."""
    opt = opt or lm_optimizer(cfg)
    batch = _to_device(batch, model.embed.device)
    b = batch["tokens"].shape[0]
    n_mb = lm_microbatches(cfg, b) if n_microbatches is None else n_microbatches
    chunk = lm_ce_chunk(cfg) if ce_chunk is None else ce_chunk
    leaves = _leaves(params)

    def loss_fn(tokens, labels):
        return lambda: transformer_loss(model, cfg, tokens, labels, ce_chunk=chunk or None)

    if n_mb == 1:
        loss, grads = _value_and_grad(loss_fn(batch["tokens"], batch["labels"]), leaves)
    else:
        if b % n_mb:
            raise ValueError(f"batch {b} does not split into {n_mb} microbatches")
        # the reference's split: row r of microbatch i is batch row r * n_mb + i
        mb = {k: v.reshape(b // n_mb, n_mb, *v.shape[1:]).transpose(0, 1) for k, v in batch.items()}
        acc_dtype = torch.bfloat16 if _huge(cfg) else F32
        loss = torch.zeros((), dtype=F32, device=model.embed.device)
        grads = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device) for p in leaves]
        for i in range(n_mb):
            l_i, g_i = _value_and_grad(loss_fn(mb["tokens"][i], mb["labels"][i]), leaves)
            loss = loss + l_i
            for j, g in enumerate(g_i):
                grads[j] = (grads[j].to(F32) + g.to(F32)).to(acc_dtype)
            del g_i
        loss = loss / n_mb
        grads = [g / n_mb for g in grads]
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    grads = _unflatten(params, grads)
    if opt.apply is not None:  # each leaf's update added as it is computed: no tree of fp32 updates held
        opt_state = opt.apply(grads, opt_state, params)
    else:
        updates, opt_state = opt.update(grads, opt_state, params)
        apply_updates(params, updates)
    return params, opt_state, {"loss": loss, "grad_norm": gnorm}


def recsys_optimizer() -> Optimizer:
    return adamw(lr=1e-3)


def recsys_train_step(model: nn.Module, cfg, params, opt_state, batch):
    """One recsys train step: ``bce_loss(recsys_logits(model, cfg,
    batch), batch["label"])``, ``adamw(lr=1e-3)``.  Returns (params,
    opt_state, {"loss"})."""
    dev = tree_leaves(params)[0].device
    batch = _to_device(batch, dev)
    leaves = _leaves(params)
    loss, grads = _value_and_grad(lambda: bce_loss(recsys_logits(model, cfg, batch), batch["label"]), leaves)
    updates, opt_state = recsys_optimizer().update(_unflatten(params, grads), opt_state, params)
    apply_updates(params, updates)
    return params, opt_state, {"loss": loss}


def gnn_optimizer() -> Optimizer:
    return adamw(lr=1e-3)


def gnn_train_step(cfg: gnn_mod.GATConfig, params, opt_state, batch):
    """One GAT train step.  A batch with ``y`` is the molecule shape:
    the mean squared error of ``gat_forward_batched``'s logits summed
    over the classes against ``y``; else ``gat_loss`` with the batch's
    ``labels``, ``label_mask`` and ``edge_mask``.  ``adamw(lr=1e-3)``.
    Returns (params, opt_state, {"loss"})."""
    dev = tree_leaves(params)[0].device
    batch = _to_device(batch, dev)
    leaves = _leaves(params)
    if "y" in batch:
        def loss_fn():
            logits = gnn_mod.gat_forward_batched(params, cfg, batch["feats"], batch["src"], batch["dst"])
            return torch.mean(torch.square(logits.sum(-1) - batch["y"]))
    else:
        def loss_fn():
            return gnn_mod.gat_loss(params, cfg, batch["feats"], batch["src"], batch["dst"], batch["labels"],
                                    label_mask=batch.get("label_mask"), edge_mask=batch.get("edge_mask"))
    loss, grads = _value_and_grad(loss_fn, leaves)
    updates, opt_state = gnn_optimizer().update(_unflatten(params, grads), opt_state, params)
    apply_updates(params, updates)
    return params, opt_state, {"loss": loss}
