"""Train, prefill and decode steps (port of the step bodies and the LM
sharding rules of ``repro.launch.steps``): for the LM, recsys and GNN
families, ``step(params, opt_state, batch) -> (params, opt_state,
metrics)`` as ``train.trainer.train_loop`` calls it.  The reference
builds each step with its mesh, shardings and abstract arguments for
``jax.jit(...).lower``; the port runs the bodies, on one device or,
for the LM with ``mesh=`` (a ``DeviceMesh`` with a ``"model"`` axis
and the data axes of ``distributed.sharding.data_axes``), on DTensors
across the mesh's ranks.

The LM rules (``:82-217``, ``:368-387`` of the reference) give DTensor
placements: ``_lm_leaf_spec`` (the FSDP x TP rule, and the MoE experts'
two regimes: expert parallel when the experts divide ``"model"``,
tensor parallel otherwise), ``_lm_param_shardings``,
``_moe_group_config`` (``groups`` = the data shards and the four MoE
hooks), ``_lm_shard_layer_params``, ``_lm_shard_act``,
``_lm_microbatches`` and ``_cache_shardings``.  The reference stacks
its layers and pins each scan slice; the port's layers are unstacked,
so every per-layer leaf of two or more dimensions takes
``_lm_leaf_spec`` of its own (slice) shape and name, and a 1-D leaf is
replicated (the reference leaves the slice unconstrained).
``shard_lm_params`` lays a ``Transformer``'s parameters out so (each
rank cuts its own shards from the full weights it holds: no
collective), ``shard_lm_cache`` a KV cache, and the steps take
``mesh=``:

* ``lm_train_step(..., mesh=)``: the reference's ``train_step`` with its
  hooks (``shard_act``, ``shard_layer_params``, ``shard_qkv``,
  ``shard_logits``, ``shard_grads``), its microbatches kept on their
  data shards;
* ``lm_prefill_step``: ``prefill_step`` (the batch in chunks above 1e11
  parameters);
* ``lm_decode_step``: the baseline ``decode_step`` (no hooks; the cache
  as ``_cache_shardings`` lays it out).

A sharded step runs under DTensor's ``implicit_replication`` (plain
tensors such as positions count as replicated); ``mesh=None`` is the
single-device code.

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

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..distributed.sharding import axis_size, data_axes, is_dtensor, named, param_sharding_rule, spec_to_placements
from ..models import gnn as gnn_mod
from ..models.layers import whole
from ..models.recsys import bce_loss, recsys_logits
from ..models.transformer import (TransformerConfig, transformer_decode_step, transformer_loss,
                                  transformer_prefill)
from ..train.optimizer import Optimizer, adamw, apply_updates, clip_by_global_norm, tree_leaves, tree_map

__all__ = [
    "lm_microbatches", "lm_optimizer", "lm_ce_chunk", "lm_train_step", "lm_loss_and_grads", "lm_prefill_step",
    "lm_decode_step", "shard_lm_params", "shard_lm_cache", "shard_batch", "recsys_optimizer", "recsys_train_step",
    "gnn_optimizer", "gnn_train_step",
]

F32 = torch.float32


def _huge(cfg: TransformerConfig) -> bool:
    return cfg.param_count() > 1e11


# ---------------------------------------------------------------------------
# the LM sharding rules
# ---------------------------------------------------------------------------


def _dp(mesh):
    """The data axes as a spec entry: a bare name on a one-axis mesh."""
    axes = data_axes(mesh)
    return axes if len(axes) > 1 else axes[0]


def _lm_shard_act(mesh):
    """The residual (B, S, d): batch over the data axes, sequence over
    ``"model"``; other ranks of tensor as they are."""
    placements = named(mesh, _dp(mesh), "model", None)

    def shard(x):
        return x.redistribute(mesh, placements) if x.ndim == 3 else x

    return shard


def _lm_leaf_spec(mesh, pstr: str, shape) -> tuple:
    """The FSDP x TP leaf rule as placements (``param_sharding_rule``),
    but for MoE expert stacks (``"moe"`` in the name, 3-D or more, not
    the router): expert parallel where the experts divide ``"model"``
    (experts over ``"model"``, the second-to-last dimension over the data
    axes), else tensor parallel (``wo`` row-parallel: f over
    ``"model"``, d over the data axes; ``wi`` column-parallel: d over the
    data axes, f over ``"model"``), each dimension only where it
    divides."""
    model = axis_size(mesh, "model")
    dp = _dp(mesh)
    dp_size = axis_size(mesh, dp)
    ndim = len(shape)
    if "moe" in pstr and ndim >= 3 and "router" not in pstr:
        e_ax = ndim - 3
        spec: list = [None] * ndim
        if shape[e_ax] % model == 0:
            spec[e_ax] = "model"                          # expert parallel
            if shape[-2] % dp_size == 0:
                spec[-2] = dp
        elif "wo" in pstr:                                # tensor parallel, row-parallel wo
            if shape[-2] % model == 0:
                spec[-2] = "model"
            if shape[-1] % dp_size == 0:
                spec[-1] = dp
        else:                                             # column-parallel wi
            if shape[-2] % dp_size == 0:
                spec[-2] = dp
            if shape[-1] % model == 0:
                spec[-1] = "model"
        return spec_to_placements(mesh, spec)
    return param_sharding_rule(mesh, tuple(shape))


def _lm_param_shardings(mesh, params) -> dict:
    """``{name: placements}`` of a ``Transformer`` (or its
    ``param_tree``): ``_lm_leaf_spec`` of each leaf's name and shape."""
    tree = dict(params.named_parameters()) if isinstance(params, nn.Module) else params
    return {name: _lm_leaf_spec(mesh, name, tuple(p.shape)) for name, p in tree.items()}


def _moe_group_config(cfg: TransformerConfig, mesh) -> TransformerConfig:
    """``cfg`` with the MoE's dispatch groups on the data shards
    (``groups`` = the data shards) and its hooks.  Expert parallel (the
    experts divide ``"model"``): the tokens and entries have d over
    ``"model"`` where it divides, the scatter's buffers (G, E, C, d) d
    over ``"model"``, the experts' E over ``"model"`` (the switch between
    them is the all-to-all).  Tensor parallel: every (G, ...) tensor has
    only G over the data axes."""
    if cfg.moe is None:
        return cfg
    model = axis_size(mesh, "model")
    dp = _dp(mesh)
    dp_size = axis_size(mesh, dp)
    ep = cfg.moe.n_experts % model == 0

    def pin(*spec):
        placements = named(mesh, *spec)
        return lambda x: x.redistribute(mesh, placements)

    d_ax = "model" if ep and cfg.moe.d_model % model == 0 else None
    moe = dataclasses.replace(
        cfg.moe, groups=dp_size, shard_buffers=pin(dp, "model" if ep else None, None, None),
        shard_tokens=pin(dp, None, d_ax), shard_entries=pin(dp, None, d_ax),
        shard_dispatch=pin(dp, None, None, d_ax))
    return dataclasses.replace(cfg, moe=moe)


def _lm_shard_layer_params(mesh):
    """A layer's parameters, each leaf of two or more dimensions laid out
    by ``_lm_leaf_spec`` of its name and shape (a no-op, with no
    collective, where it already is); 1-D leaves as they are."""

    def shard(layer, prefix=""):
        out = {}
        for name, leaf in layer.items():
            if isinstance(leaf, nn.Module) or isinstance(leaf, dict):
                out[name] = shard(leaf, f"{prefix}{name}.")
            elif leaf.ndim >= 2:
                out[name] = leaf.redistribute(mesh, _lm_leaf_spec(mesh, prefix + name, tuple(leaf.shape)))
            else:
                out[name] = leaf
        return out

    return shard


def _lm_shard_qkv(mesh):
    """q, k, v (B, H, S, D): batch over the data axes, heads over
    ``"model"`` (the Ulysses layout) where they divide, else replicated
    (GQA kv heads: one gather a layer instead of one a kv block)."""
    model, dp = axis_size(mesh, "model"), _dp(mesh)

    def shard(x):
        return x.redistribute(mesh, named(mesh, dp, "model" if x.shape[1] % model == 0 else None, None, None))

    return shard


def _lm_shard_logits(mesh):
    """A loss chunk's logits (B, C, V): batch over the data axes,
    vocabulary over ``"model"``."""
    placements = named(mesh, _dp(mesh), None, "model")
    return lambda x: x.redistribute(mesh, placements)


def _lm_microbatches(cfg: TransformerConfig, batch: int, mesh=None) -> int:
    """Gradient-accumulation factor: 16 above 1e11 parameters, 2 above
    3e10, else 1, halved until it divides the batch a data shard holds
    (``mesh=None``: one shard)."""
    n = cfg.param_count()
    per_shard = batch // (axis_size(mesh, _dp(mesh)) if mesh is not None else 1)
    want = 16 if n > 1e11 else (2 if n > 3e10 else 1)
    while per_shard % want:
        want //= 2
    return max(want, 1)


def lm_microbatches(cfg: TransformerConfig, batch: int) -> int:
    """``_lm_microbatches`` on one data shard."""
    return _lm_microbatches(cfg, batch)


def _cache_shardings(cfg: TransformerConfig, mesh, batch: int) -> dict:
    """The KV cache's placements: batch over the data axes where it
    divides; GQA heads over ``"model"`` where they divide, else the
    sequence; MLA's latent (no head axis) the sequence."""
    dp = _dp(mesh)
    b_ax = dp if batch % axis_size(mesh, dp) == 0 else None
    if cfg.attention == "mla":
        pl = named(mesh, None, b_ax, "model", None)
        return {k: pl for k in ("ckv", "krope", "prefix_ckv", "prefix_krope")}
    if cfg.kv_heads % axis_size(mesh, "model") == 0:
        pl = named(mesh, None, b_ax, "model", None, None)     # heads over model
    else:
        pl = named(mesh, None, b_ax, None, "model", None)     # sequence over model
    return {k: pl for k in ("k", "v", "prefix_k", "prefix_v")}


def _distribute(x: torch.Tensor, mesh, placements):
    """``x`` (held whole on every rank) as a DTensor: each rank keeps its
    own shard, no collective."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def shard_lm_params(model: nn.Module, cfg: TransformerConfig, mesh) -> nn.Module:
    """``model``'s parameters (the same full weights on every rank, e.g.
    from ``transformer_init`` with one seed or ``transformer_from_jax``)
    replaced in place by DTensors laid out by ``_lm_param_shardings``;
    each keeps its ``requires_grad``.  Returns ``model``."""
    del cfg  # the rules read names and shapes
    rules = _lm_param_shardings(mesh, model)
    with torch.no_grad():
        for mname, mod in model.named_modules():
            for pname, p in list(mod._parameters.items()):
                name = f"{mname}.{pname}" if mname else pname
                mod._parameters[pname] = nn.Parameter(_distribute(p.detach(), mesh, rules[name]),
                                                      requires_grad=p.requires_grad)
    return model


def shard_lm_cache(cache: dict, cfg: TransformerConfig, mesh) -> dict:
    """A ``make_cache`` cache (the same on every rank) as DTensors laid
    out by ``_cache_shardings`` (inference tensors); the decode step
    writes their local shards in place."""
    key = next(iter(cache))
    rules = _cache_shardings(cfg, mesh, cache[key].shape[1])
    with torch.inference_mode():  # the decode step takes views of it under inference mode
        return {k: _distribute(v, mesh, rules[k]) for k, v in cache.items()}


def shard_batch(x, mesh, device) -> torch.Tensor:
    """A batch array (B, ...) held whole on every rank as a DTensor with
    its rows over the data axes (the reference's ``named(mesh, dp,
    None)``)."""
    x = torch.as_tensor(x, device=device)
    return _distribute(x, mesh, named(mesh, _dp(mesh), *([None] * (x.ndim - 1))))


def _sharded(mesh):
    """The context of a sharded step: plain tensors count as replicated."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


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


def _lm_hooks(mesh) -> dict:
    """The train step's hooks on ``mesh`` (none without a mesh)."""
    if mesh is None:
        return {}
    return dict(shard_act=_lm_shard_act(mesh), shard_layer_params=_lm_shard_layer_params(mesh),
                shard_qkv=_lm_shard_qkv(mesh), shard_logits=_lm_shard_logits(mesh))


def _shard_grads(grads: list, leaves: list) -> list:
    """Each gradient laid out as its parameter (the reference's
    ``shard_grads``); plain tensors as they are."""
    return [g.redistribute(p.device_mesh, p.placements) if is_dtensor(g) else g for g, p in zip(grads, leaves)]


def lm_loss_and_grads(model: nn.Module, cfg: TransformerConfig, batch, *, mesh=None,
                      n_microbatches: Optional[int] = None, ce_chunk: Optional[int] = None):
    """The train step's loss (a 0-d tensor) and gradients (one a leaf of
    ``param_tree(model)``, in its order; on a mesh, DTensors laid out as
    their parameters): ``n_microbatches`` defaults to
    ``_lm_microbatches`` on ``mesh``, ``ce_chunk`` to ``lm_ce_chunk`` (0:
    the whole logits).  With ``mesh`` the model's parameters must be
    ``shard_lm_params``' and the batch arrays are held whole on every
    rank."""
    from ..train.optimizer import param_tree

    dev = tree_leaves(param_tree(model))[0].device if mesh is None else torch.device(mesh.device_type)
    if mesh is not None:
        cfg = _moe_group_config(cfg, mesh)
        batch = {k: shard_batch(batch[k], mesh, dev) for k in ("tokens", "labels")}
    else:
        batch = _to_device(batch, dev)
    b = batch["tokens"].shape[0]
    n_mb = _lm_microbatches(cfg, b, mesh) if n_microbatches is None else n_microbatches
    chunk = lm_ce_chunk(cfg) if ce_chunk is None else ce_chunk
    leaves = _leaves(param_tree(model))
    hooks = _lm_hooks(mesh)

    def loss_fn(tokens, labels):
        return lambda: transformer_loss(model, cfg, tokens, labels, ce_chunk=chunk or None, **hooks)

    with _sharded(mesh):
        if n_mb == 1:
            loss, grads = _value_and_grad(loss_fn(batch["tokens"], batch["labels"]), leaves)
        else:
            if b % n_mb:
                raise ValueError(f"batch {b} does not split into {n_mb} microbatches")
            # the reference's split: row r of microbatch i is batch row r * n_mb + i (kept on its data shard)
            mb = {k: v.reshape(b // n_mb, n_mb, *v.shape[1:]).transpose(0, 1) for k, v in batch.items()}
            acc_dtype = torch.bfloat16 if _huge(cfg) else F32
            loss = torch.zeros((), dtype=F32, device=dev)
            grads = [torch.zeros_like(p, dtype=acc_dtype) for p in leaves]
            for i in range(n_mb):
                l_i, g_i = _value_and_grad(loss_fn(mb["tokens"][i], mb["labels"][i]), leaves)
                loss = loss + l_i
                for j, g in enumerate(_shard_grads(g_i, leaves)):
                    grads[j] = (grads[j].to(F32) + g.to(F32)).to(acc_dtype)
                del g_i
            loss = loss / n_mb
            grads = [g / n_mb for g in grads]
        grads = _shard_grads(grads, leaves)
    if is_dtensor(loss):
        loss = loss.full_tensor()
    return loss, grads


def lm_train_step(model: nn.Module, cfg: TransformerConfig, params, opt_state, batch, *,
                  n_microbatches: Optional[int] = None, ce_chunk: Optional[int] = None,
                  opt: Optional[Optimizer] = None, mesh=None):
    """One LM train step on ``model`` (whose parameters ``params``, a
    ``param_tree(model)``, are): ``batch`` holds ``tokens`` and
    ``labels`` (B, S).  ``n_microbatches`` defaults to
    ``_lm_microbatches``, ``ce_chunk`` to ``lm_ce_chunk`` (0: the whole
    logits), ``opt`` to ``lm_optimizer``.  ``mesh``: the step across the
    mesh's ranks (``lm_loss_and_grads``; the optimizer state from
    ``opt.init`` of the sharded ``params``).  Returns (params, opt_state,
    {"loss", "grad_norm"})."""
    opt = opt or lm_optimizer(cfg)
    loss, grads = lm_loss_and_grads(model, cfg, batch, mesh=mesh, n_microbatches=n_microbatches, ce_chunk=ce_chunk)
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    grads = _unflatten(params, grads)
    if opt.apply is not None:  # each leaf's update added as it is computed: no tree of fp32 updates held
        opt_state = opt.apply(grads, opt_state, params)
    else:
        updates, opt_state = opt.update(grads, opt_state, params)
        apply_updates(params, updates)
    return params, opt_state, {"loss": loss, "grad_norm": gnorm}


def lm_prefill_step(model: nn.Module, cfg: TransformerConfig, tokens, *, mesh=None,
                    n_chunks: Optional[int] = None):
    """The reference's ``prefill_step``: the last position's logits (B,
    V) of ``transformer_prefill``; above 1e11 parameters the batch runs
    in ``_lm_microbatches`` chunks, one after another (``n_chunks``
    overrides).  ``mesh``: across its ranks with the train step's
    ``shard_act`` and ``shard_layer_params``; the logits come back as a
    DTensor with the batch over the data axes and the vocabulary over
    ``"model"``."""
    dev = model.embed.device if mesh is None else torch.device(mesh.device_type)
    hooks = {}
    if mesh is not None:
        cfg = _moe_group_config(cfg, mesh)
        tokens = shard_batch(tokens, mesh, dev)
        hooks = dict(shard_act=_lm_shard_act(mesh), shard_layer_params=_lm_shard_layer_params(mesh))
    b, s = tokens.shape
    n = _lm_microbatches(cfg, b, mesh) if n_chunks is None else n_chunks
    with _sharded(mesh):
        if n == 1:
            out = transformer_prefill(model, cfg, tokens, **hooks)
        else:  # one chunk of rows after another (each laid out by the hooks), the logits in row order
            chunks = whole(torch.as_tensor(tokens, device=dev) if mesh is None else tokens, 0).reshape(n, b // n, s)
            out = torch.cat([whole(transformer_prefill(model, cfg, chunks[i], **hooks), 0) for i in range(n)])
        if mesh is not None:
            out = out.redistribute(mesh, named(mesh, _dp(mesh), "model"))
    return out


def lm_decode_step(model: nn.Module, cfg: TransformerConfig, token, cache: dict, cur_len, *, mesh=None):
    """The reference's baseline ``decode_step``: ``transformer_decode_step``
    with no hooks (logits (B, V), the cache written in place).  ``mesh``:
    across its ranks, the cache from ``shard_lm_cache``; the logits come
    back with the batch over the data axes where it divides and the
    vocabulary over ``"model"``."""
    if mesh is None:
        return transformer_decode_step(model, cfg, token, cache, cur_len)
    dp = _dp(mesh)
    b = np.shape(token)[0]
    b_ax = dp if b % axis_size(mesh, dp) == 0 else None
    token = _distribute(torch.as_tensor(token, device=torch.device(mesh.device_type)), mesh, named(mesh, b_ax, None))
    with _sharded(mesh):
        logits, cache = transformer_decode_step(model, cfg, token, cache, cur_len)
        return logits.redistribute(mesh, named(mesh, b_ax, "model")), cache


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
