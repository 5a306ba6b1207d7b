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

The cells (the reference's ``build_lm_train``, ``build_lm_prefill``,
``build_lm_decode`` with its ``windowed`` variant, ``build_gnn_train``,
``build_recsys_*`` and ``build_cell``, ``:219-747``) are at the end of
this module: each returns a ``launch.cell.LoweredCell`` whose
``step_fn`` runs these steps on DTensors, its arguments one rank's
shards (the section's comment says how).  The loops a step runs are
named for the trace (``obs.loop_scope``): ``lm.microbatches``,
``lm.prefill_chunks`` and the loss's ``lm.ce_chunks``.

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

from ..distributed.sharding import (axis_size, data_axes, is_dtensor, named, param_sharding_rule, replicated,
                                    spec_to_placements)
from ..models import gnn as gnn_mod
from ..models.layers import whole
from ..models.recsys import bce_loss, recsys_logits
from ..models.transformer import (TransformerConfig, transformer_decode_step, transformer_loss,
                                  transformer_prefill)
from ..obs import loop_scope
from ..train.optimizer import Optimizer, adamw, apply_updates, clip_by_global_norm, tree_leaves, tree_map
from .cell import LoweredCell, global_shape

__all__ = [
    "lm_microbatches", "lm_optimizer", "lm_ce_chunk", "lm_train_step", "lm_loss_and_grads", "lm_prefill_step",
    "lm_decode_step", "shard_lm_params", "shard_lm_cache", "shard_batch", "recsys_optimizer", "recsys_train_step",
    "gnn_optimizer", "gnn_train_step", "build_lm_train", "build_lm_prefill", "build_lm_decode", "build_recsys_train",
    "build_recsys_forward", "build_recsys_retrieval", "build_gnn_train", "build_cell", "gnn_sizes", "pad_edges",
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
    if is_dtensor(x):  # a cell's argument: each rank already holds its rows
        return x
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

    dev = tree_leaves(param_tree(model))[0].device  # a DTensor's: its local shard's
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
            with loop_scope("lm.microbatches"):
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
    dev = model.embed.device
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
            with loop_scope("lm.prefill_chunks"):
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
    if not is_dtensor(token):
        token = _distribute(torch.as_tensor(token, device=model.embed.device), mesh, named(mesh, b_ax, None))
    with _sharded(mesh):
        logits, cache = transformer_decode_step(model, cfg, token, cache, cur_len)
        return logits.redistribute(mesh, named(mesh, b_ax, "model")), cache


def recsys_optimizer() -> Optimizer:
    return adamw(lr=1e-3)


def recsys_train_step(model: nn.Module, cfg, params, opt_state, batch, *, mesh=None):
    """One recsys train step: ``bce_loss(recsys_logits(model, cfg,
    batch), batch["label"])``, ``adamw(lr=1e-3)``.  ``mesh``: the
    parameters, state and batch are DTensors on it (``build_recsys_train``'s
    cell), each gradient laid out as its parameter.  Returns (params,
    opt_state, {"loss"})."""
    dev = tree_leaves(params)[0].device
    batch = _to_device(batch, dev)
    leaves = _leaves(params)
    with _sharded(mesh):
        loss, grads = _value_and_grad(lambda: bce_loss(recsys_logits(model, cfg, batch), batch["label"]), leaves)
        updates, opt_state = recsys_optimizer().update(_unflatten(params, _shard_grads(grads, leaves)), opt_state,
                                                       params)
        apply_updates(params, updates)
    return params, opt_state, {"loss": _full(loss)}


def gnn_optimizer() -> Optimizer:
    return adamw(lr=1e-3)


def gnn_train_step(cfg: gnn_mod.GATConfig, params, opt_state, batch, *, mesh=None):
    """One GAT train step.  A batch with ``y`` is the molecule shape:
    the mean squared error of ``gat_forward_batched``'s logits summed
    over the classes against ``y``; else ``gat_loss`` with the batch's
    ``labels``, ``label_mask`` and ``edge_mask``.  ``adamw(lr=1e-3)``.
    ``mesh``: DTensors on it (``build_gnn_train``'s cell: the batch split
    by graphs, or the edges split over every rank).  Returns (params,
    opt_state, {"loss"})."""
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
    with _sharded(mesh):
        loss, grads = _value_and_grad(loss_fn, leaves)
        updates, opt_state = gnn_optimizer().update(_unflatten(params, _shard_grads(grads, leaves)), opt_state,
                                                    params)
        apply_updates(params, updates)
    return params, opt_state, {"loss": _full(loss)}


def _full(x):
    """A DTensor's value as one tensor on every rank (a plain tensor as
    it is)."""
    return x.full_tensor() if is_dtensor(x) else x


# ---------------------------------------------------------------------------
# the cells: the reference's build_lm_*, build_gnn_train, build_recsys_* and
# build_cell (:219-747) on DTensor placements
# ---------------------------------------------------------------------------
#
# A cell (``launch.cell``) is ``step_fn``, one rank's ``args`` as ``meta``
# tensors of its shard shapes (a 236B model is never allocated whole),
# their ``placements`` (a tree of the same structure) and ``meta``.
# ``step_fn`` takes one rank's local tensors (the ``meta`` ones to trace,
# or real ones: ``cell.shard_args``), wraps each as a DTensor of its
# placements, runs the port's step body on the mesh and updates the
# parameters and the optimizer state in place (PyTorch has no donation:
# the updated leaves are the arguments' own storage).  Host values (the
# optimizer's step count, a decode position) are CPU tensors, replicated.


def _local_shape(shape, mesh, placements) -> tuple:
    """One rank's shard shape of a global ``shape`` (an even split: every
    rule here splits only dimensions its axes divide)."""
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dimension {p.dim} of {tuple(shape)} does not split over {n} ranks")
            out[p.dim] //= n
    return tuple(out)


def _arg(shape, dtype, mesh, placements) -> torch.Tensor:
    """One rank's shard of a global (shape, dtype) argument, on ``meta``."""
    return torch.empty(_local_shape(shape, mesh, placements), dtype=dtype, device="meta")


def _host(dtype=torch.int32) -> torch.Tensor:
    return torch.zeros((), dtype=dtype)


def _dt(local: torch.Tensor, mesh, placements):
    """``local`` (this rank's shard) as the DTensor of ``placements``: no
    collective, no copy."""
    from torch.distributed.tensor import DTensor

    shape = global_shape(local.shape, mesh, placements)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def _install(module: nn.Module, params: dict, mesh, rules: dict) -> nn.Module:
    """``module``'s parameters replaced by the DTensors of ``params`` (one
    rank's shards by name), laid out by ``rules``."""
    for mname, mod in module.named_modules():
        for pname in list(mod._parameters):
            name = f"{mname}.{pname}" if mname else pname
            mod._parameters[pname] = nn.Parameter(_dt(params[name], mesh, rules[name]), requires_grad=False)
    return module


def _opt_args(shapes: dict, mesh, rules: dict, dtype) -> dict:
    """The AdamW state of ``shapes`` ({name: (shape, ...)}) as arguments:
    ``m`` and ``v`` laid out as their parameters (the reference's
    ``_adamw_abstract_state`` and ``_opt_shardings``), the host step."""
    return {"m": {n: _arg(s, dtype, mesh, rules[n]) for n, s in shapes.items()},
            "v": {n: _arg(s, dtype, mesh, rules[n]) for n, s in shapes.items()}, "step": _host()}


def _opt_state(state: dict, mesh, rules: dict) -> dict:
    return {"m": {n: _dt(t, mesh, rules[n]) for n, t in state["m"].items()},
            "v": {n: _dt(t, mesh, rules[n]) for n, t in state["v"].items()}, "step": state["step"]}


def _opt_placements(mesh, rules) -> dict:
    return {"m": rules, "v": rules, "step": replicated(mesh)}


def _eval_shape(fn):
    """``fn()``'s tensors as fake tensors (shapes and dtypes, no memory):
    the reference's ``jax.eval_shape`` for an init that draws on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return fn()


def _lm_meta(cfg: TransformerConfig, kind: str, tokens: int, **extra) -> dict:
    return {"tokens_per_step": tokens, "param_count": cfg.param_count(),
            "active_param_count": cfg.active_param_count(), "kind": kind,
            "dtype": str(cfg.dtype).split(".")[-1], **extra}


def _lm_skeleton(cfg: TransformerConfig):
    from ..models.transformer import transformer_init

    return transformer_init(0, cfg, device="meta")


def build_lm_train(arch, shape, mesh) -> LoweredCell:
    """The reference's ``build_lm_train`` (``:219-327``): ``step_fn(params,
    opt_state, batch) -> (params, opt_state, {"loss", "grad_norm"})`` is
    ``lm_train_step`` on the mesh (microbatches by ``_lm_microbatches``,
    bf16 state and accumulation above 1e11 parameters, ``ce_chunk`` 256 or
    512, the Ulysses q/k/v layout, ``shard_logits``), the optimizer state
    placed as its parameters."""
    cfg = arch.make_config()
    b, s = shape.meta["global_batch"], shape.meta["seq_len"]
    model = _lm_skeleton(cfg)
    rules = _lm_param_shardings(mesh, model)
    state_dtype = torch.bfloat16 if _huge(cfg) else F32
    batch_pl = named(mesh, _dp(mesh), None)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    params = {n: _arg(sh, p.dtype, mesh, rules[n]) for (n, sh), p in zip(shapes.items(), model.parameters())}
    batch = {k: _arg((b, s), torch.int32, mesh, batch_pl) for k in ("tokens", "labels")}

    def train_step(params, opt_state, batch):
        from ..train.optimizer import param_tree

        _install(model, params, mesh, rules)
        bt = {k: _dt(v, mesh, batch_pl) for k, v in batch.items()}
        return lm_train_step(model, cfg, param_tree(model), _opt_state(opt_state, mesh, rules), bt, mesh=mesh)

    meta = _lm_meta(cfg, "train", b * s, microbatches=_lm_microbatches(cfg, b, mesh),
                    opt_state_dtype="bf16" if _huge(cfg) else "f32", ce_chunk=lm_ce_chunk(cfg))
    return LoweredCell(f"{arch.name}:{shape.name}", train_step,
                       (params, _opt_args(shapes, mesh, rules, state_dtype), batch),
                       (rules, _opt_placements(mesh, rules), {"tokens": batch_pl, "labels": batch_pl}), meta)


def build_lm_prefill(arch, shape, mesh) -> LoweredCell:
    """The reference's ``build_lm_prefill`` (``:329-365``): ``step_fn(params,
    tokens)`` is ``lm_prefill_step`` on the mesh (the batch in chunks
    above 1e11 parameters); the last position's logits, batch over the
    data axes and vocabulary over ``"model"``."""
    cfg = arch.make_config()
    b, s = shape.meta["global_batch"], shape.meta["seq_len"]
    model = _lm_skeleton(cfg)
    rules = _lm_param_shardings(mesh, model)
    tok_pl = named(mesh, _dp(mesh), None)
    params = {n: _arg(p.shape, p.dtype, mesh, rules[n]) for n, p in model.named_parameters()}

    def prefill_step(params, tokens):
        _install(model, params, mesh, rules)
        return lm_prefill_step(model, cfg, _dt(tokens, mesh, tok_pl), mesh=mesh)

    meta = _lm_meta(cfg, "prefill", b * s, microbatches=_lm_microbatches(cfg, b, mesh))
    return LoweredCell(f"{arch.name}:{shape.name}", prefill_step, (params, _arg((b, s), torch.int32, mesh, tok_pl)),
                       (rules, tok_pl), meta)


def _serve_param_spec(mesh, shape) -> tuple:
    """The windowed decode's weights (``:405-415``): the last dimension
    over every mesh axis where it divides the whole mesh, else the
    second-to-last, else the last over ``"model"``; 1-D leaves
    replicated (serving keeps every weight resident: no per-token
    gather)."""
    if len(shape) < 2:
        return replicated(mesh)
    axes = tuple(mesh.mesh_dim_names)
    total = axis_size(mesh, axes)
    spec: list = [None] * len(shape)
    if shape[-1] % total == 0:
        spec[-1] = axes
    elif shape[-2] % total == 0:
        spec[-2] = axes
    elif shape[-1] % axis_size(mesh, "model") == 0:
        spec[-1] = "model"
    return spec_to_placements(mesh, spec)


def _windowed_cache_spec(cfg: TransformerConfig, mesh, b_ax, ndim: int, window_len: int) -> tuple:
    """A ring or full cache's placements (``cache_sh_one``, ``:422-432``):
    leading block axes, then (B, H, S or W, D); heads over ``"model"``
    where the kv heads divide it, and where the batch does not divide
    the data axes (``long_500k``'s B 1) the window or sequence over them."""
    dp = _dp(mesh)
    lead = [None] * (ndim - 4)
    model_ok = cfg.kv_heads % axis_size(mesh, "model") == 0
    if b_ax is None and model_ok and window_len % axis_size(mesh, dp) == 0:
        return spec_to_placements(mesh, (*lead, None, "model", dp, None))
    if model_ok:
        return spec_to_placements(mesh, (*lead, b_ax, "model", None, None))
    return spec_to_placements(mesh, (*lead, b_ax, None, "model", None))


def build_lm_decode(arch, shape, mesh, variant: str = "baseline") -> LoweredCell:
    """The reference's ``build_lm_decode`` (``:388-486``): ``step_fn(params,
    token, cache, cur_len) -> (logits, cache)``, the cache written in
    place.  ``baseline``: ``lm_decode_step`` with the train rule's weights
    and ``_cache_shardings``' cache.  ``windowed`` (a hybrid local:global
    config): ``transformer_decode_step_windowed`` over ring buffers, the
    weights by ``_serve_param_spec`` and the caches by
    ``_windowed_cache_spec``."""
    from ..models.transformer import make_cache, make_cache_windowed, transformer_decode_step_windowed

    cfg = arch.make_config()
    b, s = shape.meta["global_batch"], shape.meta["seq_len"]
    model = _lm_skeleton(cfg)
    dp = _dp(mesh)
    b_ax = dp if b % axis_size(mesh, dp) == 0 else None
    tok_pl, out_pl = named(mesh, b_ax, None), named(mesh, b_ax, "model")
    extra = {"kv_len": s}
    if variant == "windowed":
        if cfg.window is None or cfg.global_every <= 0:
            raise ValueError(f"{arch.name} has no local:global pattern for the windowed decode")
        rules = {n: _serve_param_spec(mesh, tuple(p.shape)) for n, p in model.named_parameters()}
        cache = _eval_shape(lambda: make_cache_windowed(cfg, b, s, device="cpu"))
        cache_rules = {k: _windowed_cache_spec(cfg, mesh, b_ax, v.ndim, v.shape[-2]) for k, v in cache.items()}
        extra["variant"] = "windowed"
    elif variant == "baseline":
        rules = _lm_param_shardings(mesh, model)
        cache = _eval_shape(lambda: make_cache(cfg, b, s, device="cpu"))
        every = _cache_shardings(cfg, mesh, b)
        cache_rules = {k: every[k] for k in cache}
    else:
        raise ValueError(f"unknown decode variant {variant!r}")
    params = {n: _arg(p.shape, p.dtype, mesh, rules[n]) for n, p in model.named_parameters()}
    cache_args = {k: _arg(v.shape, v.dtype, mesh, cache_rules[k]) for k, v in cache.items()}

    def decode_step(params, token, cache, cur_len):
        _install(model, params, mesh, rules)
        with torch.inference_mode():
            c = {k: _dt(v, mesh, cache_rules[k]) for k, v in cache.items()}
        tok = _dt(token, mesh, tok_pl)
        if variant == "baseline":
            return lm_decode_step(model, cfg, tok, c, int(cur_len), mesh=mesh)
        with _sharded(mesh):  # no residual layout: (B, 1, d) activations stay as the products leave them
            logits, c = transformer_decode_step_windowed(model, cfg, tok, c, int(cur_len))
            return logits.redistribute(mesh, out_pl), c

    meta = _lm_meta(cfg, "decode", b, **extra)
    return LoweredCell(f"{arch.name}:{shape.name}", decode_step,
                       (params, _arg((b, 1), torch.int32, mesh, tok_pl), cache_args, _host()),
                       (rules, tok_pl, cache_rules, replicated(mesh)), meta)


# -- recsys --------------------------------------------------------------


def _recsys_model_fns(arch):
    """(cfg, skeleton, forward, user tower, embedding width): the
    reference's ``_recsys_model_fns`` (``:587-612``); the skeleton is the
    model's module on fake tensors (its parameters' names, shapes and
    dtypes; a cell installs DTensors into it)."""
    from ..models import recsys as rec

    cfg = arch.make_config()
    init = {"deepfm": rec.deepfm_init, "autoint": rec.autoint_init, "dien": rec.dien_init,
            "bst": rec.bst_init}[arch.name]
    user = {"deepfm": lambda m, b: rec.deepfm_user_embedding(m, cfg, b["ids"]),
            "autoint": lambda m, b: rec.autoint_user_embedding(m, cfg, b["ids"]),
            "dien": lambda m, b: rec.dien_user_embedding(m, cfg, b["hist"]),
            "bst": lambda m, b: rec.bst_user_embedding(m, cfg, b["hist"])}[arch.name]
    skeleton = _eval_shape(lambda: init(0, cfg, device="cpu"))
    return cfg, skeleton, (lambda m, b: recsys_logits(m, cfg, b)), user, cfg.embed_dim


def _recsys_batch_spec(arch, cfg, batch: int, mesh, with_label: bool):
    """(global shapes and dtypes, placements) of a batch (``:615-632``):
    ids (B, F) for DeepFM and AutoInt, else hist (B, L) and target (B,);
    the batch over the data axes where it divides them."""
    dp = _dp(mesh)
    b_ax = dp if batch % axis_size(mesh, dp) == 0 else None
    if arch.name in ("deepfm", "autoint"):
        spec, pl = {"ids": ((batch, cfg.n_fields), torch.int32)}, {"ids": named(mesh, b_ax, None)}
    else:
        spec = {"hist": ((batch, cfg.seq_len), torch.int32), "target": ((batch,), torch.int32)}
        pl = {"hist": named(mesh, b_ax, None), "target": named(mesh, b_ax)}
    if with_label:
        spec["label"], pl["label"] = ((batch,), F32), named(mesh, b_ax)
    return spec, pl


def _recsys_param_shardings(mesh, model: nn.Module) -> dict:
    """``{name: placements}`` (``:635-645``): tables of 4,096 rows or more
    row-sharded over every mesh axis where the rows divide the mesh;
    other leaves of two or more dimensions by ``param_sharding_rule``,
    the rest replicated."""
    axes = tuple(mesh.mesh_dim_names)
    total = axis_size(mesh, axes)

    def rule(shape):
        if len(shape) == 2 and shape[0] >= 4096 and shape[0] % total == 0:
            return spec_to_placements(mesh, (axes, None))
        return param_sharding_rule(mesh, shape) if len(shape) >= 2 else replicated(mesh)

    return {n: rule(tuple(p.shape)) for n, p in model.named_parameters()}


def _recsys_cell(arch, shape, mesh, kind: str):
    """What the three recsys builders share: the model's functions, its
    rules, the batch's placements, the arguments and ``meta``."""
    import types

    cfg, model, fwd, user, emb_dim = _recsys_model_fns(arch)
    rules = _recsys_param_shardings(mesh, model)
    b = shape.meta["batch"]
    spec, batch_pl = _recsys_batch_spec(arch, cfg, b, mesh, with_label=kind == "train")
    return types.SimpleNamespace(
        cfg=cfg, model=model, fwd=fwd, user=user, emb_dim=emb_dim, rules=rules, batch_pl=batch_pl,
        params={n: _arg(p.shape, p.dtype, mesh, rules[n]) for n, p in model.named_parameters()},
        batch={k: _arg(sh, dt, mesh, batch_pl[k]) for k, (sh, dt) in spec.items()},
        meta={"kind": kind, "batch": b, "param_count": sum(p.numel() for p in model.parameters()),
              "dtype": str(cfg.dtype).split(".")[-1]})


def build_recsys_train(arch, shape, mesh) -> LoweredCell:
    """``build_recsys_train`` (``:648-672``): ``step_fn(params, opt_state,
    batch)`` is ``recsys_train_step`` on the mesh."""
    c = _recsys_cell(arch, shape, mesh, "train")
    shapes = {n: tuple(p.shape) for n, p in c.model.named_parameters()}

    def train_step(params, opt_state, batch):
        from ..train.optimizer import param_tree

        _install(c.model, params, mesh, c.rules)
        bt = {k: _dt(v, mesh, c.batch_pl[k]) for k, v in batch.items()}
        return recsys_train_step(c.model, c.cfg, param_tree(c.model), _opt_state(opt_state, mesh, c.rules), bt,
                                 mesh=mesh)

    return LoweredCell(f"{arch.name}:{shape.name}", train_step,
                       (c.params, _opt_args(shapes, mesh, c.rules, F32), c.batch),
                       (c.rules, _opt_placements(mesh, c.rules), c.batch_pl), c.meta)


def build_recsys_forward(arch, shape, mesh) -> LoweredCell:
    """``build_recsys_forward`` (``:675-692``): ``step_fn(params, batch)``
    is the sigmoid of the model's logits, the batch's layout."""
    c = _recsys_cell(arch, shape, mesh, "forward")

    def serve_step(params, batch):
        _install(c.model, params, mesh, c.rules)
        bt = {k: _dt(v, mesh, c.batch_pl[k]) for k, v in batch.items()}
        with torch.no_grad(), _sharded(mesh):  # DTensor views of the parameters refuse inference mode
            return torch.sigmoid(c.fwd(c.model, bt))

    return LoweredCell(f"{arch.name}:{shape.name}", serve_step, (c.params, c.batch), (c.rules, c.batch_pl), c.meta)


def build_recsys_retrieval(arch, shape, mesh) -> LoweredCell:
    """``build_recsys_retrieval`` (``:695-714``): ``step_fn(params, batch,
    candidates)`` is the user tower's (B, D) scores against the (N, D)
    fp32 candidates, row-sharded over ``"model"``; the scores (B, N) have
    N over ``"model"``."""
    from ..models.recsys import retrieval_scores

    c = _recsys_cell(arch, shape, mesh, "retrieval")
    nc = shape.meta["n_candidates"]
    cand_pl = named(mesh, "model", None)
    c.meta["n_candidates"] = nc

    def retrieval_step(params, batch, candidates):
        _install(c.model, params, mesh, c.rules)
        bt = {k: _dt(v, mesh, c.batch_pl[k]) for k, v in batch.items()}
        with torch.inference_mode(), _sharded(mesh):
            return retrieval_scores(c.user(c.model, bt), _dt(candidates, mesh, cand_pl))

    return LoweredCell(f"{arch.name}:{shape.name}", retrieval_step,
                       (c.params, c.batch, _arg((nc, c.emb_dim), F32, mesh, cand_pl)), (c.rules, c.batch_pl, cand_pl),
                       c.meta)


# -- GNN -----------------------------------------------------------------


def _gnn_tree(tree, fn):
    return {"layers": [{k: fn(k, v) for k, v in layer.items()} for layer in tree["layers"]]}


def gnn_sizes(shape) -> tuple:
    """(nodes, edges before padding, labeled nodes) of a non-molecule GNN
    shape; ``minibatch_lg``'s from its fan-outs, as the reference."""
    if shape.name == "minibatch_lg":
        bn, f1, f2 = shape.meta["batch_nodes"], shape.meta["fanout1"], shape.meta["fanout2"]
        return bn + bn * f1 + bn * f1 * f2, bn * f1 + bn * f1 * f2, bn
    return shape.meta["n_nodes"], shape.meta["n_edges"], shape.meta["n_nodes"]


def build_gnn_train(arch, shape, mesh) -> LoweredCell:
    """``build_gnn_train`` (``:489-579``): ``step_fn(params, opt_state,
    batch)`` is ``gnn_train_step`` on the mesh, the parameters replicated.
    ``molecule``: the batch of graphs over the data axes.  Otherwise the
    edges padded to a multiple of the mesh size (``edge_mask`` covers the
    pads) and split over every axis, the node arrays replicated."""
    from ..configs.gat_cora import config_for_shape

    cfg = config_for_shape(shape.name)
    skeleton = _eval_shape(lambda: gnn_mod.gat_init(0, cfg, device="cpu"))
    rep = replicated(mesh)
    rules = _gnn_tree(skeleton, lambda k, v: rep)
    dp = _dp(mesh)
    if shape.name == "molecule":
        b, n, e, d = shape.meta["batch"], shape.meta["n_nodes"], shape.meta["n_edges"], shape.meta["d_feat"]
        spec = {"feats": ((b, n, d), F32), "src": ((b, e), torch.int32), "dst": ((b, e), torch.int32),
                "y": ((b,), F32)}
        batch_pl = {"feats": named(mesh, dp, None, None), "src": named(mesh, dp, None),
                    "dst": named(mesh, dp, None), "y": named(mesh, dp)}
        n_edges = b * e
    else:
        n, e, _ = gnn_sizes(shape)
        d = shape.meta["d_feat"]
        e = -(-e // mesh.size()) * mesh.size()
        e_pl = named(mesh, tuple(mesh.mesh_dim_names))
        spec = {"feats": ((n, d), F32), "src": ((e,), torch.int32), "dst": ((e,), torch.int32),
                "labels": ((n,), torch.int32), "label_mask": ((n,), F32), "edge_mask": ((e,), torch.bool)}
        batch_pl = {"feats": rep, "src": e_pl, "dst": e_pl, "labels": rep, "label_mask": rep, "edge_mask": e_pl}
        n_edges = e
    params = _gnn_tree(skeleton, lambda k, v: _arg(v.shape, v.dtype, mesh, rep))
    opt = {"m": _gnn_tree(skeleton, lambda k, v: _arg(v.shape, F32, mesh, rep)),
           "v": _gnn_tree(skeleton, lambda k, v: _arg(v.shape, F32, mesh, rep)), "step": _host()}
    batch = {k: _arg(sh, dt, mesh, batch_pl[k]) for k, (sh, dt) in spec.items()}

    def train_step(params, opt_state, batch):
        pt = tree_map(lambda t: _dt(t, mesh, rep), params)
        st = {"m": tree_map(lambda t: _dt(t, mesh, rep), opt_state["m"]),
              "v": tree_map(lambda t: _dt(t, mesh, rep), opt_state["v"]), "step": opt_state["step"]}
        bt = {k: _dt(v, mesh, batch_pl[k]) for k, v in batch.items()}
        return gnn_train_step(cfg, pt, st, bt, mesh=mesh)

    meta = {"kind": "train", "n_edges": n_edges, "param_count": sum(v.numel() for v in tree_leaves(skeleton)),
            "dtype": "float32"}
    return LoweredCell(f"{arch.name}:{shape.name}", train_step, (params, opt, batch),
                       (rules, {"m": rules, "v": rules, "step": rep}, batch_pl), meta)


def pad_edges(batch: dict, n_ranks: int) -> dict:
    """A full-graph batch with its edges padded to a multiple of
    ``n_ranks`` (node 0 to node 0, ``edge_mask`` False on the pads; the
    mask all True on the real edges when the batch has none)."""
    e = len(batch["src"])
    pad = -(-e // n_ranks) * n_ranks - e
    mask = np.asarray(batch.get("edge_mask", np.ones(e, bool)), bool)
    out = dict(batch)
    out["src"] = np.concatenate([np.asarray(batch["src"], np.int32), np.zeros(pad, np.int32)])
    out["dst"] = np.concatenate([np.asarray(batch["dst"], np.int32), np.zeros(pad, np.int32)])
    out["edge_mask"] = np.concatenate([mask, np.zeros(pad, bool)])
    return out


# -- the dispatcher -----------------------------------------------------------


def build_cell(arch, shape, mesh, variant: str = "baseline", *, device: str = "cuda") -> LoweredCell:
    """The cell of ``arch`` x ``shape`` on ``mesh`` (``:722-747``): names or
    the registry's specs (a spec with another ``make_config``, e.g. the
    reduced one, is built as given).  The cluster family goes to
    ``launch.laf_cluster`` (``variant="one_launch"``: the formation cell;
    ``device``: where its fake tensors lie); the model families' args are
    ``meta`` tensors.  A registry skip raises."""
    from ..configs.registry import get_arch
    from .laf_cluster import build_laf_cluster, build_one_launch_cluster

    arch = get_arch(arch) if isinstance(arch, str) else arch
    shape = arch.shapes[shape] if isinstance(shape, str) else shape
    if shape.name in arch.skips:
        raise ValueError(f"{arch.name}:{shape.name} is a documented skip: {arch.skips[shape.name]}")
    if arch.family == "lm":
        if shape.kind == "train":
            return build_lm_train(arch, shape, mesh)
        if shape.kind == "prefill":
            return build_lm_prefill(arch, shape, mesh)
        if shape.kind == "decode":
            return build_lm_decode(arch, shape, mesh, variant=variant)
    if arch.family == "gnn":
        return build_gnn_train(arch, shape, mesh)
    if arch.family == "recsys":
        if shape.kind == "train":
            return build_recsys_train(arch, shape, mesh)
        if shape.kind == "forward":
            return build_recsys_forward(arch, shape, mesh)
        if shape.kind == "retrieval":
            return build_recsys_retrieval(arch, shape, mesh)
    if arch.family == "cluster":
        build = build_one_launch_cluster if variant == "one_launch" else build_laf_cluster
        return build(arch, shape, mesh, device=device)
    raise KeyError(f"no builder for {arch.family}/{shape.kind}")
