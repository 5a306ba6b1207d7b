"""Optimizers (port of ``repro.train.optimizer``): the reference's
optax-style pairs on trees of tensors.

An optimizer is a pair of functions:
    init(params)                  -> opt_state
    update(grads, state, params)  -> (updates, new_state)
with ``apply_updates(params, updates)`` adding them in.  Adam and AdamW
also carry ``apply(grads, state, params) -> new_state``: the same update
added into each parameter as soon as its leaf is computed, over blocks of
rows, so that no tree of fp32 updates (4 bytes a parameter) and no
whole-leaf fp32 copy is held; it equals ``update`` + ``apply_updates``
bit for bit.  A tree is a
dict, list or tuple of tensors nested as deep as needed, flattened as
``jax.tree_util`` flattens the same structure (dict keys sorted), so a
state written by either package's checkpoint restores in the other;
``param_tree(module)`` gives a module's parameters as such a tree (a
flat dict by parameter name).

Where the port differs in form, not in value:

* updates run in place under ``torch.no_grad()``: ``update`` writes the
  new moments into the state's own tensors (and returns the same state
  dict with a new ``step``), ``apply_updates`` adds into the parameters,
  ``clip_by_global_norm`` scales the gradient leaves themselves;
* ``step`` is a 0-d int32 tensor on the host (the schedules read it
  there, so a step costs no device sync), the moments live with their
  parameters.

The state trees keep the reference's keys and order (``{"m", "v",
"step"}``, ``{"mu", "step"}``); weight decay applies to every leaf, as
in the reference; the update math is fp32 and the state has
``state_dtype``.

DTensor leaves (a sharded step's parameters, gradients and moments,
each gradient, ``m`` and ``v`` with its parameter's placements): the
updates are elementwise, so Adam's ``apply`` runs on each rank's local
shards (``to_local()``, views of the DTensors' storage); ``global_norm``
sums each leaf's local squares on the ranks at coordinate 0 of every
mesh axis the leaf is replicated over (each element counted once), then
crosses ranks in one all-reduce.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

__all__ = [
    "Optimizer", "sgd", "adam", "adamw", "adamw_update_params", "clip_by_global_norm", "global_norm",
    "apply_updates", "chain_clip", "tree_leaves", "tree_map", "param_tree", "row_blocks", "CHUNK_BYTES",
]

PyTree = Any
F32 = torch.float32


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util``'s order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, called in ``tree_leaves``' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree))
    return fn(tree, *rest)


def param_tree(module: nn.Module) -> dict:
    """A module's parameters as a tree: ``{name: parameter}``, the same
    tensors (an in-place update of the tree updates the module)."""
    return dict(module.named_parameters())


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[..., Tuple[PyTree, PyTree]]
    apply: Optional[Callable[..., PyTree]] = None  # update + apply_updates in place, leaf by leaf


CHUNK_BYTES = 256 * 2**20  # a leaf's fp32 working set in the fused updates: blocks of rows up to this


def row_blocks(x: torch.Tensor, threshold_bytes: int = CHUNK_BYTES) -> list:
    """``x`` as views of blocks of rows (``x.view(-1, x.shape[-1])``: an
    update written into a block is written into ``x``), each at most
    ``threshold_bytes`` as fp32 and at least one row; ``[x]`` when the
    whole leaf is under it (or is a scalar).  The AdamW math is
    elementwise, so updating the blocks one by one equals updating the
    leaf."""
    if x.dim() == 0 or x.numel() * 4 <= threshold_bytes:
        return [x]
    rows = x.view(-1, x.shape[-1])
    per = max(1, threshold_bytes // (4 * x.shape[-1]))
    return list(torch.split(rows, per))


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: torch.tensor(lr, dtype=F32))


def _scalar(x) -> float:
    """A 0-d fp32 value as a Python float (exact: fp32 values are doubles)."""
    return float(torch.as_tensor(x, dtype=F32))


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


@torch.no_grad()
def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    """``params += updates`` in place, each update cast to its
    parameter's dtype first (as the reference's ``p + u.astype(p.dtype)``);
    returns ``params``."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        if u is not None:
            p.add_(u.to(p.dtype))
    return params


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view of its storage); a tensor itself."""
    return x.to_local() if hasattr(x, "device_mesh") else x


def _counted_here(x) -> bool:
    """Whether this rank adds a DTensor leaf's local squares to the norm:
    at coordinate 0 of each mesh axis the leaf is replicated over."""
    if any(p.is_partial() for p in x.placements):
        raise ValueError("a gradient with a Partial placement: redistribute it to its parameter's first")
    mesh = x.device_mesh
    return all(mesh.get_local_rank(i) == 0 for i, p in enumerate(x.placements) if p.is_replicate())


@torch.no_grad()
def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt(sum over leaves of sum(x^2)), in fp32 (a 0-d tensor on the leaves' device);
    one fp32 copy of a leaf at a time, squared in place.  On DTensor
    leaves each element is counted once and the sum crosses ranks in one
    all-reduce (the module docstring)."""
    total, mesh = None, None
    for x in tree_leaves(tree):
        if hasattr(x, "device_mesh"):
            mesh = x.device_mesh
            if not _counted_here(x):
                continue
        sq = torch.sum(_local(x).to(F32, copy=True).square_())
        total = sq if total is None else total + sq
    if mesh is not None:
        import torch.distributed as dist

        if mesh.size() != dist.get_world_size():
            raise ValueError("a sharded global norm takes a mesh over every rank of the process group")
        total = torch.zeros((), dtype=F32, device=mesh.device_type) if total is None else total
        dist.all_reduce(total)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(tree: PyTree, max_norm: float) -> Tuple[PyTree, torch.Tensor]:
    """Scale the leaves by min(1, max_norm / max(norm, 1e-12)) in place;
    returns (the same tree, the norm before scaling).  A bf16 leaf is
    rounded to bf16 after the scaling (the reference's clipped bf16
    leaves come out fp32)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    leaves = [_local(x) for x in tree_leaves(tree)]
    if leaves:
        torch._foreach_mul_(leaves, scale)
    return tree, norm


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=F32), params), "step": _step0()}

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        mus = tree_leaves(state["mu"])
        for m, g in zip(mus, tree_leaves(grads)):
            m.mul_(momentum).add_(g.to(F32))
        lr_t = _scalar(lr_fn(step))
        updates = tree_map(lambda m: m * -lr_t, state["mu"])
        return updates, {"mu": state["mu"], "step": step}

    return Optimizer(init, update)


class _Adam:
    """The reference's ``_adam_core`` arithmetic on one leaf, in fp32 and
    in its order: m1 = b1 m + (1 - b1) g, v1 = b2 v + (1 - b2) g^2 (both
    stored in the state dtype and read back), u = (-lr (m1 / b1t)) /
    (sqrt(v1 / b2t) + eps) - (lr wd) p."""

    def __init__(self, step, lr_fn, b1, b2, eps, weight_decay):
        sf = step.to(F32)
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.b1t = _scalar(1.0 - torch.tensor(b1, dtype=F32) ** sf)
        self.b2t = _scalar(1.0 - torch.tensor(b2, dtype=F32) ** sf)
        lr_t = torch.as_tensor(lr_fn(step), dtype=F32)
        self.lr = _scalar(lr_t)
        self.lr_wd = _scalar(lr_t * weight_decay) if weight_decay else 0.0

    def moments(self, g, m, v):
        """m, v updated in place; returns their fp32 values as stored."""
        gf = g.to(F32)
        if m.dtype == F32:
            m.mul_(self.b1).add_(gf, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(gf, gf, value=1 - self.b2)
            return m, v
        m.copy_(m.to(F32).mul_(self.b1).add_(gf, alpha=1 - self.b1))
        v.copy_(v.to(F32).mul_(self.b2).addcmul_(gf, gf, value=1 - self.b2))
        return m.to(F32), v.to(F32)

    def step_of(self, mf, vf, p):
        u = (mf / self.b1t).mul_(-self.lr).div_(torch.sqrt(vf / self.b2t).add_(self.eps))
        if self.wd and p is not None:
            u.sub_(p.to(F32), alpha=self.lr_wd)
        return u


def _adam_core(lr, b1, b2, eps, weight_decay, state_dtype=F32) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=state_dtype)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": _step0()}

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        a = _Adam(step, lr_fn, b1, b2, eps, weight_decay)
        ms, vs, gs = tree_leaves(state["m"]), tree_leaves(state["v"]), tree_leaves(grads)
        ps = tree_leaves(params) if (weight_decay and params is not None) else [None] * len(ms)
        us = []
        for g, m, v, p in zip(gs, ms, vs, ps):
            us.append(a.step_of(*a.moments(g, m, v), p))
        it = iter(us)
        updates = tree_map(lambda _: next(it), state["m"])
        return updates, {"m": state["m"], "v": state["v"], "step": step}

    @torch.no_grad()
    def apply(grads, state, params):
        step = state["step"] + 1
        a = _Adam(step, lr_fn, b1, b2, eps, weight_decay)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]),
                              tree_leaves(params)):
            if hasattr(p, "device_mesh") and not (g.placements == m.placements == v.placements == p.placements):
                raise ValueError("a gradient or moment laid out otherwise than its parameter")
            g, m, v, p = (_local(x) for x in (g, m, v, p))  # one placement: the update runs on the local shards
            for gb, mb, vb, pb in zip(*(row_blocks(x, CHUNK_BYTES) for x in (g.contiguous(), m, v, p))):
                u = a.step_of(*a.moments(gb, mb, vb), pb if weight_decay else None)
                pb.add_(u.to(pb.dtype))  # apply_updates' rounding: u cast to the parameter's dtype, then added
        return {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer(init, update, apply)


def adam(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay=0.0)


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, state_dtype=F32) -> Optimizer:
    """``state_dtype=torch.bfloat16`` halves the optimizer state (the
    100B+-scale trade); the update math stays fp32."""
    return _adam_core(lr, b1, b2, eps, weight_decay=weight_decay, state_dtype=state_dtype)


@torch.no_grad()
def adamw_update_params(params: PyTree, grads: PyTree, state: PyTree, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                        weight_decay=0.1, chunk_threshold_bytes: int = CHUNK_BYTES):
    """Fused AdamW: each parameter and its m and v updated in one pass,
    in place, with the fp32 update math run over blocks of rows of a leaf
    larger than ``chunk_threshold_bytes`` (fp32; ``row_blocks``), as the
    reference's ``lax.map`` over slices: the fp32 working set is one
    block.  Returns (params, new state); equals ``adamw``'s update +
    ``apply_updates`` but that the parameter is added in fp32 and rounded
    once (the reference's ``(p + u).astype(p.dtype)``).  The state keeps
    its own dtype (the reference's ``state_dtype`` argument: here the
    state's tensors carry it)."""
    lr_fn = _lr_fn(lr)
    step = state["step"] + 1
    a = _Adam(step, lr_fn, b1, b2, eps, weight_decay)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"])):
        for pb, gb, mb, vb in zip(*(row_blocks(x, chunk_threshold_bytes) for x in (p, g.contiguous(), m, v))):
            u = a.step_of(*a.moments(gb, mb, vb), pb)
            pb.copy_((pb.to(F32) + u).to(pb.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}


def chain_clip(optimizer: Optimizer, max_norm: float) -> Optimizer:
    """Wrap an optimizer with global-norm gradient clipping."""

    def update(grads, state, params=None):
        clipped, _ = clip_by_global_norm(grads, max_norm)
        return optimizer.update(clipped, state, params)

    return Optimizer(optimizer.init, update)
