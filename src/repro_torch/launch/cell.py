"""The launch layer's unit of work: one (arch × shape × mesh) cell,
lowered (port of ``repro.launch.cell``).

A JAX cell is a function, abstract arguments and shardings that
``jax.jit`` lowers.  A PyTorch cell is a function every rank calls on
its own blocks: ``args`` are one rank's arguments as fake tensors (or
``meta`` tensors) at their real shapes and dtypes, on the device the
cell runs on, and ``placements`` says, for each argument, how the global
tensor is split over the mesh: a tuple of DTensor placements, one per
mesh dimension (``Shard(0)`` on every axis of a database sharded over
the whole mesh, ``Replicate()`` for the queries and the estimator).  A
tensor sharded over several mesh dimensions is split major axis first,
as the sharded index plane's ``ShardPlan`` splits it; the cells keep
their plans in ``meta``.  ``meta`` carries the reference's keys
(``kind``, ``n_points``, ``dim``, ``frontier``, ``cap``,
``index_axes``, ``n_shards``, ...).

The model families' cells (``launch.steps.build_cell``) take trees:
``args`` and ``placements`` are nested dicts, lists and tuples of the
same structure, a leaf of ``placements`` the tuple of one tensor's
placements.  Their ``args`` are ``meta`` tensors; :func:`shard_args`
cuts each rank's real shards from whole tensors of the same tree.  A
0-d CPU leaf is a host value (a step count, a decode position) and is
passed as it is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence, Tuple

__all__ = ["LoweredCell", "placements", "shard_args", "map_args", "global_shape"]


@dataclass
class LoweredCell:
    name: str
    step_fn: Callable
    args: Tuple
    placements: Tuple
    meta: Dict[str, Any]


def placements(mesh, axes: Sequence[str] = (), dim: int = 0) -> tuple:
    """DTensor placements of a tensor whose dimension ``dim`` is split
    over the mesh axes ``axes`` and replicated over the others."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dim) if a in axes else Replicate() for a in mesh.mesh_dim_names)


def _is_placements(x) -> bool:
    from torch.distributed.tensor.placement_types import Placement

    return isinstance(x, tuple) and len(x) > 0 and all(isinstance(p, Placement) for p in x)


def map_args(fn, args, pl):
    """``fn(leaf, placements)`` over a cell's ``args`` tree and its
    ``placements`` tree, the structure kept."""
    if _is_placements(pl):
        return fn(args, pl)
    if isinstance(args, dict):
        return {k: map_args(fn, v, pl[k]) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        return type(args)(map_args(fn, a, p) for a, p in zip(args, pl))
    raise TypeError(f"no placements for a {type(args).__name__} leaf")


def global_shape(local_shape, mesh, pl) -> tuple:
    """The global shape of a shard ``local_shape`` split by ``pl`` (an
    even split)."""
    shape = list(local_shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            shape[p.dim] *= mesh.size(i)
    return tuple(shape)


def shard_args(cell: LoweredCell, mesh, full_args, device=None):
    """This rank's arguments for ``cell.step_fn``: each whole tensor of
    ``full_args`` (the tree of ``cell.args``, at the global shapes) cut
    to its shard on ``mesh`` (no collective) on ``device`` (the whole
    tensor's own device when None); host values as they are."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    def cut(x, pl):
        x = torch.as_tensor(x)
        if x.dim() == 0 and x.device.type == "cpu":
            return x
        x = x.to(device) if device is not None else x
        return distribute_tensor(x, mesh, pl, src_data_rank=None).to_local()

    return map_args(cut, full_args, cell.placements)
