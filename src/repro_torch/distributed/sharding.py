"""Mesh helpers and sharding rules over a ``DeviceMesh`` (port of
``repro.distributed.sharding``).

``axis_size`` and ``data_axes`` read only a mesh's ``mesh_dim_names``
and ``shape``, as the reference reads a JAX mesh's ``axis_names`` and
``shape``.  ``plane_axes`` resolves a tuple of axes to the process group
that spans them and to this rank's shard index: the flattened index over
those axes, major axis first, which is the order in which the reference's
``P(axes)`` concatenates shards.

The rules give DTensor placements, one per mesh dimension, where the
reference gives a ``NamedSharding``.  Every rule writes a
PartitionSpec-like tuple (an entry per tensor dimension: ``None``, an
axis name, or a tuple of names, major first) and turns it into
placements through :func:`spec_to_placements`: an axis that names
tensor dimension ``i`` becomes ``Shard(i)`` on that mesh dimension, the
others ``Replicate()``.  A tuple entry such as ``("pod", "data")`` is
``Shard(i)`` on both, which DTensor splits in mesh order, major first,
as the reference concatenates.  The rules read only ``mesh_dim_names``
and ``shape``, so a full-size rule needs no process group (a stand-in
with those two attributes will do).

Default parameter rule (FSDP x TP), as the reference's: the last
dimension over ``"model"`` when it divides (and the tensor has two or
more dimensions), the second-to-last over the data axes when it
divides; everything else replicated.

A gloo process group takes every collective DTensor issues on CUDA
tensors but its functional all-gather, which kills the process
(``scripts/dtensor_collectives_check.py``, on the card).
:func:`stage_gloo_collectives` routes that one through
:func:`staged_collective`, an all-gather into a list that gloo takes on
the card, and counts its calls (``sharded.staged.all_gather.calls``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = [
    "axis_size", "data_axes", "PlaneAxes", "plane_axes", "spec_to_placements", "named", "replicated",
    "param_sharding_rule", "tree_param_shardings", "tree_replicated", "staged_collective", "stage_gloo_collectives",
    "is_dtensor", "mesh_coordinate",
]


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = _sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    return math.prod(sizes[a] for a in axes)


def data_axes(mesh) -> tuple:
    """The mesh axes that carry data parallelism: ``("pod", "data")`` when
    the mesh has a ``pod`` axis, else ``("data",)``."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


@dataclass(frozen=True)
class PlaneAxes:
    """This rank's view of the mesh axes a database is sharded over.

    ``group`` spans the ranks that share this rank's coordinates on every
    other axis (None when ``size`` is 1: nothing crosses ranks); ``index``
    is this rank's shard index among them and ``order[k]`` the group rank
    of shard k, the order in which a gather concatenates."""

    size: int
    index: int
    group: Optional[object]
    order: Tuple[int, ...]


# (id(mesh), axes) -> (mesh, PlaneAxes); the mesh is kept so its id
# cannot be reused by another mesh while the entry lives
_CACHE: Dict[tuple, tuple] = {}


def plane_axes(mesh, axes=None) -> PlaneAxes:
    """Resolve ``axes`` (default: ``data_axes(mesh)``) on a ``DeviceMesh``.

    A single axis takes the mesh's own group.  Several axes take a group
    made with ``new_group`` for every set of ranks that differs only on
    those axes, so every rank of the mesh must make the first call for a
    given (mesh, axes) at the same point of its program, as for any
    collective.  Cached per (mesh, axes)."""
    import torch.distributed as dist

    axes = data_axes(mesh) if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))
    key = (id(mesh), axes)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit[1]
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    others = [i for i in range(len(names)) if i not in dims]
    size = axis_size(mesh, axes)
    rows = mesh.mesh.permute(*others, *dims).reshape(-1, size).tolist()
    me = dist.get_rank()
    mine = next(r for r in rows if me in r)
    if size == 1:
        group = None
    elif len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        group = None
        for r in rows:  # every rank makes every group, in the same order
            g = dist.new_group(r)
            if r is mine:
                group = g
    order = tuple(dist.get_group_rank(group, r) for r in mine) if group is not None else (0,)
    out = PlaneAxes(size, mine.index(me), group, order)
    _CACHE[key] = (mesh, out)
    return out


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor's module)."""
    return hasattr(x, "device_mesh") and hasattr(x, "placements")


def mesh_coordinate(mesh, axis: str) -> int:
    """This rank's index on the mesh axis ``axis``."""
    return int(mesh.get_local_rank(list(mesh.mesh_dim_names).index(axis)))


# ---------------------------------------------------------------------------
# the rules: PartitionSpec-like tuples -> DTensor placements
# ---------------------------------------------------------------------------


def spec_to_placements(mesh, spec) -> tuple:
    """A PartitionSpec-like tuple -> one DTensor placement per mesh
    dimension (``Shard(i)`` where an entry for tensor dimension ``i``
    names the axis, else ``Replicate()``).  A tuple entry must list its
    axes in the mesh's order (DTensor splits major first in that order);
    an axis may shard one tensor dimension only."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in ((entry,) if isinstance(entry, str) else entry)]
        if idx != sorted(idx):
            raise ValueError(f"axes {entry} are not in the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dimensions of {spec}")
            out[i] = Shard(dim)
    return tuple(out)


def named(mesh, *spec) -> tuple:
    return spec_to_placements(mesh, spec)


def replicated(mesh) -> tuple:
    return spec_to_placements(mesh, ())


def param_spec(mesh, shape) -> tuple:
    """The default FSDP x TP rule's PartitionSpec-like tuple."""
    ndim = len(shape)
    spec: list = [None] * ndim
    dp = data_axes(mesh)
    model = axis_size(mesh, "model")
    if ndim >= 2 and shape[-1] % model == 0 and shape[-1] >= model:  # 1-D tensors stay replicated
        spec[-1] = "model"
    if ndim >= 2:
        dp_size = axis_size(mesh, dp)
        if shape[-2] % dp_size == 0 and shape[-2] >= dp_size:
            spec[-2] = dp if len(dp) > 1 else dp[0]
    return tuple(spec)


def param_sharding_rule(mesh, shape) -> tuple:
    """The default FSDP x TP rule described in the module docstring."""
    return spec_to_placements(mesh, param_spec(mesh, shape))


def tree_param_shardings(mesh, tree):
    """The rule over a tree of tensors (``train.optimizer.tree_map``'s
    trees: a module's ``param_tree``, nested dicts and lists)."""
    from ..train.optimizer import tree_map

    return tree_map(lambda leaf: param_sharding_rule(mesh, tuple(leaf.shape)), tree)


def tree_replicated(mesh, tree):
    from ..train.optimizer import tree_map

    return tree_map(lambda _: replicated(mesh), tree)


# ---------------------------------------------------------------------------
# DTensor's collectives on gloo with CUDA tensors
# ---------------------------------------------------------------------------

_STAGED: Dict[str, object] = {}  # device type -> the torch.library.Library holding the registration


def staged_collective(x, group_name: str):
    """DTensor's functional all-gather on dim 0 through the collective
    that gloo takes on CUDA tensors: an all-gather into a list, then a
    concatenation.  Counted as ``sharded.staged.all_gather.calls`` and
    ``.bytes`` (the bytes this rank sends)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    from ..obs import metrics

    pg = _resolve_process_group(group_name)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(pg))]
    dist.all_gather(parts, x, group=pg)
    metrics.counter("sharded.staged.all_gather.calls").inc()
    metrics.counter("sharded.staged.all_gather.bytes").inc(x.numel() * x.element_size())
    return torch.cat(parts, 0)


def stage_gloo_collectives(device_type: str = "cuda") -> None:
    """Route DTensor's functional all-gather
    (``_c10d_functional.all_gather_into_tensor``) on ``device_type``
    tensors through :func:`staged_collective`, in this process, once.
    On the card a gloo group takes every other collective DTensor issues
    (all-reduce, reduce-scatter, all-to-all), and the functional
    all-gather kills the process (``scripts/dtensor_collectives_check.py``).
    For a process whose only process group is gloo (a rank of the
    smoke's gloo worlds, which share one card): the registration
    replaces the operator's kernel for every group of the process."""
    if device_type in _STAGED:
        return
    import torch

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", lambda x, group_size, group_name: staged_collective(x, group_name),
             device_type.upper())
    _STAGED[device_type] = lib
