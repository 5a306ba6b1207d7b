"""Mesh helpers over a ``DeviceMesh`` (port of the mesh half of
``repro.distributed.sharding``).

``axis_size`` and ``data_axes`` read only a mesh's ``mesh_dim_names``
and ``shape``, as the reference reads a JAX mesh's ``axis_names`` and
``shape``.  ``plane_axes`` resolves a tuple of axes to the process group
that spans them and to this rank's shard index: the flattened index over
those axes, major axis first, which is the order in which the reference's
``P(axes)`` concatenates shards.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["axis_size", "data_axes", "PlaneAxes", "plane_axes"]


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
