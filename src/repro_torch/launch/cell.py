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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence, Tuple

__all__ = ["LoweredCell", "placements"]


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
