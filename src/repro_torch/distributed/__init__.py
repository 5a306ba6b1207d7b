"""``repro_torch.distributed`` — sharding on ``torch.distributed``
(port of ``repro.distributed``): the mesh helpers and the parameter
rules as DTensor placements (``sharding``), and LAF-DBSCAN's sharded
index plane (``index_plane``).

A ``torch.distributed.device_mesh.DeviceMesh`` plays the part of JAX's
``Mesh``: named axes, their sizes, one process group per axis.  The LM's
own rules and its sharded steps are in ``launch.steps``.
"""

from .sharding import (  # noqa: F401
    PlaneAxes, axis_size, data_axes, named, param_sharding_rule, plane_axes, replicated, spec_to_placements,
    stage_gloo_collectives, staged_collective, tree_param_shardings, tree_replicated,
)
