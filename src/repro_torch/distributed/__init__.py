"""``repro_torch.distributed`` — the sharded index plane on
``torch.distributed`` (port of ``repro.distributed``): the mesh helpers
(``sharding``) and LAF-DBSCAN's plane (``index_plane``).

A ``torch.distributed.device_mesh.DeviceMesh`` plays the part of JAX's
``Mesh``: named axes, their sizes, one process group per axis.  The
parameter rules of the reference's ``sharding`` (``param_sharding_rule``,
``tree_param_shardings``) belong to the LM and GNN sharding, not here.
"""

from .sharding import PlaneAxes, axis_size, data_axes, plane_axes  # noqa: F401
