"""Production mesh factory (port of ``repro.launch.mesh``).

Single pod: (data=16, model=16), 256 ranks.  Multi-pod: (pod=2, data=16,
model=16), 512 ranks; the ``pod`` axis is pure data parallelism.

Functions, not module constants: importing this module touches no
process group.  Each call needs ``torch.distributed`` initialised with a
world of exactly the mesh's size: the real ranks, or the fake process
group the dry run brings up (``repro_torch.launch.dryrun``), where the
mesh is a ``"cuda"`` mesh as on the card (no card is touched: every
rank is this process's rank 0), so that DTensor issues the collectives
it issues there (on a ``"cpu"`` mesh it replaces an all-to-all by an
all-gather and a chunk).
"""

from __future__ import annotations

__all__ = ["make_production_mesh", "make_test_mesh", "mesh_device_type"]


def mesh_device_type() -> str:
    """``"cuda"`` on a machine with a card and a real NCCL group, and
    under the fake group; ``"cpu"`` otherwise (a gloo group)."""
    import torch
    import torch.distributed as dist

    backend = dist.get_backend()
    return "cuda" if backend == "fake" or (torch.cuda.is_available() and backend == "nccl") else "cpu"


def _mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_test_mesh(n_devices: int = 8):
    """Small mesh for sharding tests: (n // 4, 4) over ("data", "model")."""
    return _mesh((n_devices // 4, 4), ("data", "model"))
