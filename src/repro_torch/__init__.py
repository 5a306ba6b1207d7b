"""``repro_torch`` — the LAF-DBSCAN system and its model zoo on PyTorch
and CUDA.

A second package beside the JAX/Pallas reference (``repro``), with the
same layout (``core/``, ``core/cardinality/``, ``index/``,
``kernels/<name>/``, ``data/``, ``obs/``, ``models/``, ``configs/``,
``distributed/``) so each module's counterpart is found under the same
path.  The TPU
kernels are hand-written CUDA C++ for Hopper (``csrc/*.cu``), built by
``nvcc`` at first use into ``build/repro_torch/`` and bound with
``ctypes`` (``repro_torch.kernels._build``).

Device policy: every entry point takes ``device=``.  ``None`` (the
default) means ``cuda`` and raises when no card is present;
``device="cpu"`` is the explicit opt-in to the CPU, where every kernel
wrapper runs its plain PyTorch version.  Nothing falls back on its own.  Importing the package root imports no
torch (``python -m repro_torch.analysis --list-checks`` stays light).
"""

from __future__ import annotations

__all__ = ["resolve_device", "exact_fp32"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    passes ``device="cpu"`` (or a ``torch.device``); ``"meta"`` holds
    shapes only (a dry run's trace).  Raises when a CUDA device is asked
    for (explicitly or by default) and none is present."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def exact_fp32() -> None:
    """Disable TF32 for fp32 products on the card.

    The band predicate (``index.signatures.band_hits``) compares fp32
    dot products against ``1 - eps``, and the sign signatures and the
    training counts threshold fp32 products too; TF32 keeps ~10 mantissa
    bits and would move pairs across those thresholds.  Every function
    whose product decides a hit calls this first.
    """
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
