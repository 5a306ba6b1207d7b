"""Build and load the port's CUDA C++ kernels.

Each ``src/repro_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into a shared library, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries
go to ``build/repro_torch/`` at the repository root, named by a hash of
the source and the flags, and are built at first use; ``build_all``
starts one ``nvcc`` per source in parallel.  Nothing here runs at
import time.

Every ``nvcc`` run adds one to ``kernel.builds`` and to ``BUILDS[<name>-
<hash>]``: a library is built once per source hash and process (a later
``load`` of the same hash finds the file), which laf-lint's LAF105
holds (``repro_torch.analysis.probe_checks``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

from ..obs import metrics as _metrics

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "BUILDS", "load", "build_all", "check"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("hamming_filter", "label_prop", "range_count", "rmi_mlp", "flash_attention", "embedding_bag", "popcount",
           "flash_attention_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "hamming_filter": {
        "hamming_filter_launch": [P, P, P, P, I, I, I, I, F, I, I, P, P, I, I, P, I, P],
    },
    "label_prop": {
        "label_prop_rect_launch": [P, P, P, I, I, P, P, P],
        "col_reduce_launch": [P, P, P, I, I, P, P, P],
        "label_prop_update_launch": [P, P, P, I, P, P, I, P, I, P],
        "label_prop_fixpoint_launch": [P, I, I, I, P, P, P, P, I, P, I, P, I, P],
        "packed_connectivity_launch": [P, I, I, I, P, P, P, P, P, P, P, P, P, P, I, P, P],
        "packed_connectivity_grid": [I, I, P],
    },
    "range_count": {
        "range_count_launch": [P, P, I, I, I, F, P, P, I, I, P],
    },
    "rmi_mlp": {
        "rmi_mlp_launch": [P, I, I, I, *[P] * 10, I, I, I, I, I, P, P],
    },
    "flash_attention": {
        "flash_attention_launch": [P, P, P, P, I, *[I] * 7, *[L] * 9, I, I, I, F, I, I, P, P, P, P],
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_launch": [*[P] * 11, I, *[I] * 7, I, I, I, F, P],
    },
    "embedding_bag": {
        "embedding_bag_launch": [P, P, P, I, I, I, I, I, I, P],
    },
    "popcount": {
        "row_popcount_launch": [P, I, I, P, P, P, P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}
BUILDS: Dict[str, int] = {}  # library file stem (<name>-<hash>) -> nvcc runs in this process


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    BUILDS[out.stem] = BUILDS.get(out.stem, 0) + 1
    _metrics.counter("kernel.builds").inc()
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all at once."""
    names = list(names)
    jobs = {n: _start(n) for n in names}
    for n in names:
        _finish(n, jobs[n])
    return {n: _target(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError {err}")
