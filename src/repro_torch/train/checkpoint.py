"""Atomic, checksummed, async checkpointing (port of
``repro.train.checkpoint``, without JAX).

Layout (one directory per step), the reference's byte for byte:
    <root>/tmp-step_<N>/            written + fsynced first
        manifest.json               tree paths + per-leaf dtype, shape
                                    and crc32 checksum
        shard_<i>.npz               leaf arrays (flat index -> array)
    <root>/step_<N>/                atomic rename on completion

A tree is a dict (keys in sorted order), list or tuple of numpy arrays
or tensors, nested as deep as needed; its leaves are flattened in the
order ``jax.tree_util`` flattens the same structure and their paths
written as its ``keystr`` (``['state.counts']``), so a checkpoint either
package wrote restores in the other.  Properties:

  * atomic: readers never see partial checkpoints (rename-commit); the
    temp dir carries a ``tmp-`` prefix, so no ``step_*`` glob picks it
    up, and GC removes an interrupted writer's leftovers;
  * durable: shards and the manifest are fsynced before the rename and
    the parent directory after it;
  * verified: ``restore_checkpoint`` re-checksums every leaf (``verify``)
    and raises :class:`CheckpointCorruptError` on a mismatch or a short
    read, so callers fall back to an earlier step;
  * keep-k GC that never deletes the newest complete step;
  * async: ``AsyncCheckpointer`` copies the tree to the host, then
    writes on a background thread, one write in flight.

numpy has no bfloat16: a bf16 tensor is written as its raw 16-bit words
(``uint16``) with ``bfloat16`` in the manifest, as the reference's
manifest names it, so its checksum is over the same bytes;
``restore_checkpoint`` returns such a leaf as those words, and
``to_tensor`` (what the trainer uses to load a leaf back) reads them as
bf16.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, List, Optional

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "list_steps",
    "AsyncCheckpointer",
    "gc_checkpoints",
    "CheckpointCorruptError",
    "to_tensor",
]


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed its read-back integrity check (missing or
    truncated shard, checksum mismatch, unreadable manifest)."""


def _flatten_with_paths(tree, prefix: str = ""):
    """(leaves, paths) in ``jax.tree_util``'s order and ``keystr`` form:
    dict keys sorted, ``[repr(key)]`` per dict level, ``[i]`` per
    sequence level."""
    if isinstance(tree, dict):
        leaves, paths = [], []
        for k in sorted(tree):
            sub_l, sub_p = _flatten_with_paths(tree[k], f"{prefix}[{k!r}]")
            leaves += sub_l
            paths += sub_p
        return leaves, paths
    if isinstance(tree, (list, tuple)):
        leaves, paths = [], []
        for i, x in enumerate(tree):
            sub_l, sub_p = _flatten_with_paths(x, f"{prefix}[{i}]")
            leaves += sub_l
            paths += sub_p
        return leaves, paths
    return [tree], [prefix]


def _unflatten(template, leaves):
    """``template``'s structure filled with ``leaves`` in flatten order."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(fill(x) for x in t)
        return next(it)

    return fill(template)


def _to_host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _dtype_name(x, host: np.ndarray) -> str:
    return "bfloat16" if torch.is_tensor(x) and x.dtype == torch.bfloat16 else str(host.dtype)


def to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A restored leaf as a tensor of ``like``'s dtype and device: a bf16
    leaf's 16-bit words (or an array of a 2-byte bf16 dtype) are read
    as bf16, bit for bit."""
    a = a if a.flags.c_contiguous else np.array(a)  # (np.ascontiguousarray would make a 0-d leaf 1-d)
    if like.dtype == torch.bfloat16 and a.dtype.itemsize == 2 and a.dtype.kind not in "f":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif like.dtype == torch.bfloat16 and a.dtype.itemsize == 2:  # float16 would be a conversion, not a read
        raise TypeError(f"a {a.dtype} leaf does not restore into a bfloat16 tensor")
    else:
        t = torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype)


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a))  # the array's bytes, read in place


def _crcs(arrays) -> List[int]:
    """Each array's crc32, on a few threads (``zlib.crc32`` releases the
    GIL, so the leaves of a large training state are summed in parallel)."""
    if len(arrays) < 2:
        return [_crc(a) for a in arrays]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(_crc, arrays))


def _fsync_file(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform without dir-open
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(
    root: str | Path, step: int, tree: Any, *, shard_size: int = 64, fsync: bool = True,
) -> Path:
    """Write one checkpoint atomically and durably; returns its directory.
    ``fsync=False`` skips the physical syncs (atomicity is kept)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f"tmp-step_{step:012d}"
    final = root / f"step_{step:012d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    flat, paths = _flatten_with_paths(tree)
    arrays = [_to_host(x) for x in flat]
    manifest = {
        "step": step,
        "n_leaves": len(flat),
        "paths": paths,
        "dtypes": [_dtype_name(x, a) for x, a in zip(flat, arrays)],
        "shapes": [list(a.shape) for a in arrays],
        "checksums": _crcs(arrays),
        "shards": [],
        "written_at": time.time(),
    }
    for start in range(0, len(arrays), shard_size):
        idx = list(range(start, min(start + shard_size, len(arrays))))
        fname = f"shard_{start // shard_size:06d}.npz"
        np.savez(tmp / fname, **{f"leaf_{i}": arrays[i] for i in idx})
        if fsync:
            _fsync_file(tmp / fname)
        manifest["shards"].append({"file": fname, "leaves": idx})
    mpath = tmp / "manifest.json"
    mpath.write_text(json.dumps(manifest))
    if fsync:
        _fsync_file(mpath)
        _fsync_dir(tmp)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    if fsync:
        _fsync_dir(root)  # the rename itself must survive a crash
    return final


def list_steps(root: str | Path) -> List[int]:
    """Complete checkpoint steps under ``root``, ascending.  Partial dirs
    (``tmp-`` prefixed, legacy ``.tmp`` suffixed, or without a manifest)
    never appear."""
    root = Path(root)
    if not root.exists():
        return []
    return sorted(
        int(p.name.split("_")[1])
        for p in root.iterdir()
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
        and (p / "manifest.json").exists()
    )


def latest_step(root: str | Path) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


def restore_checkpoint(root: str | Path, step: Optional[int] = None, *, template: Any = None,
                       verify: bool = True):
    """Restore a checkpoint into ``template``'s structure as numpy arrays;
    returns ``(tree, step)``.  ``verify=True`` (default) re-checksums
    every leaf against the manifest and raises
    :class:`CheckpointCorruptError` on a mismatch or a short read."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = root / f"step_{step:012d}"
    try:
        manifest = json.loads((d / "manifest.json").read_text())
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"{d}: unreadable manifest ({e})") from e
    leaves: List[Optional[np.ndarray]] = [None] * manifest["n_leaves"]
    checksums = manifest.get("checksums")  # absent on pre-durability dirs
    for shard in manifest["shards"]:
        try:
            with np.load(d / shard["file"]) as z:
                for i in shard["leaves"]:
                    leaves[i] = z[f"leaf_{i}"]
        except Exception as e:
            raise CheckpointCorruptError(
                f"{d}: shard {shard['file']} unreadable ({type(e).__name__}: {e})"
            ) from e
    if any(leaf is None for leaf in leaves):
        raise CheckpointCorruptError(f"{d}: manifest shards do not cover all leaves")
    if verify and checksums is not None:
        for i, (got, want) in enumerate(zip(_crcs(leaves), checksums)):
            if got != want:
                raise CheckpointCorruptError(
                    f"{d}: leaf {i} ({manifest['paths'][i]}) checksum mismatch "
                    f"(crc32 {got:#010x} != manifest {want:#010x})"
                )
    if template is None:
        raise ValueError("restore requires a template tree for structure")
    return _unflatten(template, leaves), step


def gc_checkpoints(root: str | Path, keep: int = 3) -> List[Path]:
    """Delete all but the newest ``keep`` complete checkpoints and any
    orphaned partial dirs; returns the deleted paths."""
    root = Path(root)
    if not root.exists():
        return []
    deleted = []
    for p in list(root.glob("tmp-step_*")) + list(root.glob("step_*.tmp")):
        shutil.rmtree(p)
        deleted.append(p)
    # a crash can leave a committed-looking dir without a manifest
    for p in root.glob("step_*"):
        if p.is_dir() and not (p / "manifest.json").exists():
            shutil.rmtree(p)
            deleted.append(p)
    complete = sorted(
        (p for p in root.iterdir() if p.is_dir() and p.name.startswith("step_")
         and (p / "manifest.json").exists()),
        key=lambda p: p.name,
    )
    for p in complete[:-keep] if keep else complete:
        shutil.rmtree(p)
        deleted.append(p)
    return deleted


class AsyncCheckpointer:
    """Single-in-flight async writer: copy to the host, write on a thread."""

    def __init__(self, root: str | Path, keep: int = 3):
        self.root = Path(root)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save(self, step: int, tree: Any):
        self.wait()  # one in flight
        flat, _ = _flatten_with_paths(tree)
        # a copy of every leaf: the caller goes on updating its tensors in place
        host_tree = _unflatten(tree, [x.detach().to("cpu", copy=True) if torch.is_tensor(x) else np.array(x)
                                      for x in flat])

        def work():
            try:
                save_checkpoint(self.root, step, host_tree)
                gc_checkpoints(self.root, self.keep)
            except Exception as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
