"""Spawn a process group of ``world`` ranks and collect each rank's
result: the launcher of the sharded plane's tests and of the smoke's
plane phase.

``run_ranks(fn, world, *args)`` starts ``world`` processes (start method
``spawn``), each of which initialises ``torch.distributed`` through a
``FileStore`` in a fresh temporary directory (no port to collide on,
however many launchers run at once), with ``timeout=`` passed to
``init_process_group``, calls ``fn(rank, world, *args)`` and sends its
result back.  ``fn`` and ``args`` reach the children through a pickle
file in the same directory: a spawned child reads its pipe only once it
has imported what the pickle names, so a large argument sent down the
pipe would start the ranks one after another.  Every child is joined with a deadline: a rank that hangs
or dies makes the call raise, naming each failed rank with its
traceback, instead of hanging.  ``fn`` must be importable by name in a
fresh interpreter (a module-level function); keep its module free of
heavy imports, since every child imports it.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from datetime import timedelta

__all__ = ["run_ranks", "RanksFailed"]

_GRACE_S = 2.0  # how long the other ranks get to report once one rank has failed


class RanksFailed(RuntimeError):
    """One or more ranks raised, died or did not finish in time."""


def _child(call_path, rank, world, backend, store_path, timeout, threads, out):
    try:
        import torch
        import torch.distributed as dist

        if threads:
            torch.set_num_threads(threads)
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout))
        try:
            res = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:  # noqa: BLE001 - every failure goes back to the parent
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *args, backend: str = "gloo", timeout: float = 120.0, threads=None) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in its own spawned rank of one process group; raises
    :class:`RanksFailed` when a rank raises, dies or outlives
    ``timeout`` seconds (also the process group's own timeout).
    ``threads`` sets each child's ``torch.set_num_threads``."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results, errors = {}, {}
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        store, call = os.path.join(tmp, "store"), os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [ctx.Process(target=_child, args=(call, r, world, backend, store, timeout, threads, out),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) + len(errors) < world:
                now = time.monotonic()
                if now >= deadline:
                    for r in range(world):
                        if r not in results and r not in errors:
                            errors[r] = f"rank {r} did not finish within {timeout} s"
                    break
                try:
                    rank, ok, val = out.get(timeout=min(1.0, deadline - now))
                except queue.Empty:
                    for r, p in enumerate(procs):  # died without reporting (a signal, a crash)
                        if p.exitcode not in (None, 0) and r not in results and r not in errors:
                            errors[r] = f"rank {r} exited with code {p.exitcode}"
                else:
                    (results if ok else errors)[rank] = val
                if errors:
                    deadline = min(deadline, time.monotonic() + _GRACE_S)
        finally:
            for p in procs:
                p.join(timeout=max(0.0, deadline - time.monotonic()) + 1.0)
                if p.is_alive():
                    p.kill()
                    p.join()
            out.close()
    if errors:
        raise RanksFailed("\n".join(f"[rank {r}] {errors[r]}" for r in sorted(errors)))
    return [results[r] for r in range(world)]
