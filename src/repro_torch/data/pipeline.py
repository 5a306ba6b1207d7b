"""Host data pipeline (numpy copy of ``repro.data.pipeline``: the same
batches, byte for byte, from the same seeds): deterministic seeded
generation + background prefetch, yielding device-ready global batches.

Production shape: each host generates/loads only the rows its data-shard
owns (``host_shard`` / ``n_host_shards``); a background thread keeps a
bounded queue of ready batches so step time never blocks on input.
Determinism: batch i is a pure function of (seed, i) — restarts resume
bit-identically from any step.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator

import numpy as np

__all__ = ["BatchSpecFn", "Prefetcher", "lm_batches", "ctr_batches", "clustering_batches"]

BatchSpecFn = Callable[[np.random.Generator, int], Dict[str, np.ndarray]]


class Prefetcher:
    """Bounded background prefetch over a deterministic batch function."""

    def __init__(
        self,
        make_batch: Callable[[int], Any],
        *,
        depth: int = 2,
        start_step: int = 0,
    ):
        self.make_batch = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        i = self._step
        while not self._stop.is_set():
            try:
                self._q.put((i, self.make_batch(i)), timeout=0.1)
                i += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def lm_batches(
    seed: int, batch: int, seq_len: int, vocab: int,
    *, host_shard: int = 0, n_host_shards: int = 1,
) -> Callable[[int], Dict[str, np.ndarray]]:
    """Deterministic zipf token batches; host sees its shard's rows."""
    rows = batch // n_host_shards

    def make(step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, host_shard])
        )
        z = rng.zipf(1.3, size=(rows, seq_len + 1))
        toks = np.minimum(z - 1, vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return make


def ctr_batches(
    seed: int, batch: int, vocab_sizes, *, seq_len: int = 0,
    host_shard: int = 0, n_host_shards: int = 1,
) -> Callable[[int], Dict[str, np.ndarray]]:
    rows = batch // n_host_shards
    vocab_sizes = np.asarray(vocab_sizes)

    def make(step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, host_shard]))
        out = {
            "ids": np.stack(
                [rng.integers(0, v, size=rows) for v in vocab_sizes], axis=1
            ).astype(np.int32),
            "label": rng.integers(0, 2, size=rows).astype(np.float32),
        }
        if seq_len:
            out["hist"] = rng.integers(0, vocab_sizes[0], size=(rows, seq_len)).astype(np.int32)
            out["target"] = rng.integers(0, vocab_sizes[0], size=rows).astype(np.int32)
        return out

    return make


def clustering_batches(
    data: np.ndarray, frontier_size: int, seed: int
) -> Callable[[int], Dict[str, np.ndarray]]:
    """Frontier batches for the distributed LAF cluster step."""
    n = data.shape[0]

    def make(step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        idx = rng.choice(n, size=frontier_size, replace=False)
        return {"queries": data[idx], "indices": idx.astype(np.int32)}

    return make
