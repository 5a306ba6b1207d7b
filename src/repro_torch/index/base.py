"""Range-query backend protocol + registry (port of ``repro.index.base``).

Every clustering engine consumes eps-neighborhoods through three
primitives: boolean hit rows against the whole database, hit rows
against a column subset, and neighbor counts.  ``fit`` binds the data;
queries are rows of that database.  Engines accept ``backend=`` as a
registry name or a constructed instance; ``as_fitted`` normalizes both.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Type, Union

import numpy as np
import torch

from ..core.range_query import pack_bitmap

__all__ = ["RangeBackend", "BACKENDS", "register_backend", "make_backend", "as_fitted"]


class RangeBackend:
    """Interface + shared glue for eps-range query backends.

    Subclasses implement ``fit`` and ``query_hits``; the remaining
    primitives have correct defaults on top.  ``fit`` is idempotent on
    the same array so engines can re-enter with a shared backend.
    """

    name: str = "base"
    device: torch.device = torch.device("cpu")  # the port's backends set their own

    def fit(self, data: np.ndarray) -> "RangeBackend":
        raise NotImplementedError

    def partial_fit(self, rows: np.ndarray) -> "RangeBackend":
        """Append ``rows`` to the fitted database (streaming ingest).

        Appended rows take indices ``n_before .. n_after - 1``; existing
        indices never move, the invariant the streaming cluster state
        builds on.  On an unfitted backend it is ``fit``."""
        raise NotImplementedError(f"{self.name!r} backend does not append")

    def query_hits(self, rows: np.ndarray, eps: float) -> np.ndarray:
        """Boolean (len(rows), n) adjacency of db[rows] against the db."""
        raise NotImplementedError

    def query_hits_subset(self, rows: np.ndarray, cols: np.ndarray, eps: float) -> np.ndarray:
        """Boolean (len(rows), len(cols)) adjacency against db[cols]."""
        return self.query_hits(rows, eps)[:, cols]

    @property
    def packs_natively(self) -> bool:
        """True when the backend produces packed adjacency on the device
        without materializing the boolean hit matrix."""
        return False

    def query_hits_packed(self, rows: np.ndarray, eps: float):
        """(counts int64 (len(rows),), packed uint32 hit rows)."""
        hit = self.query_hits(rows, eps)
        return hit.sum(axis=1, dtype=np.int64), pack_bitmap(hit)

    def query_packed_device(self, rows: np.ndarray, eps: float) -> torch.Tensor:
        """Packed hit rows as an int32 tensor (len(rows), ceil(n/32)) on
        ``device``, the input of the device cluster pass.  The default
        uploads ``query_hits_packed``'s words; a backend whose words are
        made on the device hands them over without a host copy."""
        words = self.query_hits_packed(rows, eps)[1]
        return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(self.device)

    def query_counts(self, rows: np.ndarray, eps: float) -> np.ndarray:
        """Neighbor counts |N_eps(db[i])| for i in rows (int64), chunked
        over rows so the hit matrix never exceeds (block, n)."""
        rows = np.asarray(rows)
        block = getattr(self, "block_size", 2048)
        counts = np.zeros(len(rows), dtype=np.int64)
        for start in range(0, len(rows), block):
            sub = rows[start : start + block]
            counts[start : start + len(sub)] = self.query_hits(sub, eps).sum(axis=1)
        return counts

    def state_export(self) -> Dict[str, np.ndarray]:
        """Snapshot the fitted state as a flat dict of host arrays,
        capacity-faithful: the doubling buffers whole (append slack
        included) and the live row count, in the reference's keys and
        dtypes, so a snapshot restores in either package."""
        raise NotImplementedError(f"{self.name!r} backend does not export state")

    def state_import(self, state: Dict[str, np.ndarray]) -> "RangeBackend":
        """Rebuild fitted state from a ``state_export`` dict; returns self."""
        raise NotImplementedError(f"{self.name!r} backend does not import state")

    def neighbor_lists(self, eps: float, block_size: int = 2048) -> List[np.ndarray]:
        """Per-point sorted neighbor index arrays for the whole database."""
        n = self.n_points
        out: List[np.ndarray] = []
        for start in range(0, n, block_size):
            hit = self.query_hits(np.arange(start, min(start + block_size, n)), eps)
            out.extend(np.nonzero(row)[0] for row in hit)
        return out

    @property
    def n_points(self) -> int:
        return self._data.shape[0]  # type: ignore[attr-defined]

    @property
    def data(self) -> np.ndarray:
        """The fitted database rows (row i is query row i)."""
        assert getattr(self, "_data", None) is not None, "call fit() first"
        return self._data  # type: ignore[attr-defined]

    @property
    def data_device(self) -> torch.Tensor:
        """The fitted rows as a float32 tensor on ``device``.  The
        default uploads ``data`` on every call; the port's backends
        return the copy they keep resident."""
        return torch.from_numpy(np.ascontiguousarray(self.data, dtype=np.float32)).to(self.device)


BACKENDS: Dict[str, Type[RangeBackend]] = {}


def register_backend(cls: Type[RangeBackend]) -> Type[RangeBackend]:
    BACKENDS[cls.name] = cls
    return cls


def make_backend(spec: Union[str, RangeBackend], **kwargs) -> RangeBackend:
    """Normalize a backend spec (registry name or instance) to an instance."""
    if isinstance(spec, RangeBackend):
        return spec
    if spec not in BACKENDS:
        # backends register on import; pull in the sibling module named
        # after the backend before giving up
        mod_name = f"{__package__}.{spec}"
        try:
            importlib.import_module(mod_name)
        except ModuleNotFoundError as e:
            if e.name != mod_name:
                raise
    if spec not in BACKENDS:
        raise ValueError(f"unknown range backend {spec!r}; registered backends: {sorted(BACKENDS)}")
    return BACKENDS[spec](**kwargs)


def as_fitted(spec: Union[str, RangeBackend], data: np.ndarray, **kwargs) -> RangeBackend:
    """Backend instance bound to ``data`` (no-op refit on the same array);
    ``kwargs`` configure construction when ``spec`` is a registry name."""
    return make_backend(spec, **kwargs).fit(data)
