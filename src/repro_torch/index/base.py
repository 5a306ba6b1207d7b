"""Range-query backend protocol + registry (port of ``repro.index.base``).

Every clustering engine consumes eps-neighborhoods through three
primitives: boolean hit rows against the whole database, hit rows
against a column subset, and neighbor counts.  ``fit`` binds the data;
queries are rows of that database.  Engines accept ``backend=`` as a
registry name or a constructed instance; ``as_fitted`` normalizes both.
"""

from __future__ import annotations

import importlib
from typing import Dict, Type, Union

import numpy as np

from ..core.range_query import pack_bitmap

__all__ = ["RangeBackend", "BACKENDS", "register_backend", "make_backend", "as_fitted"]


class RangeBackend:
    """Interface + shared glue for eps-range query backends.

    Subclasses implement ``fit`` and ``query_hits``; the remaining
    primitives have correct defaults on top.  ``fit`` is idempotent on
    the same array so engines can re-enter with a shared backend.
    """

    name: str = "base"

    def fit(self, data: np.ndarray) -> "RangeBackend":
        raise NotImplementedError

    def query_hits(self, rows: np.ndarray, eps: float) -> np.ndarray:
        """Boolean (len(rows), n) adjacency of db[rows] against the db."""
        raise NotImplementedError

    def query_hits_subset(self, rows: np.ndarray, cols: np.ndarray, eps: float) -> np.ndarray:
        """Boolean (len(rows), len(cols)) adjacency against db[cols]."""
        raise NotImplementedError

    @property
    def packs_natively(self) -> bool:
        """True when the backend produces packed adjacency on the device
        without materializing the boolean hit matrix."""
        return False

    def query_hits_packed(self, rows: np.ndarray, eps: float):
        """(counts int64 (len(rows),), packed uint32 hit rows)."""
        hit = self.query_hits(rows, eps)
        return hit.sum(axis=1, dtype=np.int64), pack_bitmap(hit)

    def query_counts(self, rows: np.ndarray, eps: float) -> np.ndarray:
        """Neighbor counts |N_eps(db[i])| for i in rows (int64)."""
        raise NotImplementedError

    @property
    def n_points(self) -> int:
        return self._data.shape[0]  # type: ignore[attr-defined]


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
