"""Exact range backend (port of ``repro.index.exact``): the thresholded
fp32 product ``<q, x> > 1 - eps`` as a ``RangeBackend``, computed on the
backend's device by the ``range_count`` kernel (plain version on the CPU).

``fit`` uploads the rows once (``data_device``); ``partial_fit``
appends rows in place into doubling buffers, one on the host (``data``)
and one on the device, so queries see exactly the first n rows and
nothing already indexed moves or is uploaded again.  ``state_export`` /
``state_import`` carry the host buffer whole (the reference's ``n`` and
``buf``), so a snapshot restores in either package.  Counts come from the
kernel's count body; hit rows from its bitmap body, copied to the host
as packed words and unpacked there (``query_hits_packed`` hands the
words over as they are, ``query_packed_device`` leaves them on the
device for ``laf_dbscan(cluster_device=True)``).  ``packs_natively`` is
False as in the reference, so ``laf_dbscan(cluster_device="auto")``
takes the host union-find pass.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.range_query import range_bitmap, range_counts, range_counts_and_bitmap, unpack_bitmap
from .base import RangeBackend, register_backend

__all__ = ["ExactBackend"]


@register_backend
class ExactBackend(RangeBackend):
    name = "exact"

    def __init__(self, *, block_size: int = 2048, device=None):
        self.block_size = block_size
        self.device = resolve_device(device)
        self._data: Optional[np.ndarray] = None
        self._data_dev: Optional[torch.Tensor] = None
        # doubling append buffers: _data / _data_dev are their first n rows
        self._buf: Optional[np.ndarray] = None
        self._buf_dev: Optional[torch.Tensor] = None

    def fit(self, data: np.ndarray) -> "ExactBackend":
        if self._data is data:
            return self
        self._data = np.ascontiguousarray(data, dtype=np.float32)
        self._data_dev = torch.from_numpy(self._data).to(self.device)
        self._buf = self._buf_dev = None
        return self

    def partial_fit(self, rows: np.ndarray) -> "ExactBackend":
        """Append rows in amortized O(rows): written into the host and the
        device doubling buffers in place."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if self._data is None:
            return self.fit(rows)
        n, b = self._data.shape[0], rows.shape[0]
        if self._buf is None or n + b > self._buf.shape[0]:
            cap = max(2 * (n if self._buf is None else self._buf.shape[0]), n + b)
            buf = np.zeros((cap, self._data.shape[1]), dtype=np.float32)
            buf[:n] = self._data
            buf_dev = torch.zeros((cap, self._data.shape[1]), dtype=torch.float32, device=self.device)
            buf_dev[:n] = self._data_dev
            self._buf, self._buf_dev = buf, buf_dev
        self._buf[n : n + b] = rows
        self._buf_dev[n : n + b] = torch.from_numpy(rows).to(self.device)
        self._data, self._data_dev = self._buf[: n + b], self._buf_dev[: n + b]
        return self

    def state_export(self):
        assert self._data is not None, "call fit() first"
        buf = self._buf if self._buf is not None else self._data
        return {"n": np.int64(self._data.shape[0]), "buf": np.ascontiguousarray(buf)}

    def state_import(self, state) -> "ExactBackend":
        n = int(state["n"])
        self._buf = np.ascontiguousarray(state["buf"], dtype=np.float32)
        self._buf_dev = torch.from_numpy(self._buf).to(self.device)
        self._data, self._data_dev = self._buf[:n], self._buf_dev[:n]
        return self

    @property
    def data_device(self) -> torch.Tensor:
        assert self._data_dev is not None, "call fit() first"
        return self._data_dev

    def _rows(self, rows) -> torch.Tensor:
        """db[rows] on the device (the resident copy for all rows in order)."""
        assert self._data_dev is not None, "call fit() first"
        rows = np.asarray(rows, dtype=np.int64)
        n = self.n_points
        if len(rows) == n and np.array_equal(rows, np.arange(n)):
            return self._data_dev
        return self._data_dev[torch.from_numpy(rows).to(self.device)]

    def _words(self, rows, cols, eps) -> np.ndarray:
        db = self._data_dev if cols is None else self._rows(cols)
        bitmap = range_bitmap(self._rows(rows), db, eps, block_size=self.block_size)
        return bitmap.cpu().numpy().view(np.uint32)

    def query_hits(self, rows: np.ndarray, eps: float) -> np.ndarray:
        return unpack_bitmap(self._words(rows, None, eps), self.n_points)

    def query_hits_subset(self, rows: np.ndarray, cols: np.ndarray, eps: float) -> np.ndarray:
        cols = np.asarray(cols, dtype=np.int64)
        return unpack_bitmap(self._words(rows, cols, eps), len(cols))

    def query_hits_packed(self, rows: np.ndarray, eps: float):
        counts, bitmap = range_counts_and_bitmap(
            self._rows(rows), self._data_dev, eps, block_size=self.block_size
        )
        return counts.cpu().numpy().astype(np.int64), bitmap.cpu().numpy().view(np.uint32)

    def query_packed_device(self, rows: np.ndarray, eps: float) -> torch.Tensor:
        return range_bitmap(self._rows(rows), self._data_dev, eps, block_size=self.block_size)

    def query_counts(self, rows: np.ndarray, eps: float) -> np.ndarray:
        counts = range_counts(self._rows(rows), self._data_dev, eps, block_size=self.block_size)
        return counts.cpu().numpy().astype(np.int64)
