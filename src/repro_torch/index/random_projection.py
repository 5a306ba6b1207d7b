"""Signed-random-projection ANN range backend (port of
``repro.index.random_projection``, single device).

Per query: XOR + popcount between packed sign signatures splits pairs
on the Hamming band ``(t_lo, t_hi)`` — sure accepts below ``t_lo``,
exact fp32 verify inside the band, pruned above ``t_hi`` — the shared
predicate ``index.signatures.band_hits``.  ``verify="full"`` sets
``t_lo = -1`` (every candidate exact-checked).

Two evaluators of that one contract:

* the sweep engine (default): the database rows and signatures live on
  the backend's device and every query runs the Hamming-filter kernel
  (``kernels.hamming_filter``) with one host read per sweep;
  ``query_bitmap_device`` leaves the packed slab on the device for the
  cluster pass (``packs_natively``);
* ``oracle=True``: the host numpy path (``_tile_hits`` /
  ``_tile_counts``), the in-package parity oracle.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.range_query import unpack_bitmap
from .base import RangeBackend, register_backend
from .signatures import hamming_band, hamming_numpy, make_projection, sign_signatures
from .sweep import sweep_bitmap, sweep_bitmap_device, sweep_counts

__all__ = ["RandomProjectionBackend"]


@register_backend
class RandomProjectionBackend(RangeBackend):
    name = "random_projection"

    def __init__(
        self,
        *,
        n_bits: int = 512,
        margin: float = 3.0,
        seed: int = 0,
        verify: str = "band",
        block_size: int = 2048,
        chunk: int = 256,
        max_band_frac: float = 0.05,
        oracle: bool = False,
        device=None,
    ):
        if verify not in ("band", "full"):
            raise ValueError(f"verify must be 'band' or 'full', got {verify!r}")
        self.n_bits = n_bits
        self.margin = margin
        self.seed = seed
        self.verify = verify
        self.block_size = block_size
        self.chunk = chunk
        self.max_band_frac = max_band_frac
        self.oracle = bool(oracle)
        self.device = resolve_device(device)
        self.projection: Optional[np.ndarray] = None
        self._data: Optional[np.ndarray] = None
        self._data_dev: Optional[torch.Tensor] = None
        self._sigs_dev: Optional[torch.Tensor] = None
        self._sigs_host: Optional[np.ndarray] = None

    # -- index build -------------------------------------------------------
    def fit(self, data: np.ndarray) -> "RandomProjectionBackend":
        if self._data is data:
            return self
        data = np.ascontiguousarray(data, dtype=np.float32)
        if (
            self._data is not None
            and self._data.shape == data.shape
            and np.array_equal(self._data, data)
        ):
            self._data = data  # same content, fresh object: no rebuild
            return self
        self.projection = make_projection(data.shape[1], self.n_bits, self.seed)
        self._data = data
        self._data_dev = torch.from_numpy(data).to(self.device)
        self._sigs_dev = sign_signatures(self._data_dev, self.projection, device=self.device)
        self._sigs_host = None
        return self

    @property
    def data_device(self) -> torch.Tensor:
        assert self._data_dev is not None, "call fit() first"
        return self._data_dev

    @property
    def signatures(self) -> np.ndarray:
        """Packed uint32 signatures on the host (copied once, lazily)."""
        assert self._sigs_dev is not None, "call fit() first"
        if self._sigs_host is None:
            self._sigs_host = self._sigs_dev.cpu().numpy().view(np.uint32)
        return self._sigs_host

    def band(self, eps: float) -> tuple[int, int]:
        """(t_lo, t_hi) for this index; t_lo is -1 in full-verify mode."""
        t_lo, t_hi = hamming_band(eps, self.n_bits, self.margin)
        if self.verify == "full":
            t_lo = -1
        return t_lo, t_hi

    # -- host oracle -------------------------------------------------------
    def _band_split(self, ham: np.ndarray, eps: float):
        t_lo, t_hi = self.band(eps)
        accept = ham <= t_lo
        band = (ham <= t_hi) & ~accept
        return accept, band

    def _tile_hits(self, rows, cols, ham, eps):
        """Band split + exact verify for one (rows, cols) tile given its
        Hamming distances; ``cols=None`` means the whole database."""
        data = self._data
        thresh = 1.0 - eps
        accept, band = self._band_split(ham, eps)
        pi, pj = np.nonzero(band)
        if len(pi) > self.max_band_frac * band.size:
            # band saturated: dense exact verify of the tile
            cdata = data if cols is None else data[cols]
            dots = data[rows] @ cdata.T
            return accept | (band & (dots > thresh))
        hit = accept
        if len(pi):
            cj = pj if cols is None else cols[pj]
            dots = np.einsum("ij,ij->i", data[rows[pi]], data[cj], optimize=True)
            hit = accept.copy()
            hit[pi, pj] = dots > thresh
        return hit

    def _tile_counts(self, rows, ham, eps):
        """Per-row hit counts for one tile without the hit matrix."""
        data = self._data
        thresh = 1.0 - eps
        accept, band = self._band_split(ham, eps)
        counts = accept.sum(axis=1, dtype=np.int64)
        pi, pj = np.nonzero(band)
        if len(pi) > self.max_band_frac * band.size:
            dots = data[rows] @ data.T
            counts += (band & (dots > thresh)).sum(axis=1, dtype=np.int64)
        elif len(pi):
            dots = np.einsum("ij,ij->i", data[rows[pi]], data[pj], optimize=True)
            counts += np.bincount(pi[dots > thresh], minlength=counts.shape[0]).astype(np.int64)
        return counts

    def _host_chunks(self, rows):
        for start in range(0, len(rows), self.chunk):
            sub = rows[start : start + self.chunk]
            yield start, sub, hamming_numpy(self.signatures[sub], self.signatures)

    def _host_query_hits(self, rows, eps):
        hit = np.zeros((len(rows), self.n_points), dtype=bool)
        for start, sub, ham in self._host_chunks(rows):
            hit[start : start + len(sub)] = self._tile_hits(sub, None, ham, eps)
        return hit

    def _host_query_counts(self, rows, eps):
        counts = np.zeros(len(rows), dtype=np.int64)
        for start, sub, ham in self._host_chunks(rows):
            counts[start : start + len(sub)] = self._tile_counts(sub, ham, eps)
        return counts

    def _host_query_hits_subset(self, rows, cols, eps):
        hit = np.zeros((len(rows), len(cols)), dtype=bool)
        col_tile = 2048
        sigs = self.signatures
        for rs in range(0, len(rows), self.chunk):
            rsub = rows[rs : rs + self.chunk]
            for cs in range(0, len(cols), col_tile):
                csub = cols[cs : cs + col_tile]
                ham = hamming_numpy(sigs[rsub], sigs[csub])
                hit[rs : rs + len(rsub), cs : cs + len(csub)] = self._tile_hits(rsub, csub, ham, eps)
        return hit

    # -- sweep engine ------------------------------------------------------
    def _gather(self, idx):
        """(rows, signatures) on the device for host or device indices."""
        if not torch.is_tensor(idx):
            idx = torch.from_numpy(np.asarray(idx, dtype=np.int64))
        t = idx.to(device=self.device, dtype=torch.int64)
        return self._data_dev[t], self._sigs_dev[t]

    def _sweep_kw(self):
        return dict(chunk=self.chunk)

    def query_bitmap_device(self, rows, eps: float):
        """Packed adjacency slab for ``rows`` (host or device indices) as
        a device tensor, no host sync: ``(slab, plan)`` from
        ``index.sweep.sweep_bitmap_device``."""
        t_lo, t_hi = self.band(eps)
        q, q_sig = self._gather(rows)
        return sweep_bitmap_device(
            q, q_sig, self._data_dev, self._sigs_dev, self.n_points, eps, t_lo, t_hi,
            **self._sweep_kw(),
        )

    def _sweep_hits_packed(self, rows, eps):
        t_lo, t_hi = self.band(eps)
        q, q_sig = self._gather(rows)
        return sweep_bitmap(
            q, q_sig, self._data_dev, self._sigs_dev, self.n_points, eps, t_lo, t_hi,
            **self._sweep_kw(),
        )

    # -- queries -----------------------------------------------------------
    @property
    def packs_natively(self) -> bool:
        return not self.oracle

    def query_hits(self, rows: np.ndarray, eps: float) -> np.ndarray:
        assert self._data is not None, "call fit() first"
        rows = np.asarray(rows, dtype=np.int64)
        if self.oracle:
            return self._host_query_hits(rows, eps)
        _, bitmap = self._sweep_hits_packed(rows, eps)
        return unpack_bitmap(bitmap, self.n_points)

    def query_hits_packed(self, rows: np.ndarray, eps: float):
        assert self._data is not None, "call fit() first"
        rows = np.asarray(rows, dtype=np.int64)
        if self.oracle:
            return super().query_hits_packed(rows, eps)
        return self._sweep_hits_packed(rows, eps)

    def query_hits_subset(self, rows: np.ndarray, cols: np.ndarray, eps: float) -> np.ndarray:
        assert self._data is not None, "call fit() first"
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if self.oracle:
            return self._host_query_hits_subset(rows, cols, eps)
        t_lo, t_hi = self.band(eps)
        q, q_sig = self._gather(rows)
        db, db_sig = self._gather(cols)
        _, bitmap = sweep_bitmap(
            q, q_sig, db, db_sig, len(cols), eps, t_lo, t_hi, **self._sweep_kw()
        )
        return unpack_bitmap(bitmap, len(cols))

    def query_counts(self, rows: np.ndarray, eps: float) -> np.ndarray:
        """Counts without materializing a hit matrix: the count-only
        kernel on the sweep path, accept rows + verified band pairs on
        the host oracle."""
        assert self._data is not None, "call fit() first"
        rows = np.asarray(rows, dtype=np.int64)
        if self.oracle:
            return self._host_query_counts(rows, eps)
        t_lo, t_hi = self.band(eps)
        q, q_sig = self._gather(rows)
        return sweep_counts(
            q, q_sig, self._data_dev, self._sigs_dev, self.n_points, eps, t_lo, t_hi,
            **self._sweep_kw(),
        )
