"""Signed-random-projection signatures + Hamming-threshold calibration
(port of ``repro.index.signatures``).

For unit vectors x, y and a Gaussian direction r, ``P[sign<x,r> !=
sign<y,r>] = theta(x, y) / pi``; with ``n_bits`` directions the Hamming
distance between sign signatures is Binomial(n_bits, theta/pi), so an
eps-ball in cosine distance maps to a Hamming band whose width shrinks
like ``sqrt(n_bits)``.

Signatures are packed 32 bits per word, LSB-first (bit j of word w =
bit ``32*w + j``), carried as ``int32`` tensors holding the reference's
``uint32`` bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import exact_fp32, resolve_device
from ..core.range_query import pack_bitmap_t, unpack_bitmap_t

__all__ = [
    "make_projection",
    "pack_bits",
    "unpack_bits",
    "popcount32",
    "hamming_words",
    "hamming_numpy",
    "band_hits",
    "collision_fraction",
    "hamming_band",
    "sign_signatures",
    "shard_signatures",
]


def make_projection(d: int, n_bits: int, seed: int = 0) -> np.ndarray:
    """(d, n_bits) float32 Gaussian projection; the same numpy draws as
    the reference, so both packages sign with identical directions."""
    if n_bits % 32 != 0:
        raise ValueError(f"n_bits must be a multiple of 32, got {n_bits}")
    rng = np.random.default_rng(seed)
    return rng.standard_normal((d, n_bits)).astype(np.float32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(n, n_bits) bool -> (n, n_bits // 32) int32 words, LSB-first."""
    return pack_bitmap_t(bits)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`."""
    return unpack_bitmap_t(words, n_bits)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of an int32 tensor (same shape, int32).  Torch
    has no popcount op, so the bytes index a 256-entry table, built on
    the tensor's device (an upload would wait for the stream)."""
    byte = torch.arange(256, dtype=torch.int32, device=words.device)
    lut = sum((byte >> k) & 1 for k in range(8))
    b = words.contiguous().view(torch.uint8).to(torch.int32)
    return lut[b].view(*words.shape, 4).sum(dim=-1, dtype=torch.int32)


def hamming_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(na, nb) int32 Hamming distances between packed signature rows
    (plain XOR + table popcount; memory is na*nb*w words)."""
    x = a[:, None, :] ^ b[None, :, :]
    return popcount32(x).sum(dim=-1, dtype=torch.int32)


_POPCOUNT8_NP = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def hamming_numpy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(na, nb) Hamming distances between packed uint32 rows on the host
    (the backend's host oracle)."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    x = np.ascontiguousarray(a[:, None, :] ^ b[None, :, :])
    if hasattr(np, "bitwise_count"):  # numpy >= 2.0
        per_word = np.bitwise_count(x)
    else:
        per_word = _POPCOUNT8_NP[x.view(np.uint8)].reshape(*x.shape[:2], -1)
    return per_word.sum(axis=-1, dtype=np.int32)


def band_hits(dots, ham, eps, t_lo, t_hi):
    """The band predicate every path evaluates:

    hit  <=>  ham <= t_lo  (sure-accept, no exact verify)
           or (ham <= t_hi and dot > 1 - eps)  (band, exact-verified).

    ``t_lo = -1`` is full-verify mode.  Works on numpy arrays and torch
    tensors alike; ``dots`` are fp32.
    """
    return (ham <= t_lo) | ((ham <= t_hi) & (dots > 1.0 - eps))


def collision_fraction(eps: float) -> float:
    """Expected differing-bit fraction for a pair at cosine distance eps."""
    return math.acos(float(np.clip(1.0 - eps, -1.0, 1.0))) / math.pi


def hamming_band(eps: float, n_bits: int, margin: float = 3.0) -> tuple[int, int]:
    """(t_lo, t_hi) Hamming thresholds for an eps-ball at ``margin`` sigmas."""
    p = collision_fraction(eps)
    sd = math.sqrt(max(p * (1.0 - p), 1e-12) / n_bits)
    t_hi = min(n_bits, int(math.ceil(n_bits * (p + margin * sd))))
    t_lo = int(math.floor(n_bits * (p - margin * sd)))
    return t_lo, t_hi


def sign_signatures(data, proj, *, device=None, block: int = 65536) -> torch.Tensor:
    """Packed (n, n_bits // 32) int32 sign signatures of ``data @ proj``
    (``data`` a float32 numpy array or tensor).

    The product runs in full fp32 (TF32 off, see ``exact_fp32``): a bit
    decides which side of a hyperplane a row lies on.  Rows are signed
    in blocks so the (block, n_bits) product stays bounded.
    """
    exact_fp32()
    dev = resolve_device(device)
    if not torch.is_tensor(data):
        data = torch.from_numpy(np.ascontiguousarray(data, np.float32))
    data = data.to(dev)
    proj = torch.as_tensor(np.asarray(proj, np.float32)).to(dev)
    out = torch.empty((data.shape[0], proj.shape[1] // 32), dtype=torch.int32, device=dev)
    for s in range(0, data.shape[0], block):
        out[s : s + block] = pack_bits((data[s : s + block] @ proj) >= 0.0)
    return out


def _pad_block(x, lo: int, rows: int, device) -> torch.Tensor:
    """Rows ``[lo, lo + rows)`` of ``x`` (array or tensor) on ``device``,
    zero rows past its end."""
    x = torch.as_tensor(x)
    out = torch.zeros((rows, *x.shape[1:]), dtype=x.dtype, device=device)
    take = x[lo : min(lo + rows, x.shape[0])]
    out[: take.shape[0]] = take.to(device)
    return out


def shard_signatures(mesh, sigs, axes=None, *, n_padded: int, device=None) -> torch.Tensor:
    """This rank's row block of a packed signature table co-sharded with
    the database rows it summarizes (the counterpart of the reference's
    ``shard_signatures``, ``P(axes, None)``): the table is zero-padded to
    ``n_padded`` rows (zero words: the rows ``_pad_col_hits`` corrects)
    and shard k's block, rows ``[k * n_local, (k + 1) * n_local)`` with k
    the flattened index over ``axes`` (default: the mesh's data axes),
    is placed on ``device`` (``None`` = cuda).  ``sigs`` is an int32
    tensor or a uint32 / int32 array."""
    from ..distributed.sharding import plane_axes

    ax = plane_axes(mesh, axes)
    if n_padded % ax.size:
        raise ValueError(f"n_padded={n_padded} is not a multiple of {ax.size} shards")
    if not torch.is_tensor(sigs):
        sigs = torch.from_numpy(np.ascontiguousarray(sigs).view(np.int32))
    n_local = n_padded // ax.size
    return _pad_block(sigs, ax.index * n_local, n_local, resolve_device(device))
