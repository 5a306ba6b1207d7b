"""Wrapper for the flash-attention kernel (port of
``repro.kernels.flash_attention.ops``).

``flash_attention(q, k, v, *, causal, window, scale, q_offset)`` takes
the reference's (B, H, S, D) layout: q (B, Hq, Sq, D), k (B, Hkv, Sk,
D), v (B, Hkv, Sk, Dv) with Dv = D or (D, Dv) one of ``HEAD_PAIRS``, Hq
a multiple of Hkv; query ``i`` sits at position ``q_offset + i``
(default ``Sk - Sq``: right-aligned against the keys).  A CPU
``q`` runs the plain version (``ref.py``); a CUDA ``q`` launches
``csrc/flash_attention.cu`` or raises.

The reference wrapper's ``jnp.repeat`` of the kv heads and its halving
of the blocks until they divide S exist for the TPU's tiling and are
left out: the kernel reads kv head ``h // (Hq // Hkv)`` in place and
masks the ragged edges itself.  It takes element strides for B, H and S
(unit stride on D), so a head-major view of a (B, S, H, D) projection,
or the prefix ``k_cache[:, :, :n]`` of a decode cache, goes in without
a copy; an operand with another layout is copied to a contiguous one.

The mapping is chosen statically: bf16 with Sq > 1 runs the tensor-core
prefill (P·V as two bf16 products, P_hi·V + P_lo·V), fp32 with Sq > 1
the CUDA-core prefill, and Sq == 1 the decode mapping, split over Sk by
``decode_splits`` and merged by a second kernel that the same call
enqueues (one wrapper call, one count, two launches when split).  A
pair of ``HEAD_PAIRS`` (MLA's q/k 192 with v 128) runs the bf16 prefill
at its own widths.  The launcher alone knows which mappings take a pair:
where it answers ``_PAD_V`` (today the fp32 prefill and the decode
mapping), the call is made again with v zero-padded to D and the output
cut back to Dv.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...obs import metrics as _metrics
from .. import _build
from .ref import attention_ref

__all__ = ["flash_attention", "decode_splits", "LAUNCHES", "HEAD_DIMS", "HEAD_PAIRS", "DECODE_TILE", "DECODE_GROUP",
           "SMS"]

LAUNCHES = {"flash_attention": "kernel.flash_attention.launches"}
HEAD_DIMS = (16, 32, 128, 192)  # head widths the kernel is instantiated for (192: MLA's q/k)
HEAD_PAIRS = ((192, 128),)      # (D, Dv) pairs with v narrower than q/k: MLA's (bf16 prefill at its own widths)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAD_V = -1        # the launcher's answer where its mapping is not instantiated on (D, Dv)
DECODE_TILE = 64   # keys per decode tile (csrc/flash_attention.cu DBK)
DECODE_GROUP = 4   # query heads per decode block (csrc/flash_attention.cu RG)
SMS = 132          # streaming multiprocessors of an H100 SXM


def decode_splits(b: int, hkv: int, rep: int, sk: int):
    """(n_split, split_tiles) of the decode mapping: split ``i`` owns the
    keys ``[i * split_tiles * DECODE_TILE, (i + 1) * split_tiles *
    DECODE_TILE)`` cut at ``sk``, whole tiles, every split at least one.
    The grid has ``b * hkv * ceil(rep / DECODE_GROUP)`` blocks a split; it
    is split until it reaches about two blocks an SM, and not at all
    where it already does."""
    blocks = b * hkv * -(-rep // DECODE_GROUP)
    n_tiles = -(-sk // DECODE_TILE)
    if blocks >= 2 * SMS:
        return 1, n_tiles
    per = -(-n_tiles // min(n_tiles, -(-2 * SMS // blocks)))
    return -(-n_tiles // per), per


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, H, S, D), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if v.shape[3] != d and (d, v.shape[3]) not in HEAD_PAIRS:
        raise ValueError(f"v width {v.shape[3]} with q/k width {d}: v matches q/k or (D, Dv) is one of {HEAD_PAIRS}")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"query heads {hq} are not a multiple of kv heads {k.shape[1]}")
    if k.shape[2] == 0:
        raise ValueError("no keys: Sk must be at least 1")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(_DTYPES)}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")


def _operand(t):
    """``t`` as the kernel reads it: unit stride on D, 16-byte aligned
    rows (strides a multiple of the 16-byte vector); else a copy."""
    vec = 16 // t.element_size()
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(t.stride(i) % vec == 0 for i in range(3)):
        return t
    return t.contiguous()


def _launch(q, k, v, causal, window, scale, q_offset):
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d}: the kernel takes each of {HEAD_DIMS}")
    q, k, v = _operand(q), _operand(k), _operand(v)
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out
    # a window wider than the last query's position masks nothing
    w = -1 if window is None or window > q_offset + sq - 1 else int(window)
    n_split, split_tiles, part_ml, part_acc = 1, 1, None, None
    if sq == 1:
        n_split, split_tiles = decode_splits(b, hkv, hq // hkv, sk)
        if n_split > 1:  # the splits' (m, l) and acc, merged by the second kernel
            part_ml = torch.empty((b, hq, n_split, 2), dtype=torch.float32, device=q.device)
            part_acc = torch.empty((b, hq, n_split, d), dtype=torch.float32, device=q.device)
    err = _build.load("flash_attention").flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        b, hq, hkv, sq, sk, d, dv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(bool(causal)), w, q_offset, scale, n_split, split_tiles,
        None if part_ml is None else part_ml.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err == _PAD_V:  # this mapping (fp32, or decode) takes the pair with v padded to D
        return _launch(q, k, F.pad(v, (0, d - dv)), causal, window, scale, q_offset)[..., :dv]
    _build.check(err, "flash_attention")
    _metrics.counter(LAUNCHES["flash_attention"]).inc()
    return out


def flash_attention(q, k, v, *, causal: bool = False, window=None, scale=None, q_offset=None) -> torch.Tensor:
    """Exact softmax attention, q (B, Hq, Sq, D) against k (B, Hkv, Sk,
    D) and v (B, Hkv, Sk, Dv), Dv = D or (D, Dv) in ``HEAD_PAIRS`` ->
    (B, Hq, Sq, Dv) in ``q.dtype``; scores, softmax and P·V in fp32
    (on the card, bf16 prefill's P·V is P_hi·V + P_lo·V on the tensor
    cores: P to about 16 bits), ``scale`` = 1/sqrt(D) unless given,
    query ``i`` at position ``q_offset + i`` (``Sk - Sq`` unless given).
    A query with no key left by the mask gives 0."""
    _check(q, k, v, window)
    q_offset = k.shape[2] - q.shape[2] if q_offset is None else int(q_offset)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _launch(q, k, v, causal, window, scale, q_offset)
