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

Training: when grad mode is on and q, k or v requires a gradient,
``flash_attention`` runs through an ``autograd.Function`` whose forward
is the same launch with the per-query log-sum-exp written (the prefill
mappings only: Sq > 1) and whose backward is ``flash_attention_bwd``,
the B11 kernel (``csrc/flash_attention_bwd.cu``: dQ, dK, dV, the GQA
group sums taken in place, three launches a call, counted once).  Its
mapping is chosen statically by dtype: bf16 runs the tensor-core launch
(dK and dV in registers, dQ added into an fp32 accumulator that the
wrapper allocates zeroed, then cast), fp32 the CUDA-core FMA kernels.  On a
CPU tensor the same Function runs ``ref.py``'s ``attention_ref`` (with
the log-sum-exp) and ``attention_bwd_ref``.  The backward is
instantiated at ``BWD_DIMS`` with v as wide as q and k and at the pairs
of ``BWD_PAIRS`` (MLA's (192, 128)): bf16 runs the pair at its own
widths; the fp32 mapping answers ``_PAD_V`` there, and the call is made
again with v, the output and dO zero-padded to D, dV cut back.  Serving
(``inference_mode``, or nothing requiring a gradient) writes no
log-sum-exp and launches exactly as before.

The CUDA launches are the operators ``repro_torch::flash_attention``
(serving: the output alone), ``repro_torch::flash_attention_lse``
(training's forward: the output and its log-sum-exp) and
``repro_torch::flash_attention_bwd`` (``torch.library.custom_op``, none
mutating an argument: an operator that mutates one dispatches through
an extra Python kernel that costs several times the call); each
real implementation is the raw launch function (``_launch``,
``_launch_bwd``: the ``_PAD_V`` retry, the decode mapping's two kernels
under one count), and each fake implementation returns the outputs'
shapes, so a dispatch trace takes the launch path with no card: on fake
CUDA tensors, or on ``meta`` tensors, which the wrappers route to the
operators as they route CUDA ones (shapes only: the dry run's model
cells, whose autograd a CPU-only build cannot run on fake CUDA
tensors).  Their costs (``kernels.cost.attention_cost``,
``attention_bwd_cost``) are registered beside them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from typing import Optional, Tuple

from ...obs import metrics as _metrics
from .. import _build
from ..cost import attention_bwd_cost, attention_cost, register_op
from .ref import attention_bwd_ref, attention_ref

__all__ = ["flash_attention", "flash_attention_bwd", "decode_splits", "LAUNCHES", "HEAD_DIMS", "HEAD_PAIRS",
           "BWD_DIMS", "BWD_PAIRS", "BWD_PAD", "DECODE_TILE", "DECODE_GROUP", "SMS"]

LAUNCHES = {"flash_attention": "kernel.flash_attention.launches",
            "flash_attention_bwd": "kernel.flash_attention_bwd.launches"}
HEAD_DIMS = (16, 32, 64, 128, 192)  # head widths the kernel is instantiated for (192: MLA's q/k)
HEAD_PAIRS = ((192, 128),)      # (D, Dv) pairs with v narrower than q/k: MLA's (bf16 prefill at its own widths)
BWD_DIMS = (16, 32, 64, 128, 192)  # head widths the backward kernel is instantiated for (v as wide as q and k)
BWD_PAIRS = ((192, 128),)       # (D, Dv) pairs the backward takes: MLA's (bf16 at its own widths, fp32 v padded)
BWD_PAD = 64                    # bf16 backward: query rows of its scratch and dQ accumulator, padded to a multiple
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


def _window_arg(window, q_offset, sq):
    """The launchers' window: -1 where none, or where it is wider than
    the last query's position (it then masks nothing)."""
    return -1 if window is None or window > q_offset + sq - 1 else int(window)


def _launch(q, k, v, causal, window, scale, q_offset, lse=None):
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d}: the kernel takes each of {HEAD_DIMS}")
    q, k, v = _operand(q), _operand(k), _operand(v)
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out
    w = _window_arg(window, q_offset, sq)
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
        None if lse is None else lse.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err == _PAD_V:  # this mapping (fp32, or decode) takes the pair with v padded to D
        return _launch(q, k, F.pad(v, (0, d - dv)), causal, window, scale, q_offset, lse)[..., :dv]
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
    A query with no key left by the mask gives 0.  Differentiable when
    grad mode is on and an operand requires a gradient (the backward is
    ``flash_attention_bwd``)."""
    _check(q, k, v, window)
    q_offset = k.shape[2] - q.shape[2] if q_offset is None else int(q_offset)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v, bool(causal), window, scale, q_offset)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset)
    return _attention_op(q, k, v, bool(causal), _window(window), scale, q_offset)


def _window(window) -> Optional[int]:
    return None if window is None else int(window)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cuda")
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: Optional[int],
                  scale: float, q_offset: int) -> torch.Tensor:
    """One ``flash_attention`` call on the card (``_launch``), serving:
    (B, Hq, Sq, Dv), no log-sum-exp."""
    return _launch(q, k, v, causal, window, scale, q_offset)


@_attention_op.register_fake
def _(q, k, v, causal, window, scale, q_offset):
    return q.new_empty((*q.shape[:3], v.shape[3]))


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=(), device_types="cuda")
def _attention_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: Optional[int],
                      scale: float, q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``flash_attention`` call on the card (``_launch``), training's
    forward: (the output (B, Hq, Sq, Dv), its fp32 log-sum-exp (B, Hq,
    Sq))."""
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return _launch(q, k, v, causal, window, scale, q_offset, lse), lse


@_attention_lse_op.register_fake
def _(q, k, v, causal, window, scale, q_offset):
    return q.new_empty((*q.shape[:3], v.shape[3])), q.new_empty(q.shape[:3], dtype=torch.float32)


def _attention_cost(lse):
    return lambda q, k, v, causal, window, scale, q_offset: attention_cost(
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3], v.shape[3], causal=causal,
        window=window, q_offset=q_offset, elem=q.element_size(), lse=lse)


register_op("repro_torch::flash_attention", lambda *a: LAUNCHES["flash_attention"], _attention_cost(False))
register_op("repro_torch::flash_attention_lse", lambda *a: LAUNCHES["flash_attention"], _attention_cost(True))


def _check_bwd(q, k, v):
    d, dv = q.shape[-1], v.shape[-1]
    if (d, dv) not in BWD_PAIRS and (d != dv or d not in BWD_DIMS):
        raise NotImplementedError(
            f"flash_attention_bwd takes head widths {BWD_DIMS} with v as wide as q and k, or (D, Dv) in "
            f"{BWD_PAIRS}; got ({d}, {dv})")
    if q.shape[2] == 1:
        raise NotImplementedError("flash_attention_bwd: the decode mapping (Sq = 1) writes no log-sum-exp")


def _contiguous(t):
    """``t`` contiguous with a 16-byte aligned start (the backward reads
    whole 16-byte row pieces); else a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = False, window=None, scale=None, q_offset=None):
    """(dq, dk, dv) of ``flash_attention``'s output for the upstream
    gradient ``dout``, from the forward's inputs, its output ``out`` and
    its fp32 log-sum-exp ``lse`` (B, Hq, Sq); each in its input's dtype.
    A CPU ``q`` runs ``attention_bwd_ref``; a CUDA one launches
    ``csrc/flash_attention_bwd.cu`` (three kernels, one count; bf16 on the
    tensor cores, its dQ summed by atomic adds in an order that changes
    from call to call, fp32 on the CUDA cores) or raises: at head widths
    outside ``BWD_DIMS``, with v narrower than q and k but for
    ``BWD_PAIRS``, or at Sq = 1.  ``out`` and ``dout`` are v's width."""
    q_offset = k.shape[2] - q.shape[2] if q_offset is None else int(q_offset)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window, scale=scale,
                                 q_offset=q_offset)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    _check_bwd(q, k, v)
    return _attention_bwd_op(q, k, v, out, lse, dout, bool(causal), _window(window), scale, q_offset)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(), device_types="cuda")
def _attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, causal: bool, window: Optional[int], scale: float,
                      q_offset: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ``flash_attention_bwd`` call on the card (``_launch_bwd``):
    (dq, dk, dv)."""
    return _launch_bwd(q, k, v, out, lse, dout, causal, window, scale, q_offset)


@_attention_bwd_op.register_fake
def _(q, k, v, out, lse, dout, causal, window, scale, q_offset):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            torch.empty_like(k, memory_format=torch.contiguous_format),
            torch.empty_like(v, memory_format=torch.contiguous_format))


register_op("repro_torch::flash_attention_bwd", lambda *a: LAUNCHES["flash_attention_bwd"],
            lambda q, k, v, out, lse, dout, causal, window, scale, q_offset: attention_bwd_cost(
                q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3], v.shape[3], causal=causal,
                window=window, q_offset=q_offset, elem=q.element_size()))


def _launch_bwd(q, k, v, out, lse, dout, causal, window, scale, q_offset):
    b, hq, sq, d = q.shape
    hkv, sk, d_v = k.shape[1], k.shape[2], v.shape[3]
    q, k, v, out, dout = (_contiguous(t) for t in (q, k, v, out, dout.to(q.dtype)))
    lse = _contiguous(lse.to(torch.float32))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.bfloat16:  # (lse log2 e, D) pairs, and dQ's fp32 accumulator, rows padded
        sq_pad = -(-sq // BWD_PAD) * BWD_PAD
        scratch = torch.empty((b, hq, sq_pad, 2), dtype=torch.float32, device=q.device)
        dq_acc = torch.zeros((b, hq, sq_pad, d), dtype=torch.float32, device=q.device)
    else:  # rowsum(dO o O)
        scratch, dq_acc = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device), None
    err = _build.load("flash_attention_bwd").flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        scratch.data_ptr(), None if dq_acc is None else dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _DTYPES[q.dtype],
        b, hq, hkv, sq, sk, d, d_v, int(bool(causal)), _window_arg(window, q_offset, sq), q_offset, scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err == _PAD_V:  # this mapping (fp32) takes the pair with v, the output and dO padded to D
        pad = (0, d - d_v)
        dq, dk, dv = _launch_bwd(q, k, F.pad(v, pad), F.pad(out, pad), lse, F.pad(dout, pad), causal, window, scale,
                                 q_offset)
        return dq, dk, dv[..., :d_v].contiguous()
    _build.check(err, "flash_attention_bwd")
    _metrics.counter(LAUNCHES["flash_attention_bwd"]).inc()
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward writes the
    log-sum-exp and saves (q, k, v, out, lse); the backward is
    ``flash_attention_bwd``.  Under ``torch.utils.checkpoint`` the
    recomputed forward's context is the one the backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        if q.device.type == "cpu":
            out, lse = attention_ref(q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset,
                                     return_lse=True)
        else:
            _check_bwd(q, k, v)  # raise before the forward's launch, not after it
            out, lse = _attention_lse_op(q, k, v, causal, _window(window), scale, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale, q_offset = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window, scale=scale,
                                         q_offset=q_offset)
        return dq, dk, dv, None, None, None, None
