"""Wrappers for the fused RMI-MLP kernel (port of
``repro.kernels.rmi_mlp.ops``).

``rmi_mlp_forward(params, x)`` returns one net's (batch,) output and
``rmi_stage_forward(stacked, x)`` the (E, batch) outputs of all E
experts of a stage in one launch (the expert is a grid axis of the
kernel, where the reference ``vmap``s).  Parameters come in the
reference's layout, a sequence of ``(W, b)`` pairs with W (in, out)
(stacked: (E, in, out) and (E, out)), as tensors or numpy arrays, or as
the port's ``MLP`` modules (one module, or a sequence of them for a
stage).

The kernel (``csrc/rmi_mlp.cu``, tf32 ``wgmma`` in three terms) reads
every weight K-major, in ``nn.Linear``'s own (out, in) layout, through
TMA: ``pack_stage`` stacks the modules' weights as they are (the
reference's pairs are transposed), splits each into its two tf32 parts
(hi + lo, rounded to nearest: the kernel's three-term product reads
both) and stores them K-major in blocks of 8 k, (2, E, ceil(in/8), out, 8)
fp32: one k-step of the kernel is one contiguous (out, 8) tile, a
single TMA box.  Modules are packed on every call, so the buffers always hold the
modules' current weights and nothing is cached (2.1-2.4 ms of enqueued
work a predict at the MS-150k width, most of it hidden behind the
launches it feeds: NVIDIA H100 80GB HBM3, 700 W, ``chip_smoke.py``'s
``predict_ab`` line, ``pack_ms`` beside ``forward_fused_ms``).  bf16
parameters are cast to fp32 here, before the launch (the reference
casts inside its kernel).  x reaches the kernel through TMA too:
``tma_rows`` gives it a row stride that is a multiple of 4 floats
(featurize's 769 columns are copied into rows of 772; ``rmi_predict``
does it once for its three stages).

A CPU ``x`` runs the plain version (``ref.py``); a CUDA ``x`` launches
the kernel (the operator ``repro_torch::rmi_mlp``, with its fake
implementation and its cost ``kernels.cost.rmi_mlp_cost`` beside it)
or raises.  The kernel masks the ragged batch and the
input-dim tail itself (TMA's zero fill), so nothing is padded into the
answer.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

from ...obs import metrics as _metrics
from .. import _build
from ..cost import register_op, rmi_mlp_cost
from .ref import mlp_forward_ref, stage_forward_ref

__all__ = ["rmi_mlp_forward", "rmi_stage_forward", "stage_params", "pack_stage", "stage_launch",
           "tma_rows", "LAUNCHES"]

LAUNCHES = {"rmi_mlp": "kernel.rmi_mlp.launches"}
KERNEL_WIDTHS = (128, 256, 512)  # hidden widths the kernel holds (4 layers)


def _modules(stacked):
    """The expert modules of ``stacked``, or None for (W, b) pairs."""
    if isinstance(stacked, nn.Module):
        return list(stacked) if isinstance(stacked, nn.ModuleList) else [stacked]
    stacked = list(stacked)
    return stacked if stacked and all(isinstance(m, nn.Module) for m in stacked) else None


def _rna_tf32_(bits: torch.Tensor) -> torch.Tensor:
    """In place on fp32 bit patterns (int32): round to tf32 (10 mantissa
    bits; to nearest, ties away from zero, as ``cvt.rna.tf32.f32``), so
    that |w - hi - lo| <= 2^-22 |w| for hi = tf32(w), lo = tf32(w - hi)."""
    return bits.add_(0x1000).bitwise_and_(-0x2000)


def _kernel_layer(w: torch.Tensor) -> torch.Tensor:
    """(E, out, in) weights -> (2, E, ceil(in/8), out, 8) fp32: [hi, lo]
    of each weight, K-major in blocks of 8 k (one k-step of the kernel: a
    contiguous (out, 8) tile for TMA), k >= in zero."""
    e, n, k = w.shape
    kb = -(-k // 8)
    if k % 8:
        w = torch.nn.functional.pad(w, (0, kb * 8 - k))
    blocked = w.float().view(e, n, kb, 8).transpose(1, 2)
    out = torch.empty((2, e, kb, n, 8), dtype=torch.float32, device=w.device)
    hi, lo = out[0], out[1]
    hi.copy_(blocked)
    _rna_tf32_(hi.view(torch.int32))
    torch.sub(blocked, hi, out=lo)
    _rna_tf32_(lo.view(torch.int32))
    return out


def pack_stage(stacked, device):
    """The kernel's operands for one stage, built anew: ``(weights,
    biases)``; weights[l] of the four hidden layers is (2, E,
    ceil(in/8), out, 8) fp32, the tf32 parts [hi, lo] of each weight,
    K-major in blocks of 8 k (``nn.Linear``'s (out, in) rows; the
    reference's (in, out) pairs are transposed); weights[4] is the head's
    (E, 1, h4) in fp32, and biases[l] (E, out) fp32."""
    device = _canon(device)
    experts = _modules(stacked)
    with torch.no_grad():
        if experts is not None:
            layers = [m.layers for m in experts]
            ws = [torch.stack([ls[i].weight for ls in layers]) for i in range(len(layers[0]))]
            bs = [torch.stack([ls[i].bias for ls in layers]).float().contiguous() for i in range(len(layers[0]))]
            if ws[0].device != device:
                raise ValueError(f"rmi_mlp: the experts lie on {ws[0].device}, x on {device}")
        else:
            pairs = list(stacked)
            ws = [_as_fp32(w, device).transpose(-1, -2) for w, _ in pairs]
            bs = [_as_fp32(b, device) for _, b in pairs]
        return [_kernel_layer(w) for w in ws[:-1]] + [ws[-1].float().contiguous()], bs


def tma_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (batch, d) fp32 as the kernel reads it: unit column stride,
    a row stride that is a multiple of 4 floats and a 16-byte aligned
    base; copied into padded rows when it is not so already.  A CPU
    tensor comes back as it is.  (The base is read from the storage
    offset: the caching allocator aligns every block to 512 bytes.)"""
    x = x.detach().to(torch.float32)
    if x.device.type != "cuda" or (x.stride(1) == 1 and x.stride(0) % 4 == 0 and x.storage_offset() % 4 == 0):
        return x
    n, d = x.shape
    buf = torch.empty((n, -(-d // 4) * 4), dtype=torch.float32, device=x.device)
    buf[:, :d] = x
    return buf[:, :d]


def _canon(device) -> torch.device:
    """``device`` with its index (``cuda`` -> ``cuda:<current>``), as a
    tensor's ``.device`` reports it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _as_fp32(a, device):
    if torch.is_tensor(a):
        if a.device != device:
            raise ValueError(f"rmi_mlp: a parameter lies on {a.device}, x on {device}")
        return a.detach().float().contiguous()
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device).contiguous()


def stage_params(stacked, device):
    """``(weights, biases)`` of one stage as contiguous fp32 tensors on
    ``device`` in the reference's layout (the plain version's operands):
    weights[l] (E, in, out), biases[l] (E, out)."""
    device = _canon(device)
    experts = _modules(stacked)
    if experts is not None:
        with torch.no_grad():
            layers = [m.layers for m in experts]
            ws = [torch.stack([ls[i].weight.T for ls in layers]).float().contiguous() for i in range(len(layers[0]))]
            bs = [torch.stack([ls[i].bias for ls in layers]).float().contiguous() for i in range(len(layers[0]))]
        if ws[0].device != device:
            raise ValueError(f"rmi_mlp: the experts lie on {ws[0].device}, x on {device}")
        return ws, bs
    pairs = list(stacked)
    return [_as_fp32(w, device) for w, _ in pairs], [_as_fp32(b, device) for _, b in pairs]


def _check_shapes(ws, bs, x):
    """The kernel's shapes (``pack_stage``'s): ``ws[l]`` (2, E, ceil(in/8),
    out, 8) for the hidden layers, the head (E, 1, h4)."""
    if x.dim() != 2:
        raise ValueError(f"x must be (batch, d_in), got {tuple(x.shape)}")
    if len(ws) != 5 or len(bs) != 5:
        raise ValueError(f"the fused kernel runs 4 hidden layers and a head, got {len(ws)} layers")
    e, k = ws[-1].shape[0], x.shape[1]
    for w, b in zip(ws[:-1], bs[:-1]):
        if w.dim() != 5 or w.shape[:3] != (2, e, -(-k // 8)) or w.shape[4] != 8 or b.shape != (e, w.shape[3]):
            raise ValueError(f"layer shapes do not chain: W {tuple(w.shape)}, b {tuple(b.shape)} after width {k}")
        k = w.shape[3]
    widths = [w.shape[3] for w in ws[:-1]]
    if any(h not in KERNEL_WIDTHS for h in widths):
        raise ValueError(f"hidden widths {widths}: the kernel takes each of {KERNEL_WIDTHS}")
    if ws[-1].shape != (e, 1, k) or bs[-1].shape != (e, 1):
        raise ValueError(f"the head must be (E, 1, {k}), got {tuple(ws[-1].shape)}")


def stage_launch(packed, x) -> torch.Tensor:
    """One launch on ``pack_stage``'s operands: x (batch, d_in) on the
    card -> (E, batch) fp32."""
    ws, bs = packed
    x = tma_rows(x)
    _check_shapes(ws, bs, x)
    e, n = ws[-1].shape[0], x.shape[0]
    if any(t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous() for t in ws + bs):
        raise ValueError("rmi_mlp: packed operands must be contiguous fp32 on x's device")
    if n == 0 or e == 0:
        return torch.empty((e, n), dtype=torch.float32, device=x.device)
    return _rmi_mlp_op(x, list(ws), list(bs))


@torch.library.custom_op("repro_torch::rmi_mlp", mutates_args=(), device_types="cuda")
def _rmi_mlp_op(x: torch.Tensor, ws: List[torch.Tensor], bs: List[torch.Tensor]) -> torch.Tensor:
    """One launch of ``csrc/rmi_mlp.cu`` on checked operands: (E, n) fp32."""
    if x.data_ptr() % 16 or any(t.data_ptr() % 16 for t in ws):
        raise ValueError("rmi_mlp: x and the weight buffers must be 16-byte aligned")
    e, (n, d_in) = ws[-1].shape[0], x.shape
    head_w, head_b = ws[-1][:, 0, :], bs[-1]
    out = torch.empty((e, n), dtype=torch.float32, device=x.device)
    h = [w.shape[3] for w in ws[:-1]]
    layer_ptrs = [t.data_ptr() for pair in zip(ws[:-1], bs[:-1]) for t in pair]
    err = _build.load("rmi_mlp").rmi_mlp_launch(
        x.data_ptr(), n, d_in, x.stride(0), *layer_ptrs, head_w.data_ptr(), head_b.data_ptr(),
        *h, e, out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "rmi_mlp")
    _metrics.counter(LAUNCHES["rmi_mlp"]).inc()
    return out


@_rmi_mlp_op.register_fake
def _(x, ws, bs):
    return x.new_empty((ws[-1].shape[0], x.shape[0]), dtype=torch.float32)


register_op("repro_torch::rmi_mlp", lambda x, ws, bs: LAUNCHES["rmi_mlp"],
            lambda x, ws, bs: rmi_mlp_cost(x.shape[0], x.shape[1], [w.shape[3] for w in ws[:-1]],
                                           ws[-1].shape[0]))


def rmi_stage_forward(stacked, x) -> torch.Tensor:
    """All E experts of one stacked RMI stage on x (batch, d_in) ->
    (E, batch) fp32, one launch on a CUDA ``x``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cpu":
        x = x.detach().to(torch.float32).contiguous()
        return stage_forward_ref(x, *stage_params(stacked, x.device))
    return stage_launch(pack_stage(stacked, x.device), x)


def rmi_mlp_forward(params, x) -> torch.Tensor:
    """One net, an ``MLP`` or a list of (W (in, out), b) pairs, on x
    (batch, d_in) -> (batch,) fp32: the fused counterpart of
    ``mlp_apply``."""
    if _modules(params) is None:
        if x.device.type == "cpu":
            ws, bs = stage_params(params, x.device)
            return mlp_forward_ref(x.detach(), ws, bs)
        params = [(_as_fp32(w, x.device)[None], _as_fp32(b, x.device)[None]) for w, b in params]
    return rmi_stage_forward(params, x)[0]
