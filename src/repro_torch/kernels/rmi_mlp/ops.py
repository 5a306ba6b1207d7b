"""Wrappers for the fused RMI-MLP kernel (port of
``repro.kernels.rmi_mlp.ops``).

``rmi_mlp_forward(params, x)`` returns one net's (batch,) output and
``rmi_stage_forward(stacked, x)`` the (E, batch) outputs of all E
experts of a stage in one launch (the expert is a grid axis of the
kernel, where the reference ``vmap``s).  Parameters come in the
reference's layout, a sequence of ``(W, b)`` pairs with W (in, out)
(stacked: (E, in, out) and (E, out)), as tensors or numpy arrays, or as
the port's ``MLP`` modules (one module, or a sequence of them for a
stage).  Modules are packed into contiguous (E, in, out) fp32 buffers
on every call, so the buffers always hold the modules' current weights
and nothing is cached: packing all three stages costs about 0.8-1.0 ms
a predict at the MS-150k width, and a cache keyed on the parameters'
versions saved about 0.6 ms of it, below the predict's run-to-run
spread (NVIDIA H100 80GB HBM3, 700 W; ``chip_smoke.py``'s
``predict_ab`` line).  bf16 parameters are cast to
fp32 here, before the launch (the reference casts inside its kernel).

A CPU ``x`` runs the plain version (``ref.py``); a CUDA ``x`` launches
``csrc/rmi_mlp.cu`` or raises.  The kernel masks the ragged batch and
the input-dim tail itself, so nothing is padded.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...obs import metrics as _metrics
from .. import _build
from .ref import mlp_forward_ref, stage_forward_ref

__all__ = ["rmi_mlp_forward", "rmi_stage_forward", "stage_params", "pack_modules", "LAUNCHES"]

LAUNCHES = {"rmi_mlp": "kernel.rmi_mlp.launches"}
KERNEL_WIDTHS = (128, 256, 512)  # hidden widths the kernel holds (4 layers)


def _modules(stacked):
    """The expert modules of ``stacked``, or None for (W, b) pairs."""
    if isinstance(stacked, nn.Module):
        return list(stacked) if isinstance(stacked, nn.ModuleList) else [stacked]
    stacked = list(stacked)
    return stacked if stacked and all(isinstance(m, nn.Module) for m in stacked) else None


def pack_modules(experts):
    """The experts' (weights (E, in, out), biases (E, out)) fp32 stacks,
    built anew."""
    with torch.no_grad():
        layers = [m.layers for m in experts]
        return (
            [torch.stack([ls[i].weight.T for ls in layers]).float().contiguous() for i in range(len(layers[0]))],
            [torch.stack([ls[i].bias for ls in layers]).float().contiguous() for i in range(len(layers[0]))],
        )


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
    ``device``: weights[l] (E, in, out), biases[l] (E, out)."""
    device = _canon(device)
    experts = _modules(stacked)
    if experts is not None:
        ws, bs = pack_modules(experts)
        if ws[0].device != device:
            raise ValueError(f"rmi_mlp: the experts lie on {ws[0].device}, x on {device}")
        return ws, bs
    pairs = list(stacked)
    return [_as_fp32(w, device) for w, _ in pairs], [_as_fp32(b, device) for _, b in pairs]


def _check_shapes(ws, bs, x):
    if x.dim() != 2:
        raise ValueError(f"x must be (batch, d_in), got {tuple(x.shape)}")
    if len(ws) != 5 or len(bs) != 5:
        raise ValueError(f"the fused kernel runs 4 hidden layers and a head, got {len(ws)} layers")
    e, k = ws[0].shape[0], x.shape[1]
    for w, b in zip(ws, bs):
        if w.dim() != 3 or w.shape[0] != e or w.shape[1] != k or b.shape != (e, w.shape[2]):
            raise ValueError(f"layer shapes do not chain: W {tuple(w.shape)}, b {tuple(b.shape)} after width {k}")
        k = w.shape[2]
    widths = [w.shape[2] for w in ws[:-1]]
    if any(h not in KERNEL_WIDTHS for h in widths):
        raise ValueError(f"hidden widths {widths}: the kernel takes each of {KERNEL_WIDTHS}")


def _launch(ws, bs, x):
    _check_shapes(ws, bs, x)
    e, (n, d_in) = ws[0].shape[0], x.shape
    head_w, head_b = ws[-1][..., 0].contiguous(), bs[-1][..., :1].contiguous()
    operands = [x, *ws[:-1], *bs[:-1], head_w, head_b]
    if any(t.data_ptr() % 16 for t in operands[1:]):
        raise ValueError("rmi_mlp: parameter buffers must be 16-byte aligned")
    out = torch.empty((e, n), dtype=torch.float32, device=x.device)
    if n == 0 or e == 0:
        return out
    h = [w.shape[2] for w in ws[:-1]]
    layer_ptrs = [t.data_ptr() for pair in zip(ws[:-1], bs[:-1]) for t in pair]
    err = _build.load("rmi_mlp").rmi_mlp_launch(
        x.data_ptr(), n, d_in, *layer_ptrs, head_w.data_ptr(), head_b.data_ptr(),
        *h, e, out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "rmi_mlp")
    _metrics.counter(LAUNCHES["rmi_mlp"]).inc()
    return out


def rmi_stage_forward(stacked, x) -> torch.Tensor:
    """All E experts of one stacked RMI stage on x (batch, d_in) ->
    (E, batch) fp32, one launch on a CUDA ``x``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    x = x.detach().to(torch.float32).contiguous()
    ws, bs = stage_params(stacked, x.device)
    if x.device.type == "cpu":
        return stage_forward_ref(x, ws, bs)
    return _launch(ws, bs, x)


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
