"""Recursive Model Index (RMI) cardinality estimator (port of
``repro.core.cardinality.rmi``).

Per the paper §3.1: three stages of 1 / 2 / 4 fully-connected nets
(top to bottom), each with 4 hidden layers of widths 512, 512, 256, 128.
Input = (query vector ⊕ distance threshold); output = z = log2(1 +
count), inverted at prediction time.  The stage-k prediction, scaled by
the training-set maximum target, picks which stage-(k+1) expert refines
it; every expert of a stage runs on the whole batch and the route
selects one output per row (branchless, as in the reference).

``RMI.forward`` is the autograd path (``nn.Linear``) that training
uses; ``rmi_predict`` runs each stage as one launch of the fused kernel
(``kernels.rmi_mlp``) on the card, its plain version on the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ...kernels.rmi_mlp import rmi_stage_forward
from ...kernels.rmi_mlp.ops import tma_rows

__all__ = [
    "RMIConfig",
    "MLP",
    "RMI",
    "rmi_route",
    "rmi_predict",
    "rmi_predict_counts",
    "rmi_from_jax",
]

HIDDEN = (512, 512, 256, 128)  # paper: 4 hidden layers, widths 512,512,256,128
STAGE_SIZES = (1, 2, 4)        # paper: 3 stages with 1, 2, 4 nets


@dataclass(frozen=True)
class RMIConfig:
    input_dim: int                      # d + 1 (query ⊕ eps)
    hidden: Sequence[int] = HIDDEN
    stage_sizes: Sequence[int] = STAGE_SIZES
    target_max: float = 16.0            # max of z = log2(1+count) on train set


class MLP(nn.Module):
    """ReLU MLP ``input_dim -> hidden... -> 1``: (batch, in) -> (batch,)."""

    def __init__(self, input_dim: int, hidden: Sequence[int], *, generator=None):
        super().__init__()
        dims = [input_dim, *hidden, 1]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))
        with torch.no_grad():
            for layer in self.layers:  # He-normal weights, zero biases
                fan_in = layer.in_features
                w = torch.randn((fan_in, layer.out_features), generator=generator)
                layer.weight.copy_(w.T * math.sqrt(2.0 / fan_in))
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)[:, 0]


def rmi_route(pred: torch.Tensor, n_next: int, target_max: float) -> torch.Tensor:
    """Map a stage prediction to the next-stage expert index."""
    idx = torch.floor(pred / target_max * n_next).to(torch.int64)
    return idx.clamp(0, n_next - 1)


class RMI(nn.Module):
    """The staged estimator: ``stages[s][e]`` is expert e of stage s."""

    def __init__(self, cfg: RMIConfig, *, generator=None):
        super().__init__()
        self.cfg = cfg
        self.stages = nn.ModuleList(
            nn.ModuleList(MLP(cfg.input_dim, cfg.hidden, generator=generator) for _ in range(size))
            for size in cfg.stage_sizes
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """z = log2(1 + count) for featurized inputs (batch, d+1)."""
        pred = self.stages[0][0](x)
        for experts in self.stages[1:]:
            idx = rmi_route(pred, len(experts), self.cfg.target_max)
            all_preds = torch.stack([m(x) for m in experts])  # (E, batch)
            pred = all_preds.gather(0, idx[None, :])[0]
        return pred


def rmi_predict(model: RMI, x: torch.Tensor) -> torch.Tensor:
    """z for featurized inputs (batch, d+1): each stage's experts in one
    ``rmi_stage_forward`` (E, batch), routed and gathered as in
    ``RMI.forward``.  On the card x is laid out for the kernel's TMA once
    (``tma_rows``), not once a stage."""
    with torch.no_grad():
        x = tma_rows(x)
        pred = rmi_stage_forward(model.stages[0], x)[0]
        for experts in model.stages[1:]:
            idx = rmi_route(pred, len(experts), model.cfg.target_max)
            pred = rmi_stage_forward(experts, x).gather(0, idx[None, :])[0]
    return pred


def rmi_predict_counts(model: RMI, x: torch.Tensor) -> torch.Tensor:
    """Predicted raw cardinalities (>= 0)."""
    z = rmi_predict(model, x)
    return torch.clamp(torch.exp2(z) - 1.0, min=0.0)


def _load_mlp(mlp: MLP, params) -> None:
    with torch.no_grad():
        for layer, (w, b) in zip(mlp.layers, params):
            layer.weight.copy_(torch.from_numpy(np.array(w, np.float32)).T)
            layer.bias.copy_(torch.from_numpy(np.array(b, np.float32)))


def rmi_from_jax(params_np, cfg: RMIConfig, *, device=None) -> RMI:
    """An ``RMI`` holding the JAX estimator's parameters, given as numpy
    arrays of its pytree ``{"stage0": [(W, b), ...], "stage1": [(W, b)
    stacked over experts], ...}`` (W is (in, out) there, (out, in) in
    ``nn.Linear``)."""
    from ... import resolve_device

    model = RMI(cfg)
    for s, experts in enumerate(model.stages):
        layers = params_np[f"stage{s}"]
        if len(experts) == 1 and np.ndim(layers[0][0]) == 2:
            _load_mlp(experts[0], layers)
            continue
        for e, mlp in enumerate(experts):
            _load_mlp(mlp, [(w[e], b[e]) for w, b in layers])
    return model.to(resolve_device(device))

