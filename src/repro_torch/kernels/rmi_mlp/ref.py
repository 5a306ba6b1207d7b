"""Plain PyTorch version of the fused RMI-MLP forward (the port's
counterpart of ``repro.kernels.rmi_mlp.ref``): four ReLU layers and a
linear head in fp32 with TF32 off, weights in the reference's (in, out)
layout."""

from __future__ import annotations

import torch

from ... import exact_fp32

__all__ = ["mlp_forward_ref", "stage_forward_ref"]


def mlp_forward_ref(x, weights, biases):
    """4 ReLU hidden layers + linear head -> (batch,) fp32 (column 0)."""
    exact_fp32()
    h = x.to(torch.float32)
    for w, b in zip(weights[:-1], biases[:-1]):
        h = torch.relu(h @ w.to(torch.float32) + b.to(torch.float32))
    return (h @ weights[-1].to(torch.float32) + biases[-1].to(torch.float32))[:, 0]


def stage_forward_ref(x, stacked_weights, stacked_biases):
    """All E experts of one RMI stage: -> (E, batch) fp32."""
    n_experts = stacked_weights[0].shape[0]
    return torch.stack([
        mlp_forward_ref(x, [w[e] for w in stacked_weights], [b[e] for b in stacked_biases])
        for e in range(n_experts)
    ])
