"""Gradient compression with error feedback (port of
``repro.train.compression``), for the slow cross-pod hop.

Two codecs, both with error-feedback residual accumulation (the residual
makes biased compressors converge — Karimireddy et al. 2019):

* ``int8_codec`` — per-tensor-scaled int8 quantization (4x over fp32,
  2x over bf16 wire bytes);
* ``topk_codec`` — magnitude top-k with index transmission (k as a
  fraction), for the extreme-ratio regime.  Ties in magnitude go to the
  lower index, as ``jax.lax.top_k`` orders them (a stable sort).

``compress`` returns (payload, new_residual); ``decompress``
reconstructs the dense update; everything is fp32 on the gradient's
device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from .optimizer import tree_map

__all__ = ["int8_codec", "topk_codec", "Codec", "init_residuals", "compressed_wire_bytes"]

F32 = torch.float32


@dataclass(frozen=True)
class Codec:
    compress: Callable   # (grad, residual) -> (payload, new_residual)
    decompress: Callable  # payload -> dense grad
    wire_bytes: Callable  # payload -> int


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)


def int8_codec() -> Codec:
    def compress(g: torch.Tensor, residual: torch.Tensor):
        x = g.to(F32) + residual
        scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        reconstructed = q.to(F32) * scale
        return {"q": q, "scale": scale}, x - reconstructed

    def decompress(payload):
        return payload["q"].to(F32) * payload["scale"]

    def wire_bytes(payload):
        return payload["q"].numel() + 4

    return Codec(compress, decompress, wire_bytes)


def topk_codec(frac: float = 0.01) -> Codec:
    def compress(g: torch.Tensor, residual: torch.Tensor):
        x = (g.to(F32) + residual).reshape(-1)
        k = max(1, int(frac * x.numel()))
        idx = torch.sort(torch.abs(x), descending=True, stable=True).indices[:k]
        sel = x[idx]
        reconstructed = torch.zeros_like(x).index_put_((idx,), sel)
        return (
            {"idx": idx.to(torch.int32), "vals": sel, "shape": tuple(g.shape)},
            (x - reconstructed).reshape(g.shape),
        )

    def decompress(payload):
        flat = torch.zeros((math.prod(payload["shape"]),), dtype=F32, device=payload["vals"].device)
        return flat.index_put_((payload["idx"].long(),), payload["vals"]).reshape(payload["shape"])

    def wire_bytes(payload):
        return payload["idx"].numel() * 4 + payload["vals"].numel() * 4

    return Codec(compress, decompress, wire_bytes)


def _payloads(tree):
    """The payloads of a tree whose leaves are payload dicts (a dict is a
    leaf, the root included, as the reference's ``is_leaf``)."""
    if isinstance(tree, dict):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [p for x in tree for p in _payloads(x)]
    return [tree]


def compressed_wire_bytes(codec: Codec, payload_tree) -> int:
    return sum(codec.wire_bytes(p) for p in _payloads(payload_tree))
