"""Shared layers (port of ``repro.models.layers``): norms, rotary
embeddings, GQA attention, gated MLPs, cross-entropy.

Parameters keep the reference's layout and names: a dense weight is
(in, out) and ``dense(w, x) = x @ w``; a norm is a mapping with
``"scale"`` (and ``"bias"``), an MLP tower a list of ``{"w", "b"}``
mappings.  Init helpers allocate on ``device`` (``cuda`` unless the
caller passes ``"cpu"``, as every entry point of the package) and draw
from a ``torch.Generator`` of that device; they give other numbers than
``jax.random`` from the same seed, so the tests carry the reference's
weights across instead.

``blockwise_attention`` is the reference's exact attention; in the port
it runs ``kernels.flash_attention`` (the hand-written kernel on a CUDA
tensor, its plain version on a CPU one), which the reference names as
its TPU-executed twin.  It is differentiable: under grad mode the
kernel writes each query's log-sum-exp and its backward is the B11
kernel (``flash_attention_bwd``); the padding below is differentiated
by autograd like any other operation.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..kernels.flash_attention import flash_attention
from ..kernels.flash_attention.ops import HEAD_DIMS, HEAD_PAIRS

__all__ = [
    "dense_init", "dense", "rmsnorm_init", "rmsnorm", "layernorm_init", "layernorm",
    "rope_frequencies", "apply_rope", "blockwise_attention", "swiglu_init", "swiglu",
    "geglu_init", "geglu", "mlp_init", "mlp_apply", "cross_entropy_loss",
    "chunked_cross_entropy",
]

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _device_and_generator(gen: Optional[torch.Generator], device) -> torch.device:
    """The device an init helper draws on (``resolve_device``: ``cuda``
    unless the caller passes ``"cpu"``); a generator passed in must live
    there, since ``torch.randn`` draws only from a generator of its own
    device."""
    dev = resolve_device(device)
    if gen is not None and gen.device.type != dev.type:
        raise ValueError(f"the generator lives on {gen.device}, the parameters on {dev}")
    return dev


def dense_init(gen: Optional[torch.Generator], d_in, d_out, dtype=torch.float32, scale=None, device=None):
    """normal / sqrt(d_in), drawn in fp32 and stored in ``dtype``."""
    dev = _device_and_generator(gen, device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=dev)
    return w.mul_(scale).to(dtype)


def dense(w, x):
    return x @ w.to(x.dtype)


def rmsnorm_init(d, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=resolve_device(device))}


def rmsnorm(p, x, eps=1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32)).to(x.dtype)


def layernorm_init(d, dtype=torch.float32, device=None):
    dev = resolve_device(device)
    return {"scale": torch.ones((d,), dtype=dtype, device=dev),
            "bias": torch.zeros((d,), dtype=dtype, device=dev)}


def layernorm(p, x, eps=1e-6):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"] + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding (rotate-half: the head splits into halves)
# ---------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float = 10000.0, device=None):
    """(d_head/2,) float32 inverse frequencies on ``device`` (``None`` =
    cuda, raising without a card)."""
    dev = resolve_device(device)
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=dev) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """x (..., S, D); positions (..., S) integer.  Computed in fp32."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)            # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs         # (..., S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (exact; the flash_attention kernel)
# ---------------------------------------------------------------------------


def blockwise_attention(
    q: torch.Tensor,        # (B, Hq, Sq, D)
    k: torch.Tensor,        # (B, Hkv, Sk, D)
    v: torch.Tensor,        # (B, Hkv, Sk, Dv): Dv may differ from D (MLA)
    *,
    causal: bool = True,
    window=None,             # None or int: kpos > qpos - window
    q_offset=None,           # absolute position of q[0] (decode); default Sk-Sq
    kv_block: int = 1024,
    valid_len=None,          # number of valid kv entries (decode with a cache)
):
    """Exact attention -> (B, Hq, Sq, Dv) in ``q.dtype``, for every input
    the reference takes.

    Query ``i`` sits at position ``q_offset + i`` and attends the keys
    ``k[:, :, :valid_len]`` (the prefix view: the keys past it are masked
    in the reference); no valid key gives 0, as the reference's clamped
    normalizer does.  A (D, Dv) pair the kernel is instantiated for
    (``HEAD_PAIRS``: MLA's q/k 192 with v 128) goes in as it is.  Other
    widths are zero-padded along D to the kernel's narrowest width
    (``HEAD_DIMS``) that holds ``max(D, Dv)`` (MLA's reduced 24 and 16
    run at 32), and the output is cut back to ``Dv``: zero columns of
    ``v`` add nothing, zero columns of ``q`` and ``k`` leave ``q·k``
    unchanged, and the scale stays 1/sqrt(D).  A width past the widest
    is left as it is (the plain version takes it; the card raises).
    ``kv_block`` is the reference's scan chunk and is ignored: the kernel
    tiles the keys itself.  Unlike the reference's jnp body, the
    probabilities are not rounded to the inputs' type in P·V: fp32 (as
    in the TPU kernel), or on the card's bf16 prefill two bf16 terms,
    P_hi·V + P_lo·V (P to about 16 bits), so bf16 results differ by that
    rounding."""
    del kv_block
    b, hq, sq, d = q.shape
    sk, dv = k.shape[2], v.shape[-1]
    offset = sk - sq if q_offset is None else int(q_offset)
    n = sk if valid_len is None else min(int(valid_len), sk)
    if n <= 0:
        return torch.zeros((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    k, v = k[:, :, :n], v[:, :, :n]
    if (d, dv) not in HEAD_PAIRS:
        width = min((w for w in HEAD_DIMS if w >= max(d, dv)), default=max(d, dv))
        if d < width:
            q, k = F.pad(q, (0, width - d)), F.pad(k, (0, width - d))
        if dv < width:
            v = F.pad(v, (0, width - dv))
    out = flash_attention(q, k, v, causal=causal, window=window, scale=1.0 / math.sqrt(d), q_offset=offset)
    return out if out.shape[-1] == dv else out[..., :dv]


# ---------------------------------------------------------------------------
# gated MLPs
# ---------------------------------------------------------------------------


def swiglu_init(gen, d_model, d_ff, dtype=torch.float32, device=None):
    device = _device_and_generator(gen, device)
    return {
        "wi_gate": dense_init(gen, d_model, d_ff, dtype, device=device),
        "wi_up": dense_init(gen, d_model, d_ff, dtype, device=device),
        "wo": dense_init(gen, d_ff, d_model, dtype, device=device),
    }


def swiglu(p, x):
    g = F.silu(dense(p["wi_gate"], x).to(torch.float32)).to(x.dtype)
    return dense(p["wo"], g * dense(p["wi_up"], x))


def geglu_init(gen, d_model, d_ff, dtype=torch.float32, device=None):
    return swiglu_init(gen, d_model, d_ff, dtype, device)


def geglu(p, x):
    # jax.nn.gelu defaults to the tanh approximation
    g = F.gelu(dense(p["wi_gate"], x).to(torch.float32), approximate="tanh").to(x.dtype)
    return dense(p["wo"], g * dense(p["wi_up"], x))


def mlp_init(gen, dims, dtype=torch.float32, bias=True, device=None):
    """Plain ReLU MLP tower (recsys towers): dims = [in, h1, ..., out]."""
    device = _device_and_generator(gen, device)
    params = []
    for i in range(len(dims) - 1):
        layer = {"w": dense_init(gen, dims[i], dims[i + 1], dtype, device=device)}
        if bias:
            layer["b"] = torch.zeros((dims[i + 1],), dtype=dtype, device=device)
        params.append(layer)
    return params


def mlp_apply(params, x, final_activation=False):
    for i, layer in enumerate(params):
        x = x @ layer["w"].to(x.dtype)
        if "b" in layer:
            x = x + layer["b"].to(x.dtype)
        if i < len(params) - 1 or final_activation:
            x = torch.relu(x)
    return x


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; logits (..., V), labels (...) integer."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def _chunk_nll(w_head, hc, lc):
    """Summed token NLL of one chunk: hc (B, C, D), lc (B, C)."""
    lf = (hc @ w_head.to(hc.dtype)).to(torch.float32)
    gold = torch.gather(lf, -1, lc[..., None].long())[..., 0]
    return torch.sum(torch.logsumexp(lf, dim=-1) - gold)


def chunked_cross_entropy(
    w_head: torch.Tensor,     # (D, V)
    h: torch.Tensor,          # (B, S, D) final hidden states
    labels: torch.Tensor,     # (B, S)
    *,
    chunk: int = 512,
) -> torch.Tensor:
    """LM loss without the full (B, S, V) fp32 logits: a loop over
    sequence chunks, each chunk's logits alive only inside its turn.
    Under grad mode each chunk runs under ``torch.utils.checkpoint``, so
    the backward recomputes its logits instead of keeping them (the
    reference's ``jax.checkpoint(body)``; llama3-8b's (8, 4096, 128256)
    fp32 logits would otherwise be 16.8 GB).  (The reference's
    ``shard_logits`` hook pins a sharding; the port runs on one device
    and has none.)"""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    remat = torch.is_grad_enabled() and (h.requires_grad or w_head.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, s, chunk):
        hc, lc = h[:, c : c + chunk], labels[:, c : c + chunk]
        if remat:
            total = total + checkpoint(_chunk_nll, w_head, hc, lc, use_reentrant=False, preserve_rng_state=False)
        else:
            total = total + _chunk_nll(w_head, hc, lc)
    return total / (b * s)
