"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing
with capacity-bounded scatter dispatch, group-local as in the reference.

Tokens are cut into ``groups``; routing, slot assignment and the
capacity bound stay inside a group.  An entry is a (token, k) pair,
token-major and k-minor; its slot is the number of earlier entries of
its group routed to the same expert (the exclusive cumsum of the
one-hot), an entry at or past the capacity is dropped (its token gets
nothing from that expert) and writes zeros to slot ``cap - 1``.  The
combine is an fp32 scatter-add (``index_add_``) of the gate-weighted
expert outputs back to their tokens, never a dense (T, E) mixture.
Shared experts (DeepSeek-V2) are a dense SwiGLU of width ``d_ff *
n_shared`` added to the routed output.

Where the port's arithmetic differs from the reference's:

* The router is fp32 (``params["router"]`` stays fp32 in a bf16 model,
  as ``moe_init`` draws it) and scores ``x`` upcast to fp32, as in the
  reference.  Top-k is a stable descending sort of the probabilities:
  the larger probability first and, between equal ones, the lower
  expert index, as ``jax.lax.top_k`` orders them (``torch.topk`` on
  CUDA promises no order between ties).
* The expert GEMMs are ``torch.matmul`` over (E, G·C, d) in the expert
  weights' own type: the reference upcasts bf16 weights and computes in
  fp32, which at grok-1's width would be 6.4 GB of fp32 copies a weight
  and a layer.  With fp32 weights the arithmetic is the reference's.
  With bf16 weights the card multiplies bf16 (exact products, fp32
  accumulation in cuBLAS, split-K reductions as
  ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
  allows: PyTorch's default, on, is left as it is) and rounds the
  gate and up projections to bf16; ``silu(gate) * up`` is taken in fp32
  and rounded to bf16 for the down projection, whose output is rounded
  to bf16 before the fp32 combine.

The reference's sharding hooks (``shard_*``) are kept as fields that
must be ``None``: the port runs on one device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from .layers import swiglu

__all__ = ["MoEConfig", "moe_init", "moe_shapes", "moe_apply", "route"]


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden dim
    n_experts: int
    top_k: int
    n_shared: int = 0         # always-on shared experts (DeepSeek-V2)
    capacity_factor: float = 1.25
    groups: int = 1           # dispatch groups (= data shards at scale)
    shard_buffers: Optional[Callable] = None   # the reference's sharding hooks: must be None here
    shard_dispatch: Optional[Callable] = None
    shard_tokens: Optional[Callable] = None
    shard_entries: Optional[Callable] = None
    dtype: torch.dtype = torch.float32


def _check(cfg: MoEConfig) -> None:
    hooks = [n for n in ("shard_buffers", "shard_dispatch", "shard_tokens", "shard_entries")
             if getattr(cfg, n) is not None]
    if hooks:
        raise NotImplementedError(f"sharding hooks {hooks} are not ported (the port runs on one device)")


def moe_shapes(cfg: MoEConfig):
    """{name: (shape, dtype)} of the parameter tree (``shared`` a nested
    tree when ``n_shared``), with the reference's names: the router in
    fp32, the experts in ``cfg.dtype``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    shapes = {
        "router": ((d, e), torch.float32),
        "wi_gate": ((e, d, f), cfg.dtype),
        "wi_up": ((e, d, f), cfg.dtype),
        "wo": ((e, f, d), cfg.dtype),
    }
    if cfg.n_shared:
        fs = f * cfg.n_shared
        shapes["shared"] = {"wi_gate": ((d, fs), cfg.dtype), "wi_up": ((d, fs), cfg.dtype),
                            "wo": ((fs, d), cfg.dtype)}
    return shapes


def moe_init(seed_or_generator, cfg: MoEConfig, device=None):
    """Random parameters as the reference's ``moe_init`` draws them
    (normal / sqrt(fan-in), fp32 router), from a ``torch.Generator`` on
    ``device`` (``cuda`` unless ``"cpu"``): other numbers than
    ``jax.random``'s."""
    dev = resolve_device(device)
    gen = (seed_or_generator if isinstance(seed_or_generator, torch.Generator)
           else torch.Generator(device=dev).manual_seed(int(seed_or_generator)))

    def draw(spec):
        if isinstance(spec, dict):
            return {k: draw(v) for k, v in spec.items()}
        shape, dtype = spec
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return w.mul_(1.0 / math.sqrt(shape[-2])).to(dtype)

    return draw(moe_shapes(cfg))


def _capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = int(math.ceil(cfg.capacity_factor * cfg.top_k * tokens_per_group / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8 for lane friendliness


def route(router: torch.Tensor, cfg: MoEConfig, xg: torch.Tensor):
    """(probs (G, Tg, E), gate values (G, Tg, k) normalized over k,
    experts (G, Tg, k)) of tokens ``xg`` (G, Tg, d): a softmax of the
    router's logits in the router's type (fp32; at least fp32) and its
    top ``k``, largest first, ties to the lower expert."""
    dt = torch.promote_types(router.dtype, torch.float32)
    logits = torch.matmul(xg.to(dt), router.to(dt))
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., : cfg.top_k], idx[..., : cfg.top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_idx


def moe_apply(params, cfg: MoEConfig, x: torch.Tensor):
    """x (T, d) -> ((T, d) in ``x.dtype``, aux dict of 0-d fp32 tensors:
    ``drop_fraction``, ``router_entropy``, ``lb_loss``).  T must divide
    by ``cfg.groups``."""
    _check(cfg)
    t, d = x.shape
    g, e, k = cfg.groups, cfg.n_experts, cfg.top_k
    if t % g:
        raise ValueError(f"{t} tokens do not divide into {g} groups")
    tg = t // g
    cap = _capacity(tg, cfg)

    xg = x.reshape(g, tg, d)
    probs, gate_vals, expert_idx = route(params["router"], cfg, xg)

    flat_expert = expert_idx.reshape(g, tg * k)                       # (G, TK), token-major, k-minor
    onehot = F.one_hot(flat_expert, e)                                 # (G, TK, E)
    ranks = torch.cumsum(onehot, dim=1) - onehot                       # entries before me, per group
    slot = torch.gather(ranks, 2, flat_expert[..., None])[..., 0]
    keep = slot < cap
    safe_slot = torch.where(keep, slot, cap - 1)
    token_of_entry = torch.arange(tg, device=x.device).repeat_interleave(k)   # (TK,)

    # dispatch: buf[g, expert, slot] = the entry's token; dropped entries add zeros at cap - 1
    entries = xg[:, token_of_entry] * keep[..., None].to(x.dtype)     # (G, TK, d)
    flat = (torch.arange(g, device=x.device)[:, None] * e + flat_expert) * cap + safe_slot   # (G, TK)
    buf = torch.zeros((g * e * cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((flat.reshape(-1),), entries.reshape(-1, d), accumulate=True)

    # experts: (E, G·C, d) against (E, d, f) in the weights' type
    wdt = params["wi_gate"].dtype
    xe = buf.view(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d).to(wdt)
    h = F.silu(torch.matmul(xe, params["wi_gate"]).to(torch.float32))
    h.mul_(torch.matmul(xe, params["wi_up"]))
    y = torch.matmul(h.to(wdt), params["wo"]).to(x.dtype)            # (E, G·C, d)
    del xe, h
    y = y.view(e, g, cap, d).transpose(0, 1).reshape(g * e * cap, d)

    # combine: the gate-weighted outputs scatter-added to their tokens in fp32
    gathered = y[flat.reshape(-1)].view(g, tg * k, d) * keep[..., None].to(y.dtype)
    weighted = gathered.to(torch.float32) * gate_vals.reshape(g, tg * k)[..., None]
    tok = (torch.arange(g, device=x.device)[:, None] * tg + token_of_entry).reshape(-1)
    out = torch.zeros((g * tg, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, tok, weighted.reshape(-1, d))
    out = out.to(x.dtype)

    counts = onehot.sum((0, 1)).to(torch.float32)
    aux = {
        "drop_fraction": 1.0 - keep.to(torch.float32).mean(),
        "router_entropy": -(probs * torch.log(probs + 1e-9)).sum(-1).mean(),
        "lb_loss": e * torch.mean(probs.mean((0, 1)) * counts / max(t * k, 1)),
    }
    if cfg.n_shared:
        out = out + swiglu(params["shared"], x)
    return out.to(x.dtype), aux
