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

The reference's sharding hooks (``shard_tokens``, ``shard_entries``,
``shard_dispatch``, ``shard_buffers``) and ``groups`` are its fields;
``moe_apply`` says what they do on DTensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..distributed.sharding import is_dtensor
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
    shard_buffers: Optional[Callable] = None   # hook: (G,E,C,d) expert-compute layout
    shard_dispatch: Optional[Callable] = None  # hook: (G,E,C,d) scatter/gather layout
    shard_tokens: Optional[Callable] = None    # hook: (G,T,d) layout
    shard_entries: Optional[Callable] = None   # hook: (G,T*k,d) layout
    dtype: torch.dtype = torch.float32


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


def _bookkeeping(router, xg, cfg: MoEConfig, cap: int):
    """Each group's routing, slots and capacity bound on its own tokens
    xg (G, Tg, d): (probs (G, Tg, E), gate values (G, Tg·k), the flat
    buffer row of each entry (G, Tg·k) into (G·E·C) rows, keep (G,
    Tg·k), expert counts (G, E), entries (G, Tg·k, d): each entry's
    token, zeros where dropped)."""
    g, tg, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, gate_vals, expert_idx = route(router, cfg, xg)
    flat_expert = expert_idx.reshape(g, tg * k)                       # (G, TK), token-major, k-minor
    onehot = F.one_hot(flat_expert, e)                                 # (G, TK, E)
    ranks = torch.cumsum(onehot, dim=1) - onehot                       # entries before me, per group
    slot = torch.gather(ranks, 2, flat_expert[..., None])[..., 0]
    keep = slot < cap
    safe_slot = torch.where(keep, slot, cap - 1)
    token_of_entry = torch.arange(tg, device=xg.device).repeat_interleave(k)   # (TK,)
    entries = xg[:, token_of_entry] * keep[..., None].to(xg.dtype)    # (G, TK, d)
    flat = (torch.arange(g, device=xg.device)[:, None] * e + flat_expert) * cap + safe_slot   # (G, TK)
    return probs, gate_vals.reshape(g, tg * k), flat, keep, onehot.sum(1), entries


def _dispatch(entries, flat, e: int, cap: int):
    """buf (G, E, C, d): buf[g, expert, slot] = the entry's token;
    dropped entries add zeros at slot ``cap - 1``."""
    g, _, d = entries.shape
    buf = torch.zeros((g * e * cap, d), dtype=entries.dtype, device=entries.device)
    buf.index_put_((flat.reshape(-1),), entries.reshape(-1, d), accumulate=True)
    return buf.view(g, e, cap, d)


def _combine(y, flat, keep, gate_vals, k: int):
    """The gate-weighted expert outputs y (G, E, C, d) scatter-added to
    their tokens in fp32 -> (G, Tg, d) fp32."""
    g, _, _, d = y.shape
    tg = flat.shape[1] // k
    gathered = y.reshape(-1, d)[flat.reshape(-1)].view(g, tg * k, d) * keep[..., None].to(y.dtype)
    weighted = gathered.to(torch.float32) * gate_vals[..., None]
    token_of_entry = torch.arange(tg, device=y.device).repeat_interleave(k)
    tok = (torch.arange(g, device=y.device)[:, None] * tg + token_of_entry).reshape(-1)
    out = torch.zeros((g * tg, d), dtype=torch.float32, device=y.device)
    out.index_add_(0, tok, weighted.reshape(-1, d))
    return out.view(g, tg, d)


def _experts(wi_gate, wi_up, wo, buf, dtype):
    """The expert SwiGLUs on buf (G, E, C, d): (E, G·C, d) against (E,
    d, f) in the weights' type -> (G, E, C, d) in ``dtype``."""
    g, e, cap, d = buf.shape
    wdt = wi_gate.dtype
    xe = buf.transpose(0, 1).reshape(e, g * cap, d).to(wdt)
    h = F.silu(torch.matmul(xe, wi_gate).to(torch.float32))
    h.mul_(torch.matmul(xe, wi_up))
    y = torch.matmul(h.to(wdt), wo).to(dtype)                        # (E, G·C, d)
    del xe, h
    return y.view(e, g, cap, d).transpose(0, 1)


def _flatten_groups(out):
    """(G, Tg, d) -> (G·Tg, d)."""
    return out.reshape(-1, out.shape[-1])


class _GroupLayouts:
    """The layouts of ``moe_apply``'s group-local steps on a DTensor xg
    (G, Tg, d): each step's (input placements, their gradients' (None:
    as the input), output placements), for ``local_map``.  Groups go
    over the data axes where they divide (``grp``), else every rank
    holds them all; a replicated input whose local gradient is a part
    of a sum over the groups or over the slices of d or f is ``Partial``
    there."""

    def __init__(self, xg, g: int, n_experts: int):
        from torch.distributed.tensor import Partial, Replicate, Shard

        from ..distributed.sharding import axis_size, data_axes

        mesh = xg.device_mesh
        self.names, dp = mesh.mesh_dim_names, data_axes(mesh)
        split = g % axis_size(mesh, dp) == 0
        self.grp = tuple(Shard(0) if split and n in dp else Replicate() for n in self.names)
        self.whole = (Replicate(),) * len(self.names)
        self.summed = tuple(Partial() if split and n in dp else Replicate() for n in self.names)
        self.ep = "model" in self.names and n_experts % axis_size(mesh, "model") == 0

    @staticmethod
    def moved(placements, frm: int, to: int):
        from torch.distributed.tensor import Shard

        return tuple(Shard(to) if p.is_shard(frm) else p for p in placements)

    def on(self, name: str, placement, base):
        """``base`` with ``placement`` on the mesh axis ``name``."""
        return tuple(placement if n == name else p for n, p in zip(self.names, base))

    def bookkeeping(self):  # the router whole; its gradient a sum over the groups
        return (self.whole, self.grp), (self.summed, None), (self.grp,) * 6

    def dispatch(self, entries):  # d may be split (expert parallel's shard_entries)
        ent = entries.placements
        return (ent, self.grp), (None, None), self.moved(ent, 2, 3)

    def experts(self):
        from torch.distributed.tensor import Partial, Shard

        if self.ep:  # each rank's experts on its groups: the weights gathered over the data axes
            w, wg = self.on("model", Shard(0), self.whole), self.on("model", Shard(0), self.summed)
            buf = self.on("model", Shard(1), self.grp)
            return (w, w, w, buf), (wg, wg, wg, None), buf
        # tensor parallel: each rank's slice of f; the down projection's output a sum over "model"
        w_in = tuple(self.on("model", Shard(dim), self.whole) for dim in (2, 2, 1))
        w_grad = tuple(self.on("model", Shard(dim), self.summed) for dim in (2, 2, 1))
        part = self.on("model", Partial(), self.grp)
        return (*w_in, self.grp), (*w_grad, part), part

    def combine(self, y):  # every expert's slots of the groups; d may stay split
        from torch.distributed.tensor import Partial, Replicate

        y_in = tuple(Replicate() if p.is_partial() or p.is_shard(1) else p for p in y.placements)
        gate = tuple(Partial() if q.is_shard(3) else p for p, q in zip(self.grp, y_in))
        return (y_in, self.grp, self.grp, self.grp), (None, None, None, gate), self.moved(y_in, 3, 2)

    def flatten(self, out):
        pl = out.placements
        return (pl,), (None,), self.moved(pl, 2, 1)


def _local(layout, fn, *tensors):
    """``fn(*tensors)``; with a layout (in, grad, out placements) on
    each rank's local shards of the DTensors (``local_map``)."""
    if layout is None:
        return fn(*tensors)
    from torch.distributed.tensor.experimental import local_map

    ins, grads, outs = layout
    mesh = next(t.device_mesh for t in tensors if is_dtensor(t))
    grads = tuple(g or p for g, p in zip(grads, ins))
    outs = outs if isinstance(outs[0], tuple) else list(outs)  # one output: a list of placements
    return local_map(fn, out_placements=outs, in_placements=ins, in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*tensors)


def _identity(x):
    return x


def moe_apply(params, cfg: MoEConfig, x: torch.Tensor):
    """x (T, d) -> ((T, d) in ``x.dtype``, aux dict of 0-d fp32 tensors:
    ``drop_fraction``, ``router_entropy``, ``lb_loss``).  T must divide
    by ``cfg.groups``.

    The hooks lay out the tokens (G, Tg, d), the entries (G, T·k, d) and
    the (G, E, C, d) buffers, at the reference's points.  On DTensors (a
    sharded step: ``launch.steps._moe_group_config`` sets ``groups`` to
    the data shards and the hooks) the routing, the slots, the capacity
    bound, the scatter, the expert GEMMs and the combine run on each
    rank's own groups (over the data axes where they divide), each a
    ``local_map`` of the function that the single-device path calls
    (``_GroupLayouts``).  From ``shard_dispatch``'s layout (d over
    ``"model"``) to ``shard_buffers``' (E over ``"model"``) is the
    expert-parallel exchange, a DTensor redistribution.  Expert parallel
    (the experts divide ``"model"``): each rank runs its own experts with
    their weights gathered over the data axes.  Tensor parallel: its
    slice of every expert's hidden width f, the down projection's output
    a ``Partial`` sum over ``"model"`` (the reference's Megatron pair).
    A weight's gradient is each rank's part, summed into its layout."""
    t, d = x.shape
    g, e, k = cfg.groups, cfg.n_experts, cfg.top_k
    if t % g:
        raise ValueError(f"{t} tokens do not divide into {g} groups")
    tg = t // g
    cap = _capacity(tg, cfg)
    shard_tok, shard_ent, shard_disp, shard_buf = (
        h or _identity for h in (cfg.shard_tokens, cfg.shard_entries, cfg.shard_dispatch, cfg.shard_buffers))

    xg = shard_tok(x.reshape(g, tg, d))
    lay = _GroupLayouts(xg, g, e) if is_dtensor(xg) else None
    probs, gate_vals, flat, keep, counts, entries = _local(
        lay and lay.bookkeeping(), lambda r, xl: _bookkeeping(r, xl, cfg, cap), params["router"], xg)
    entries = shard_ent(entries)
    buf = _local(lay and lay.dispatch(entries), lambda en, fl: _dispatch(en, fl, e, cap), entries, flat)
    # the scatter partitions on (G, d); the experts want (G, E): the expert-parallel exchange
    buf = shard_buf(shard_disp(buf))
    y = _local(lay and lay.experts(), lambda a, b, c, xl: _experts(a, b, c, xl, x.dtype),
               params["wi_gate"], params["wi_up"], params["wo"], buf)
    y = shard_disp(shard_buf(y))  # and back
    out = _local(lay and lay.combine(y), lambda yl, fl, kl, gl: _combine(yl, fl, kl, gl, k), y, flat, keep, gate_vals)
    out = shard_tok(out.to(x.dtype))
    out = _local(lay and lay.flatten(out), _flatten_groups, out)  # DTensor's view rules refuse a split dimension

    aux = {
        "drop_fraction": 1.0 - keep.to(torch.float32).mean(),
        "router_entropy": -(probs * torch.log(probs + 1e-9)).sum(-1).mean(),
        "lb_loss": e * torch.mean(probs.mean((0, 1)) * counts.sum(0).to(torch.float32) / max(t * k, 1)),
    }
    if cfg.n_shared:
        out = out + swiglu(params["shared"], x)
    return out.to(x.dtype), aux
