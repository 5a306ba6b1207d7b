"""Graph attention network (GAT, Veličković et al. 2018), port of
``repro.models.gnn``.

Message passing over an explicit edge list, as the reference: SDDMM
(edge scores) -> segment softmax -> scatter-SpMM.  The reference's
``segment_max`` and ``segment_sum`` are ``scatter_reduce(...,
"amax", include_self=False)`` and ``index_add``; the batched form (the
molecule shape) is the disjoint union of the B graphs, node ids offset
by b·N, which gives the reference's ``vmap`` exactly (no edge crosses
two graphs, so every per-destination softmax is the same).  Supports
full graphs and padded sampled subgraphs from the neighbor sampler
(``data.graph_sampler``), with edge and label masks.

Sharded (``launch.steps.build_gnn_train``'s cells, DTensor inputs):
edges split over the mesh (``src`` a DTensor) run each layer as
``_gat_layer_edges`` says: every rank scores its own edges against the
replicated nodes, the per-destination max is all-reduced with MAX
before the exponentials, and the softmax denominators and the
aggregated messages are summed across the ranks (the reference gets
these from GSPMD; here they are explicit).  Batched graphs split by
batch (the molecule shape) run each rank's graphs on their own.

Parameters are the reference's pytree as a dict of tensors,
``{"layers": [{"w", "a_src", "a_dst"}, ...]}``; ``gnn_from_jax``
carries the reference's own across.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; the forward runs where the
parameters lie and takes features and edges as numpy arrays or
tensors.  The products are ``torch.matmul`` and PyTorch's scatters, as
the reference leaves them to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import exact_fp32, resolve_device
from ..distributed.sharding import is_dtensor
from .layers import dense, dense_init

__all__ = ["GATConfig", "gat_init", "gat_layer", "gat_forward", "gat_loss", "gat_forward_batched", "gnn_from_jax"]

F32 = torch.float32


@dataclass(frozen=True)
class GATConfig:
    d_in: int
    d_hidden: int            # per-head hidden dim (cora: 8)
    n_heads: int             # (cora: 8)
    n_layers: int = 2
    n_classes: int = 7
    negative_slope: float = 0.2
    dtype: torch.dtype = torch.float32


def _layer_dims(cfg: GATConfig, li: int):
    last = li == cfg.n_layers - 1
    return (1, cfg.n_classes) if last else (cfg.n_heads, cfg.d_hidden)


def gat_init(seed_or_generator, cfg: GATConfig, device=None):
    """Random parameters as the reference's ``gat_init`` draws them
    (dense normal / sqrt(fan-in), attention vectors normal * 0.1), from
    a ``torch.Generator`` on ``device`` (``cuda`` unless ``"cpu"``):
    other numbers than ``jax.random``'s."""
    dev = resolve_device(device)
    gen = (seed_or_generator if isinstance(seed_or_generator, torch.Generator)
           else torch.Generator(device=dev).manual_seed(int(seed_or_generator)))
    layers, d_in = [], cfg.d_in
    for li in range(cfg.n_layers):
        heads, d_out = _layer_dims(cfg, li)
        layers.append({
            "w": dense_init(gen, d_in, heads * d_out, cfg.dtype, device=dev),
            "a_src": (torch.randn((heads, d_out), generator=gen, dtype=F32, device=dev) * 0.1).to(cfg.dtype),
            "a_dst": (torch.randn((heads, d_out), generator=gen, dtype=F32, device=dev) * 0.1).to(cfg.dtype),
        })
        d_in = heads * d_out
    return {"layers": layers}


def gnn_from_jax(params, device=None):
    """The reference's GAT pytree (arrays as numpy, or anything
    ``np.asarray`` takes) as the port's dict of tensors on ``device``
    (``cuda`` unless ``"cpu"``), each leaf in its own dtype."""
    dev = resolve_device(device)
    return {"layers": [{k: torch.from_numpy(np.array(v)).to(dev) for k, v in layer.items()}
                       for layer in params["layers"]]}


def _edge_softmax(scores, dst, n_nodes):
    """Per-destination softmax over edge scores (E, H).  The shift by the
    segment max is taken as a constant (detached): it cancels in the
    softmax, so its exact gradient is 0, and the reference's
    ``segment_max`` and ``scatter_reduce("amax")`` would hand rounding
    noise to different entries where scores tie."""
    heads = scores.shape[1]
    smax = torch.full((n_nodes, heads), -torch.inf, dtype=scores.dtype, device=scores.device)
    smax = smax.scatter_reduce(0, dst[:, None].expand(-1, heads), scores.detach(), "amax", include_self=False)
    ex = torch.exp(scores - smax[dst])
    denom = torch.zeros((n_nodes, heads), dtype=ex.dtype, device=ex.device).index_add(0, dst, ex)
    return ex / torch.clamp(denom[dst], min=1e-16)


def _gat_layer_edges(p, x, src, dst, n_nodes, *, heads, d_out, slope, edge_mask=None):
    """``gat_layer`` with the edges split over the ranks (``src``,
    ``dst``, ``edge_mask`` DTensors split on dimension 0) and the nodes
    replicated: three ``local_map``s over each rank's edges, between
    them the MAX all-reduce of the per-destination maxima and the SUM
    all-reduce of the denominators; the messages are summed across the
    ranks last.  A replicated input's gradient from each rank's edges is
    a ``Partial`` sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = src.device_mesh
    rep, e_pl = [Replicate()] * mesh.ndim, src.placements
    part = [Partial()] * mesh.ndim
    if edge_mask is None:
        edge_mask = DTensor.from_local(torch.ones(src.to_local().shape, dtype=torch.bool, device=src.device), mesh,
                                       e_pl, run_check=False)
    h = dense(p["w"], x).reshape(-1, heads, d_out)                  # (N, H, D), replicated
    e_src = (h * p["a_src"].to(h.dtype)[None]).sum(-1)              # (N, H)
    e_dst = (h * p["a_dst"].to(h.dtype)[None]).sum(-1)

    def scores_and_max(es, ed, s, d, m):
        sc = F.leaky_relu((es[s] + ed[d]).to(F32), slope)
        sc = torch.where(m[:, None], sc, torch.full_like(sc, -1e30))
        smax = torch.full((n_nodes, heads), -torch.inf, dtype=sc.dtype, device=sc.device)
        return sc, smax.scatter_reduce(0, d[:, None].expand(-1, heads), sc.detach(), "amax", include_self=False)

    scores, smax = local_map(scores_and_max, out_placements=(e_pl, [Partial("max")] * mesh.ndim),
                             in_placements=(rep, rep, e_pl, e_pl, e_pl),
                             in_grad_placements=(part, part, e_pl, e_pl, e_pl), device_mesh=mesh,
                             redistribute_inputs=True)(e_src, e_dst, src, dst, edge_mask)
    smax = smax.redistribute(mesh, rep)                             # the MAX all-reduce

    def exps(sc, mx, d):
        ex = torch.exp(sc - mx[d])
        return ex, torch.zeros((n_nodes, heads), dtype=ex.dtype, device=ex.device).index_add(0, d, ex)

    ex, denom = local_map(exps, out_placements=(e_pl, part), in_placements=(e_pl, rep, e_pl),
                          in_grad_placements=(e_pl, rep, e_pl), device_mesh=mesh, redistribute_inputs=True)(
        scores, smax.detach(), dst)
    denom = denom.redistribute(mesh, rep)                           # the SUM all-reduce

    def messages(ex, den, hh, s, d, m):
        attn = torch.where(m[:, None], ex / torch.clamp(den[d], min=1e-16), torch.zeros_like(ex))
        msgs = hh[s].to(F32) * attn[:, :, None]
        return torch.zeros((n_nodes, heads, d_out), dtype=F32, device=ex.device).index_add(0, d, msgs)

    agg = local_map(messages, out_placements=part, in_placements=(e_pl, rep, rep, e_pl, e_pl, e_pl),
                    in_grad_placements=(e_pl, part, part, e_pl, e_pl, e_pl), device_mesh=mesh,
                    redistribute_inputs=True)(ex, denom, h, src, dst, edge_mask)
    agg = agg.redistribute(mesh, rep)                               # the messages summed across ranks
    return agg.reshape(n_nodes, heads * d_out).to(x.dtype)


def gat_layer(p, x, src, dst, n_nodes, *, heads, d_out, slope, edge_mask=None):
    """x (N, d_in); src/dst (E,) integer -> (N, heads*d_out).  Edges
    split over ranks (DTensors): ``_gat_layer_edges``."""
    if is_dtensor(src):
        return _gat_layer_edges(p, x, src, dst, n_nodes, heads=heads, d_out=d_out, slope=slope, edge_mask=edge_mask)
    h = dense(p["w"], x).reshape(-1, heads, d_out)                  # (N, H, D)

    e_src = (h * p["a_src"].to(h.dtype)[None]).sum(-1)              # (N, H)
    e_dst = (h * p["a_dst"].to(h.dtype)[None]).sum(-1)
    scores = e_src[src] + e_dst[dst]                                # (E, H)
    scores = F.leaky_relu(scores.to(F32), slope)
    if edge_mask is not None:
        scores = torch.where(edge_mask[:, None], scores, torch.full_like(scores, -1e30))
    attn = _edge_softmax(scores, dst, n_nodes)                      # (E, H)
    if edge_mask is not None:
        attn = torch.where(edge_mask[:, None], attn, torch.zeros_like(attn))
    msgs = h[src].to(F32) * attn[:, :, None]                        # (E, H, D)
    agg = torch.zeros((n_nodes, heads, d_out), dtype=F32, device=x.device).index_add(0, dst, msgs)
    return agg.reshape(n_nodes, heads * d_out).to(x.dtype)


def _device(params):
    return params["layers"][0]["w"].device


def _index(a, dev):
    return torch.as_tensor(a, device=dev).long()


def gat_forward(params, cfg: GATConfig, feats, src, dst, *, edge_mask=None):
    """Full forward -> per-node class logits (N, n_classes)."""
    exact_fp32()
    dev = _device(params)
    x = torch.as_tensor(feats, device=dev).to(cfg.dtype)
    src, dst = _index(src, dev), _index(dst, dev)
    if edge_mask is not None:
        edge_mask = torch.as_tensor(edge_mask, device=dev).bool()
    n = x.shape[0]
    for li, p in enumerate(params["layers"]):
        heads, d_out = _layer_dims(cfg, li)
        x = gat_layer(p, x, src, dst, n, heads=heads, d_out=d_out, slope=cfg.negative_slope, edge_mask=edge_mask)
        if li < cfg.n_layers - 1:
            x = F.elu(x.to(F32)).to(cfg.dtype)
    return x


def gat_loss(params, cfg: GATConfig, feats, src, dst, labels, *, label_mask=None, edge_mask=None):
    """Mean node NLL (over ``label_mask``'s weights when given)."""
    logits = gat_forward(params, cfg, feats, src, dst, edge_mask=edge_mask).to(F32)
    labels = _index(labels, logits.device)
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels[:, None])[:, 0]
    if label_mask is not None:
        label_mask = torch.as_tensor(label_mask, device=logits.device).to(F32)
        return (nll * label_mask).sum() / torch.clamp(label_mask.sum(), min=1)
    return nll.mean()


def gat_forward_batched(params, cfg: GATConfig, feats, src, dst):
    """Batched small graphs (the molecule shape): feats (B, N, d), src/dst
    (B, E) -> graph logits (B, n_classes), the mean of each graph's node
    logits.  The B graphs run as one disjoint union (node ids offset by
    b·N), which equals the reference's ``vmap`` over the batch.  A
    DTensor batch split over ranks: each rank's graphs on their own (a
    ``local_map``; the parameters' gradient a ``Partial`` sum)."""
    if is_dtensor(feats):
        return _batched_local(params, cfg, feats, src, dst)
    dev = _device(params)
    feats = torch.as_tensor(feats, device=dev)
    b, n = feats.shape[:2]
    off = torch.arange(b, device=dev)[:, None] * n
    src, dst = (_index(src, dev) + off).reshape(-1), (_index(dst, dev) + off).reshape(-1)
    logits = gat_forward(params, cfg, feats.reshape(b * n, -1), src, dst)
    return logits.reshape(b, n, -1).mean(dim=1)


def _batched_local(params, cfg: GATConfig, feats, src, dst):
    """``gat_forward_batched`` on each rank's graphs (the batch split on
    dimension 0 of ``feats``, ``src`` and ``dst``)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = feats.device_mesh
    b_pl = [p if p.is_shard(0) else Replicate() for p in feats.placements]
    leaves = [leaf for layer in params["layers"] for leaf in (layer["w"], layer["a_src"], layer["a_dst"])]
    rep, grad = [Replicate()] * mesh.ndim, [Partial() if p.is_shard(0) else Replicate() for p in b_pl]

    def local(f, s, d, *flat):
        layers = [dict(zip(("w", "a_src", "a_dst"), flat[i : i + 3])) for i in range(0, len(flat), 3)]
        return gat_forward_batched({"layers": layers}, cfg, f, s, d)

    return local_map(local, out_placements=b_pl, in_placements=(b_pl, b_pl, b_pl, *[rep] * len(leaves)),
                     in_grad_placements=(b_pl, b_pl, b_pl, *[grad] * len(leaves)), device_mesh=mesh,
                     redistribute_inputs=True)(feats, src, dst, *leaves)
