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
by autograd like any other operation.  On DTensor inputs (a sharded
step) it runs the kernel on each rank's local heads and batch rows
(``local_map``), and ``chunked_cross_entropy`` takes the reference's
``shard_logits`` hook.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..distributed.sharding import is_dtensor
from ..kernels.flash_attention import flash_attention
from ..obs import loop_scope
from ..kernels.flash_attention.ops import HEAD_DIMS, HEAD_PAIRS

__all__ = [
    "dense_init", "dense", "pinned", "sharded_lookup", "rmsnorm_init", "rmsnorm", "layernorm_init", "layernorm",
    "rope_frequencies", "apply_rope", "blockwise_attention", "swiglu_init", "swiglu",
    "geglu_init", "geglu", "mlp_init", "mlp_apply", "cross_entropy_loss",
    "chunked_cross_entropy", "cache_write", "split_heads", "whole",
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


def whole(x, *dims):
    """``x`` with the dimensions ``dims`` unsplit: a DTensor split on any
    of them is gathered there (DTensor's view rules refuse to flatten,
    slice or index a split dimension); a tensor as it is."""
    if not is_dtensor(x) or not any(p.is_shard(d % x.ndim) for p in x.placements for d in dims):
        return x
    from torch.distributed.tensor import Replicate

    dims = {d % x.ndim for d in dims}
    return x.redistribute(x.device_mesh, tuple(Replicate() if p.is_shard() and p.dim in dims else p
                                               for p in x.placements))


def pinned(x):
    """``x`` itself; on a DTensor, its gradient comes back laid out as ``x``
    is (a redistribution to its own placements, whose backward
    redistributes the gradient).  Applied to a view's output, the view's
    backward never meets a gradient split where the view's output is not
    (the card's DTensor refuses to split or flatten a split dimension)."""
    return x.redistribute(x.device_mesh, x.placements) if is_dtensor(x) else x


def dense(w, x):
    if x.ndim >= 3:  # the product flattens the leading dimensions: only the first may stay split
        x = whole(x, *range(1, x.ndim - 1))
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
    normalizer does.  A width the kernel is instantiated for (``HEAD_DIMS``:
    16, 32, 64, 128, 192; the LM examples' 64 among them) with v as wide,
    and a (D, Dv) pair (``HEAD_PAIRS``: MLA's q/k 192 with v 128), go in
    as they are.  Other widths are zero-padded along D to the narrowest
    of ``HEAD_DIMS`` that holds ``max(D, Dv)`` (MLA's reduced 24 and 16
    run at 32), and the output is cut back to ``Dv``: zero columns of
    ``v`` add nothing, zero columns of ``q`` and ``k`` leave ``q·k``
    unchanged, and the scale stays 1/sqrt(D).  A width past the widest
    is left as it is (the plain version takes it; the card raises).
    ``kv_block`` is the reference's scan chunk and is ignored: the kernel
    tiles the keys itself.  Unlike the reference's jnp body, the
    probabilities are not rounded to the inputs' type in P·V: fp32 (as
    in the TPU kernel), or on the card's bf16 prefill two bf16 terms,
    P_hi·V + P_lo·V (P to about 16 bits), so bf16 results differ by that
    rounding.

    DTensor inputs (``q``, ``k``, ``v`` on one mesh) run as
    ``_sharded_attention`` says: each rank attends its own batch rows
    and heads with the kernel, and the output is a DTensor with q's
    layout."""
    del kv_block
    if is_dtensor(q):
        return _sharded_attention(q, k, v, causal=causal, window=window, q_offset=q_offset, valid_len=valid_len)
    return _attention(q, k, v, causal, window, q_offset, valid_len)


def _attention(q, k, v, causal, window, q_offset, valid_len):
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


def split_heads(x, b: int, s: int, n: int, d: int):
    """(B, S, n*d) -> the (B, n, S, d) view the kernel reads in place.  A
    DTensor whose last dimension is split over ranks that do not divide
    ``n`` has that dimension gathered first (DTensor cannot split a
    dimension into heads that do not divide over its ranks)."""
    if is_dtensor(x) and n % math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements) if p.is_shard(2)):
        x = whole(x, 2)
    return x.view(b, s, n, d).transpose(1, 2)


def cache_write(cache, dim: int, pos: int, new):
    """Write ``new`` (the cache's shape with 1 at ``dim``) at position
    ``pos`` of ``dim``, in place; returns the cache that attention reads.

    A plain tensor: ``cache`` itself.  A DTensor: ``new`` is laid out as
    the cache with ``dim`` whole and written into this rank's local
    shard.  Where ``dim`` (the sequence) is sharded, over one mesh
    dimension or several (split major first), only the rank that owns
    ``pos`` writes, and the return is the cache with ``dim`` gathered on
    every rank (the reference's semantics: the layer's keys gathered
    before attention)."""
    if not is_dtensor(cache):
        cache.select(dim, pos).copy_(new.select(dim, 0).to(cache.dtype))
        return cache
    from torch.distributed.tensor import Replicate

    mesh, pl = cache.device_mesh, cache.placements
    unsplit = tuple(Replicate() if p.is_shard(dim) else p for p in pl)
    value = new.redistribute(mesh, unsplit).to_local().select(dim, 0)
    local = cache.to_local()
    owners = [i for i, p in enumerate(pl) if p.is_shard(dim)]
    if not owners:
        local.select(dim, pos).copy_(value.to(local.dtype))
        return cache
    n, shard = 1, 0
    for axis in owners:  # this rank's shard index over the owning dimensions, major first
        n *= mesh.size(axis)
        shard = shard * mesh.size(axis) + mesh.get_local_rank(axis)
    if cache.shape[dim] % n:
        raise ValueError(f"a cache of {cache.shape[dim]} positions does not split over {n} ranks")
    per = cache.shape[dim] // n
    if shard == pos // per:
        local.select(dim, pos % per).copy_(value.to(local.dtype))
    return cache.redistribute(mesh, unsplit)


def _row_offset(mesh, dims, n_rows: int) -> int:
    """This rank's first row of a table split by rows over the mesh
    dimensions ``dims`` (major first, as DTensor splits)."""
    lo, per = 0, n_rows
    for i in dims:
        per //= mesh.size(i)
        lo += mesh.get_local_rank(i) * per
    return lo


def sharded_lookup(table, ids, *, bag: bool = False):
    """``table[ids]`` (or, ``bag``, the (B, D) fp32 bag sums of
    ``embedding_bag``'s ``sum`` combiner) of a DTensor table, through a
    ``local_map``: the ids gathered over the mesh dimensions that split
    the table, each rank's rows looked up (ids outside them give zero;
    padding to the kernel), a ``Partial`` sum over the dimensions that
    split the rows, a column split kept; then laid out as the batch (the
    ids' split of dimension 0, replicated elsewhere).  The table's
    gradient is each rank's scatter of its rows, a ``Partial`` sum over
    the dimensions that split only the batch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..kernels.embedding_bag import embedding_bag

    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    t_pl, i_pl = table.placements, ids.placements
    rows = [i for i, p in enumerate(t_pl) if p.is_shard(0)]
    cols = [i for i, p in enumerate(t_pl) if p.is_shard(1)]
    ids_in = tuple(Replicate() if i in rows or i in cols else p for i, p in enumerate(i_pl))
    last = 1 if bag else ids.ndim
    out_pl = [Partial() if i in rows else Shard(last) if i in cols else ids_in[i] for i in range(mesh.ndim)]
    grad_pl = tuple(p if i in rows or i in cols else (Partial() if ids_in[i].is_shard() else Replicate())
                    for i, p in enumerate(t_pl))
    n_rows = table.shape[0]

    def local(t, idx):
        j = idx.long() - _row_offset(mesh, rows, n_rows)
        mine = (j >= 0) & (j < t.shape[0])
        if bag:
            return embedding_bag(t, torch.where(mine, j, -1).to(torch.int32).contiguous(), combiner="sum")
        got = t[j.clamp(0, t.shape[0] - 1)]
        return torch.where(mine[..., None], got, torch.zeros((), dtype=got.dtype, device=got.device))

    out = local_map(local, out_placements=out_pl, in_placements=(t_pl, ids_in), in_grad_placements=(grad_pl, ids_in),
                    device_mesh=mesh, redistribute_inputs=True)(table, ids)
    return out.redistribute(mesh, [Shard(0) if p.is_shard(0) else Replicate() for p in i_pl])


def _kv_heads_of(hq: int, hkv: int, lo: int, hi: int):
    """The kv heads that query heads ``[lo, hi)`` read (head i reads
    ``i // (hq / hkv)``): a slice when they read one head or whole
    groups, else an index of one kv head a query head."""
    group = hq // hkv
    first, last = lo // group, (hi - 1) // group + 1
    if last - first == 1 or (lo % group == 0 and hi % group == 0):
        return slice(first, last)
    return torch.arange(lo, hi) // group


def _sharded_attention(q, k, v, *, causal, window, q_offset, valid_len):
    """Attention on DTensors: the batch over the data axes and the heads
    over ``"model"`` where they divide (the layout the reference's
    ``shard_qkv`` pins), k and v over ``"model"`` only where q's heads
    are and their own divide, else replicated.  Each rank runs the
    kernel (``flash_attention``, its plain version on a CPU tensor) on
    plain local tensors: its batch rows, its query heads and the kv
    heads those read (``_kv_heads_of``).  The output has q's layout.  A
    replicated k or v whose kv heads the ranks split gets a gradient
    summed over ``"model"`` (each rank's part: ``Partial``)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from ..distributed.sharding import axis_size, data_axes, mesh_coordinate, named

    mesh = q.device_mesh
    dp = data_axes(mesh)
    model = axis_size(mesh, "model") if "model" in mesh.mesh_dim_names else 1
    b, hq, hkv = q.shape[0], q.shape[1], k.shape[1]
    b_ax = (dp if len(dp) > 1 else dp[0]) if b % axis_size(mesh, dp) == 0 else None
    q_h = "model" if model > 1 and hq % model == 0 else None
    kv_h = "model" if q_h and hkv % model == 0 else None
    q_pl, kv_pl = named(mesh, b_ax, q_h, None, None), named(mesh, b_ax, kv_h, None, None)
    kv_grad = kv_pl
    if q_h and not kv_h:
        kv_grad = tuple(Partial() if n == "model" else p for n, p in zip(mesh.mesh_dim_names, kv_pl))

    def local(ql, kl, vl):
        if q_h and not kv_h:  # the kv heads this rank's query heads read
            lo = mesh_coordinate(mesh, "model") * ql.shape[1]
            heads = _kv_heads_of(hq, hkv, lo, lo + ql.shape[1])
            kl, vl = kl[:, heads], vl[:, heads]
        return _attention(ql, kl, vl, causal, window, q_offset, valid_len)

    return local_map(local, out_placements=list(q_pl), in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


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


def _chunk_nll(w_head, hc, lc, shard_logits=None):
    """Summed token NLL of one chunk: hc (B, C, D), lc (B, C)."""
    logits = dense(w_head, hc)
    if shard_logits is not None:
        logits = shard_logits(logits)
    lf = logits.to(torch.float32)
    if not is_dtensor(lf):
        gold = torch.gather(lf, -1, lc[..., None].long())[..., 0]
        return torch.sum(torch.logsumexp(lf, dim=-1) - gold)
    # a split vocabulary: the log-sum-exp from a max, a sum and a log (reductions
    # across the split), the label's logit picked on the rank that holds it
    m = lf.detach().amax(dim=-1, keepdim=True)
    logz = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    return torch.sum(logz - _gold(lf, lc))


def _gold(lf, labels):
    """The label's logit of DTensor logits lf (B, C, V) whose vocabulary
    may be split: each rank picks the labels in its own vocabulary range
    (0 elsewhere), a ``Partial`` sum over the ranks that split it."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = lf.device_mesh
    vocab = lf.shape[-1]
    split = [i for i, p in enumerate(lf.placements) if p.is_shard(2)]
    lab_pl = tuple(Replicate() if p.is_shard(2) else p for p in lf.placements)
    out_pl = [Partial() if p.is_shard(2) else p for p in lf.placements]

    def pick(ll, lab):
        lo = 0
        for i in split:  # this rank's first vocabulary entry (major axis first)
            per = vocab // math.prod(mesh.size(j) for j in split[: split.index(i) + 1])
            lo += mesh.get_local_rank(i) * per
        idx = lab.long() - lo
        mine = (idx >= 0) & (idx < ll.shape[-1])
        got = torch.gather(ll, -1, idx.clamp(0, ll.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(mine, got, torch.zeros((), dtype=got.dtype, device=got.device))

    if any(vocab % mesh.size(i) for i in split):
        raise ValueError(f"a vocabulary of {vocab} does not split evenly over {[mesh.size(i) for i in split]}")
    return local_map(pick, out_placements=out_pl, in_placements=(lf.placements, lab_pl), device_mesh=mesh,
                     redistribute_inputs=True)(lf, labels)


def chunked_cross_entropy(
    w_head: torch.Tensor,     # (D, V)
    h: torch.Tensor,          # (B, S, D) final hidden states
    labels: torch.Tensor,     # (B, S)
    *,
    chunk: int = 512,
    shard_logits=None,
) -> torch.Tensor:
    """LM loss without the full (B, S, V) fp32 logits: a loop over
    sequence chunks, each chunk's logits alive only inside its turn.
    Under grad mode each chunk runs under ``torch.utils.checkpoint``, so
    the backward recomputes its logits instead of keeping them (the
    reference's ``jax.checkpoint(body)``; llama3-8b's (8, 4096, 128256)
    fp32 logits would otherwise be 16.8 GB).  ``shard_logits`` (the
    reference's hook) lays out each chunk's (B, C, V) logits, on
    DTensors: batch over the data axes, vocabulary over ``"model"``."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    h = whole(h, 1)  # chunks of the sequence: a split sequence is gathered first
    remat = torch.is_grad_enabled() and (h.requires_grad or w_head.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    with loop_scope("lm.ce_chunks"):
        for c in range(0, s, chunk):
            hc, lc = h[:, c : c + chunk], labels[:, c : c + chunk]
            if remat:
                total = total + checkpoint(_chunk_nll, w_head, hc, lc, shard_logits, use_reentrant=False,
                                           preserve_rng_state=False)
            else:
                total = total + _chunk_nll(w_head, hc, lc, shard_logits)
    return total / (b * s)
