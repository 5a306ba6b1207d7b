"""RecSys ranking models (port of ``repro.models.recsys``): DeepFM,
AutoInt, DIEN (GRU + AUGRU), BST, the shared embedding substrate and
retrieval scoring.

Each model is a config dataclass, an ``nn.Module`` holding the
reference's parameter pytree under the reference's names (a dict's
tensors are parameters, its dicts and lists sub-modules: ``p["mlp"][0]
["w"]`` reads as in the reference), ``*_init(seed_or_generator, cfg,
device=None)`` and ``*_forward``.  ``recsys_from_jax`` carries the
reference's parameters across.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; the forward functions run where the
parameters lie and take ids as numpy arrays or tensors.

Lookups are row gathers (``table[ids]``, the reference's ``jnp.take``):
ids must lie in [0, V).  ``bst_user_embedding`` runs the
``embedding_bag`` kernel (one launch a call; the reference's ``take`` +
mean over the history); the GEMMs, the per-field gathers and the GRU
steps are PyTorch operations (cuBLAS and its element-wise kernels), as
the reference leaves them to XLA.  fp32 products run with TF32 off
(``exact_fp32``), since the reference is fp32.  The GRU scans of DIEN
are Python loops over the sequence.

A row-sharded table (a DTensor split by rows, as ``launch.steps``'
recsys cells lay out the tables of 4,096 rows or more) is read by
``_rows`` and ``_bag``: each rank gathers the ids' rows it holds (an id
outside its rows gives zero, or padding to the kernel), the parts are
summed across the table's axes, and the result comes back in the
batch's layout.  A bag's mean is that global sum divided by the bag's
valid ids, never a mean of per-rank means: each rank launches the
kernel's ``sum`` combiner on its own rows.

Each model has one forward body, differentiable (``_deepfm_logits``
and its kin); ``recsys_logits(params, cfg, batch)`` runs it in the
caller's grad mode, as the reference's train step calls its forward
(``launch.steps.recsys_train_step``), and the serving entry points
(``*_forward``, ``*_user_embedding``, ``retrieval_scores``) run under
``torch.inference_mode()``.  BST trains through its ``take`` path (the
forward's gathers), never the ``embedding_bag`` kernel, as the
reference's ``bst_forward`` does.  Parameters are made with
``requires_grad`` off (serving); ``model.requires_grad_(True)`` makes
them trainable.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import exact_fp32, resolve_device
from ..distributed.sharding import is_dtensor
from ..kernels.embedding_bag import embedding_bag
from .layers import (_device_and_generator, dense, dense_init, layernorm, layernorm_init, mlp_apply, mlp_init, pinned,
                     sharded_lookup, whole)

__all__ = [
    "ParamTree", "embedding_tables_init", "lookup_fields", "bce_loss",
    "DeepFMConfig", "DeepFM", "deepfm_init", "deepfm_forward", "deepfm_user_embedding",
    "AutoIntConfig", "AutoInt", "autoint_init", "autoint_forward", "autoint_user_embedding",
    "DIENConfig", "DIEN", "dien_init", "dien_forward", "dien_user_embedding",
    "BSTConfig", "BST", "bst_init", "bst_forward", "bst_user_embedding",
    "retrieval_scores", "recsys_from_jax", "recsys_logits",
]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _module(value):
    if isinstance(value, dict):
        return ParamTree(value)
    value = list(value)
    if all(isinstance(v, torch.Tensor) for v in value):
        return nn.ParameterList([nn.Parameter(v, requires_grad=False) for v in value])
    return nn.ModuleList([_module(v) for v in value])


class ParamTree(nn.Module):
    """A parameter pytree as a module: each tensor of ``tree`` is a
    parameter, each dict or list a sub-module, under the same names;
    ``p[name]`` and ``name in p`` read it as the reference reads its
    dict."""

    def __init__(self, tree):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))
            else:
                self.add_module(name, _module(value))

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name):
        return name in self._parameters or name in self._modules


def _generator(seed_or_generator, dev):
    """A generator on ``dev``: the one passed in (it must live there) or
    one seeded with the integer passed in."""
    if isinstance(seed_or_generator, torch.Generator):
        _device_and_generator(seed_or_generator, dev)
        return seed_or_generator
    return torch.Generator(device=dev).manual_seed(int(seed_or_generator))


def _normal(gen, shape, std, dtype, dev):
    """normal * std, drawn in fp32 and stored in ``dtype``."""
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev).mul_(std).to(dtype)


def _ids(ids, device):
    return torch.as_tensor(ids, device=device)


# ---------------------------------------------------------------------------
# embedding substrate
# ---------------------------------------------------------------------------


def embedding_tables_init(gen, vocab_sizes: Sequence[int], dim: int, dtype=torch.float32, device=None):
    """One (V_f, dim) table per sparse field, normal * 0.01."""
    dev = resolve_device(device)
    return [_normal(gen, (v, dim), 0.01, dtype, dev) for v in vocab_sizes]


def _rows(table, ids) -> torch.Tensor:
    """``table[ids]``, the reference's ``take`` (a DTensor table through
    ``layers.sharded_lookup``)."""
    if is_dtensor(table):
        return sharded_lookup(table, ids, bag=False)
    return table[_ids(ids, table.device).long()]


def lookup_fields(tables, ids) -> torch.Tensor:
    """ids (B, F) -> (B, F, dim)."""
    ids = _ids(ids, tables[0].device).long()
    return torch.stack([_rows(t, ids[:, f]) for f, t in enumerate(tables)], dim=1)


def bce_loss(logits: torch.Tensor, labels) -> torch.Tensor:
    z = logits.to(torch.float32)
    y = torch.as_tensor(labels, device=z.device).to(torch.float32)
    return torch.mean(torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-torch.abs(z))))


# ---------------------------------------------------------------------------
# DeepFM (Guo et al. 2017): FM interaction + deep tower, shared embeddings
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeepFMConfig:
    vocab_sizes: Tuple[int, ...]
    embed_dim: int = 10
    mlp_dims: Tuple[int, ...] = (400, 400, 400)
    dtype: torch.dtype = torch.float32

    @property
    def n_fields(self):
        return len(self.vocab_sizes)


class DeepFM(ParamTree):
    """``tables`` (one (V_f, D) a field), ``first_order`` (one (V_f, 1) a
    field), ``mlp`` (the deep tower, ``w``/``b`` a layer), ``bias`` (a
    fp32 scalar)."""


def deepfm_init(seed_or_generator, cfg: DeepFMConfig, device=None) -> DeepFM:
    dev = resolve_device(device)
    gen = _generator(seed_or_generator, dev)
    with torch.no_grad():
        return DeepFM({
            "tables": embedding_tables_init(gen, cfg.vocab_sizes, cfg.embed_dim, cfg.dtype, dev),
            "first_order": [_normal(gen, (v, 1), 0.01, cfg.dtype, dev) for v in cfg.vocab_sizes],
            "mlp": mlp_init(gen, [cfg.n_fields * cfg.embed_dim, *cfg.mlp_dims, 1], cfg.dtype, device=dev),
            "bias": torch.zeros((), dtype=torch.float32, device=dev),
        })


def _deepfm_logits(params: DeepFM, cfg: DeepFMConfig, ids) -> torch.Tensor:
    exact_fp32()
    ids = _ids(ids, params["bias"].device).long()
    emb = lookup_fields(params["tables"], ids)                     # (B, F, D)
    # FM second order: 0.5 * ((sum_f v)^2 - sum_f v^2)
    s = emb.sum(dim=1)
    fm2 = 0.5 * (s.square() - emb.square().sum(dim=1)).sum(dim=-1)
    fm1 = torch.cat([_rows(t, ids[:, f]) for f, t in enumerate(params["first_order"])], dim=1).sum(dim=1)
    deep = mlp_apply(params["mlp"], _rows_flat(emb))[:, 0]
    return (fm1 + fm2 + deep).to(torch.float32) + params["bias"]


@torch.inference_mode()
def deepfm_forward(params: DeepFM, cfg: DeepFMConfig, ids) -> torch.Tensor:
    """ids (B, F) -> CTR logits (B,)."""
    return _deepfm_logits(params, cfg, ids)


# ---------------------------------------------------------------------------
# AutoInt (Song et al. 2019): multi-head self-attention over field embeds
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AutoIntConfig:
    vocab_sizes: Tuple[int, ...]
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    dtype: torch.dtype = torch.float32

    @property
    def n_fields(self):
        return len(self.vocab_sizes)


class AutoInt(ParamTree):
    """``tables``, ``attn_layers`` (``wq``/``wk``/``wv``/``wres`` a
    layer), ``head`` (F·d, 1)."""


def autoint_init(seed_or_generator, cfg: AutoIntConfig, device=None) -> AutoInt:
    dev = resolve_device(device)
    gen = _generator(seed_or_generator, dev)
    width = cfg.n_heads * cfg.d_attn
    with torch.no_grad():
        tables = embedding_tables_init(gen, cfg.vocab_sizes, cfg.embed_dim, cfg.dtype, dev)
        layers, d = [], cfg.embed_dim
        for _ in range(cfg.n_attn_layers):
            layers.append({name: dense_init(gen, d, width, cfg.dtype, device=dev)
                           for name in ("wq", "wk", "wv", "wres")})
            d = width
        return AutoInt({"tables": tables, "attn_layers": layers,
                        "head": dense_init(gen, cfg.n_fields * d, 1, cfg.dtype, device=dev)})


def _heads(x, n: int, d: int):
    """(..., n·d) -> (..., n, d).  A DTensor's last dimension is gathered
    first and the heads ``pinned`` (the card's DTensor splits no split
    dimension, forward or backward)."""
    return pinned(whole(x, x.ndim - 1).reshape(*x.shape[:-1], n, d))


def _rows_flat(x):
    """(B, ...) -> (B, -1): each row's features in one; a DTensor split
    past its batch dimension is gathered there first (a flatten keeps a
    split only on its leading dimension; the card's DTensor refuses it
    otherwise)."""
    return pinned(whole(x, *range(1, x.ndim)).reshape(x.shape[0], -1))


def _field_attention(p, cfg: AutoIntConfig, x):
    b, f, _ = x.shape
    q = _heads(dense(p["wq"], x), cfg.n_heads, cfg.d_attn)
    k = _heads(dense(p["wk"], x), cfg.n_heads, cfg.d_attn)
    v = _heads(dense(p["wv"], x), cfg.n_heads, cfg.d_attn)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32))
    attn = torch.softmax(logits / math.sqrt(cfg.d_attn), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", attn, v.to(torch.float32))
    o = pinned(whole(o, 2, 3).reshape(b, f, cfg.n_heads * cfg.d_attn)).to(x.dtype)
    return torch.relu(o + dense(p["wres"], x))


def _autoint_logits(params: AutoInt, cfg: AutoIntConfig, ids) -> torch.Tensor:
    exact_fp32()
    x = lookup_fields(params["tables"], ids)                        # (B, F, D)
    for p in params["attn_layers"]:
        x = _field_attention(p, cfg, x)
    return dense(params["head"], _rows_flat(x))[:, 0].to(torch.float32)


@torch.inference_mode()
def autoint_forward(params: AutoInt, cfg: AutoIntConfig, ids) -> torch.Tensor:
    return _autoint_logits(params, cfg, ids)


# ---------------------------------------------------------------------------
# DIEN (Zhou et al. 2018): interest extraction GRU + AUGRU evolution
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DIENConfig:
    item_vocab: int
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: Tuple[int, ...] = (200, 80)
    dtype: torch.dtype = torch.float32


class DIEN(ParamTree):
    """``item_table``, ``gru1`` and ``augru`` (``update``/``reset``/
    ``cand`` gates, each ``wx``/``wh``/``b``), ``att_w``, ``mlp``."""


def _gru_init(gen, d_in, d_h, dtype, dev):
    def gate():
        return {"wx": dense_init(gen, d_in, d_h, dtype, device=dev),
                "wh": dense_init(gen, d_h, d_h, dtype, device=dev),
                "b": torch.zeros((d_h,), dtype=dtype, device=dev)}

    return {"update": gate(), "reset": gate(), "cand": gate()}


def _gru_cell(p, h, x, att=None):
    def gate(g, hh):
        return x @ g["wx"].to(x.dtype) + hh @ g["wh"].to(x.dtype) + g["b"].to(x.dtype)

    z = torch.sigmoid(gate(p["update"], h).to(torch.float32))
    r = torch.sigmoid(gate(p["reset"], h).to(torch.float32))
    hc = torch.tanh(gate(p["cand"], r.to(h.dtype) * h).to(torch.float32))
    if att is not None:  # AUGRU: attention scales the update gate
        z = z * att[:, None]
    out = (1 - z) * h.to(torch.float32) + z * hc
    return out.to(h.dtype)


def dien_init(seed_or_generator, cfg: DIENConfig, device=None) -> DIEN:
    dev = resolve_device(device)
    gen = _generator(seed_or_generator, dev)
    d_concat = cfg.gru_dim + cfg.embed_dim  # final interest + target embed
    with torch.no_grad():
        return DIEN({
            "item_table": _normal(gen, (cfg.item_vocab, cfg.embed_dim), 0.01, cfg.dtype, dev),
            "gru1": _gru_init(gen, cfg.embed_dim, cfg.gru_dim, cfg.dtype, dev),
            "augru": _gru_init(gen, cfg.gru_dim, cfg.gru_dim, cfg.dtype, dev),
            "att_w": dense_init(gen, cfg.gru_dim, cfg.gru_dim, cfg.dtype, device=dev),
            "mlp": mlp_init(gen, [d_concat, *cfg.mlp_dims, 1], cfg.dtype, device=dev),
        })


def _interests(params: DIEN, cfg: DIENConfig, emb):
    """The interest-extraction GRU over emb (B, L, D) -> the states (L, B, G)."""
    h = torch.zeros((emb.shape[0], cfg.gru_dim), dtype=cfg.dtype, device=emb.device)
    states = []
    for t in range(emb.shape[1]):
        h = _gru_cell(params["gru1"], h, emb[:, t])
        states.append(h)
    return torch.stack(states, dim=0)


def _dien_logits(params: DIEN, cfg: DIENConfig, hist, target) -> torch.Tensor:
    exact_fp32()
    table = params["item_table"]
    emb = _rows(table, hist)                                          # (B, L, D)
    tgt = _rows(table, target)                                        # (B, D)
    interests = _interests(params, cfg, emb)                          # (L, B, G)

    # attention of target on each interest state (for AUGRU update gates): the reference pads the target
    # with zeros to the GRU width, so only the projection's first embed_dim columns meet it; the
    # projection batch-major, (B, L, G), so a batch split over ranks stays the leading dimension of the
    # product's flattened rows (DTensor cannot flatten (L, B) with B split)
    proj = dense(params["att_w"], interests.transpose(0, 1))[..., : cfg.embed_dim]
    att_logits = torch.einsum("bld,bd->lb", proj.to(torch.float32), tgt.to(torch.float32)) / math.sqrt(cfg.gru_dim)
    att = torch.softmax(att_logits, dim=0)                            # (L, B)

    # interest evolution AUGRU
    h = torch.zeros((emb.shape[0], cfg.gru_dim), dtype=cfg.dtype, device=table.device)
    for t in range(interests.shape[0]):
        h = _gru_cell(params["augru"], h, interests[t], att=att[t])
    feat = torch.cat([h, tgt], dim=-1)
    return mlp_apply(params["mlp"], feat)[:, 0].to(torch.float32)


@torch.inference_mode()
def dien_forward(params: DIEN, cfg: DIENConfig, hist, target) -> torch.Tensor:
    """hist (B, L) item ids; target (B,) item ids -> CTR logits (B,)."""
    return _dien_logits(params, cfg, hist, target)


# ---------------------------------------------------------------------------
# BST (Chen et al. 2019): transformer block over the behavior sequence
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BSTConfig:
    item_vocab: int
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp_dims: Tuple[int, ...] = (1024, 512, 256)
    dtype: torch.dtype = torch.float32


class BST(ParamTree):
    """``item_table``, ``pos_table`` (L + 1, D), ``blocks`` (``wq``/``wk``/
    ``wv``/``wo``, ``ln1``/``ln2`` with ``scale``/``bias``, ``ff1``/``ff2``
    a block), ``mlp``."""


def bst_init(seed_or_generator, cfg: BSTConfig, device=None) -> BST:
    dev = resolve_device(device)
    gen = _generator(seed_or_generator, dev)
    d = cfg.embed_dim
    seq_total = cfg.seq_len + 1  # behavior seq + target item
    with torch.no_grad():
        item_table = _normal(gen, (cfg.item_vocab, d), 0.01, cfg.dtype, dev)
        pos_table = _normal(gen, (seq_total, d), 0.01, cfg.dtype, dev)
        blocks = [{
            **{name: dense_init(gen, d, d, cfg.dtype, device=dev) for name in ("wq", "wk", "wv", "wo")},
            "ln1": layernorm_init(d, cfg.dtype, device=dev),
            "ln2": layernorm_init(d, cfg.dtype, device=dev),
            "ff1": dense_init(gen, d, 4 * d, cfg.dtype, device=dev),
            "ff2": dense_init(gen, 4 * d, d, cfg.dtype, device=dev),
        } for _ in range(cfg.n_blocks)]
        return BST({"item_table": item_table, "pos_table": pos_table, "blocks": blocks,
                    "mlp": mlp_init(gen, [seq_total * d, *cfg.mlp_dims, 1], cfg.dtype, device=dev)})


def _bst_logits(params: BST, cfg: BSTConfig, hist, target) -> torch.Tensor:
    exact_fp32()
    dev = params["item_table"].device
    hist, target = _ids(hist, dev).long(), _ids(target, dev).long()
    b, l = hist.shape
    seq = torch.cat([hist, target[:, None]], dim=1)                   # (B, L+1)
    x = _rows(params["item_table"], seq) + params["pos_table"][None]
    d, h = cfg.embed_dim, cfg.n_heads
    dh = d // h
    for p in params["blocks"]:
        xn = layernorm(p["ln1"], x)
        q = _heads(dense(p["wq"], xn), h, dh)
        k = _heads(dense(p["wk"], xn), h, dh)
        v = _heads(dense(p["wv"], xn), h, dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32))
        attn = torch.softmax(logits / math.sqrt(dh), dim=-1)
        o = pinned(whole(torch.einsum("bhqk,bkhd->bqhd", attn, v.to(torch.float32)), 2, 3).reshape(b, l + 1, d))
        x = x + dense(p["wo"], o.to(x.dtype))
        xn = layernorm(p["ln2"], x)
        # jax.nn.leaky_relu's default slope is 0.01, as torch's
        ff = F.leaky_relu(dense(p["ff1"], xn).to(torch.float32), 0.01)
        x = x + dense(p["ff2"], ff.to(x.dtype))
    return mlp_apply(params["mlp"], _rows_flat(x))[:, 0].to(torch.float32)


@torch.inference_mode()
def bst_forward(params: BST, cfg: BSTConfig, hist, target) -> torch.Tensor:
    """hist (B, L) item ids; target (B,) item ids -> CTR logits (B,)."""
    return _bst_logits(params, cfg, hist, target)


def recsys_logits(params: ParamTree, cfg, batch) -> torch.Tensor:
    """The model's CTR logits (B,) for a batch dict (``ids`` for DeepFM
    and AutoInt, ``hist`` and ``target`` for DIEN and BST), in the
    caller's grad mode: the forward the reference's train step
    differentiates (``_recsys_model_fns``' ``fwd``)."""
    if isinstance(cfg, DeepFMConfig):
        return _deepfm_logits(params, cfg, batch["ids"])
    if isinstance(cfg, AutoIntConfig):
        return _autoint_logits(params, cfg, batch["ids"])
    if isinstance(cfg, DIENConfig):
        return _dien_logits(params, cfg, batch["hist"], batch["target"])
    if isinstance(cfg, BSTConfig):
        return _bst_logits(params, cfg, batch["hist"], batch["target"])
    raise TypeError(f"not a recsys config: {type(cfg).__name__}")


# ---------------------------------------------------------------------------
# retrieval scoring (shared): one query tower output vs 1M candidates
# ---------------------------------------------------------------------------


@torch.inference_mode()
def retrieval_scores(query_emb: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """(B, D) x (N, D) -> (B, N) dot scores: one fp32 product (TF32 off)."""
    exact_fp32()
    return query_emb.to(torch.float32) @ candidates.to(torch.float32).T


@torch.inference_mode()
def deepfm_user_embedding(params: DeepFM, cfg: DeepFMConfig, ids) -> torch.Tensor:
    """User tower for retrieval: pooled field embeddings (B, embed_dim)."""
    return lookup_fields(params["tables"], ids).sum(dim=1)


@torch.inference_mode()
def autoint_user_embedding(params: AutoInt, cfg: AutoIntConfig, ids) -> torch.Tensor:
    return lookup_fields(params["tables"], ids).mean(dim=1)


@torch.inference_mode()
def dien_user_embedding(params: DIEN, cfg: DIENConfig, hist) -> torch.Tensor:
    """Final interest state truncated to embed_dim (item-embedding space)."""
    exact_fp32()
    table = params["item_table"]
    interests = _interests(params, cfg, _rows(table, hist))
    return interests[-1][:, : cfg.embed_dim]


@torch.inference_mode()
def bst_user_embedding(params: BST, cfg: BSTConfig, hist) -> torch.Tensor:
    """Mean-pooled behavior-sequence embedding (B, embed_dim) in fp32: one
    ``embedding_bag(combiner="mean")`` launch over the item table.  Ids
    must lie in [0, item_vocab) (``ctr_batch`` draws only those), where
    it equals the reference's ``take`` + mean.  A DTensor table: each
    rank launches the ``sum`` combiner on its own rows
    (``layers.sharded_lookup``), and the summed bags are divided by their
    valid ids."""
    table = params["item_table"]
    ids = _ids(hist, table.device).to(torch.int32)
    if is_dtensor(table):
        sums = sharded_lookup(table, ids, bag=True)
        return sums / (ids >= 0).sum(dim=1, keepdim=True).clamp(min=1).to(sums.dtype)
    return embedding_bag(table, ids.contiguous(), combiner="mean")


# ---------------------------------------------------------------------------
# the reference's parameters
# ---------------------------------------------------------------------------

_MODULES = {DeepFMConfig: DeepFM, AutoIntConfig: AutoInt, DIENConfig: DIEN, BSTConfig: BST}


def recsys_from_jax(params, cfg, device=None) -> ParamTree:
    """The port's module for ``cfg`` (any of the four configs) holding
    the reference's parameter pytree (arrays as numpy, or anything
    ``np.asarray`` takes), names and nesting kept.  DeepFM's ``bias``
    stays fp32 as in the reference; every other value is stored in
    ``cfg.dtype`` on ``device`` (``cuda`` unless ``"cpu"``)."""
    dev = resolve_device(device)
    if type(cfg) not in _MODULES:
        raise TypeError(f"not a recsys config: {type(cfg).__name__}")

    def tensor(a, dtype):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype)

    def convert(tree, name=""):
        if isinstance(tree, dict):
            return {k: convert(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [convert(v, name) for v in tree]
        return tensor(tree, torch.float32 if isinstance(cfg, DeepFMConfig) and name == "bias" else cfg.dtype)

    with torch.no_grad():
        return _MODULES[type(cfg)](convert(params))
