"""Decoder-only transformer LM, the serving path (port of
``repro.models.transformer``): GQA/MQA + RoPE, an optional per-layer
sliding-window pattern (Gemma-3's 5:1 local:global) with its windowed
ring-buffer decode, optional MoE FFNs (Grok-1, DeepSeek-V2:
``moe.py``) and optional MLA attention (DeepSeek-V2: ``mla.py``);
prefill and KV-cache decode.

The parameters are an ``nn.Module`` (``Transformer``) whose layers are an
``nn.ModuleList``; the reference stacks them on a leading axis and
``lax.scan``s over them.  Each layer is an ``nn.ModuleDict`` of
``nn.ParameterDict`` trees with the reference's names (``ln1``, ``ln2``,
``attn`` = ``wq``/``wk``/``wv``/``wo`` or MLA's ``wq_a``, ``q_norm``,
..., ``ffn`` = ``wi_gate``/``wi_up``/``wo`` or ``moe`` = ``router``,
``wi_gate``, ``wi_up``, ``wo`` (+ ``shared``)); ``prefix_layers`` (the
leading ``n_dense_layers``) have a dense FFN.  Every leaf has the dtype
the reference gives it: ``cfg.dtype``, the MoE experts ``cfg.moe.dtype``
and the router fp32.  Dense weights keep the reference's (in, out)
layout, so ``dense(w, x) = x @ w``.  ``transformer_from_jax`` carries
the reference's parameters across.

Attention runs ``layers.blockwise_attention``, i.e. the hand-written
``flash_attention`` kernel on the card: the prefill of every config
(MLA's at D 192), each GQA/MQA decode step, and the windowed decode's
ring buffers, whose valid slots are read as a prefix without a mask (a
softmax does not depend on the slots' order).  MLA's absorbed decode is
plain fp32 PyTorch, as the reference's jnp.  The GEMMs are
``torch.matmul`` (cuBLAS), as the reference leaves them to XLA.

One forward body (``_hidden``) serves both paths.  The serving entry
points (``transformer_hidden``, ``transformer_forward``,
``transformer_prefill``, the decode steps) run it under
``torch.inference_mode()``; ``transformer_loss`` (training) runs it in
the caller's grad mode, and with ``cfg.remat`` each layer under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
scan body): its activations are recomputed in the backward, the
``flash_attention`` kernel among them (two forward launches a GQA layer
and step, one backward).  Parameters are made with ``requires_grad``
off (serving); ``model.requires_grad_(True)`` makes them trainable, and
``launch.steps.lm_train_step`` does so.  Gradients exist for every
layer kind (GQA, windowed, MoE, MLA); on the card the attention
backward takes the head widths of ``flash_attention``'s ``BWD_DIMS`` and
MLA's (192, 128) pair (``BWD_PAIRS``).

The reference's sharding hooks keep its names and its Identity
defaults: ``shard_act`` (the (B, S, d) residual), ``shard_qkv`` (q, k,
v as (B, H, S, D)), ``shard_layer_params`` (a layer's parameters) and
``shard_logits`` (the loss's chunk logits).  ``launch.steps`` makes them
for a ``DeviceMesh`` (``lm_train_step(..., mesh=)`` and the serving
steps): the parameters are then DTensors and each hook redistributes to
the reference's layout.  The port has no stacked layer axis, so
``shard_layer_params`` is called on each layer's own tree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..distributed.sharding import is_dtensor
from .layers import (apply_rope, blockwise_attention, cache_write, chunked_cross_entropy, cross_entropy_loss, dense,
                     rmsnorm, sharded_lookup, split_heads, swiglu, whole)
from .mla import MLAConfig, mla_attention, mla_decode_step, mla_shapes
from .moe import MoEConfig, moe_apply, moe_shapes


def Identity(x):
    return x


__all__ = [
    "Identity", "TransformerConfig", "Transformer", "transformer_init", "transformer_from_jax",
    "transformer_hidden", "transformer_forward", "transformer_loss", "transformer_prefill",
    "make_cache", "transformer_decode_step", "make_cache_windowed", "transformer_prefill_windowed",
    "transformer_decode_step_windowed",
]


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    kv_heads: int
    d_head: int
    d_ff: int
    rope_theta: float = 10000.0
    window: Optional[int] = None     # sliding window for local layers
    global_every: int = 0            # 0: all layers global; k: layer i global iff (i+1)%k==0
    moe: Optional[MoEConfig] = None
    n_dense_layers: int = 0          # leading layers with dense FFN even when moe set
    attention: str = "gqa"           # "gqa" | "mla"
    mla: Optional[MLAConfig] = None
    dtype: torch.dtype = torch.bfloat16
    kv_block: int = 1024             # the reference's attention KV chunk; the kernel tiles itself
    remat: bool = True               # recompute each layer's activations in the backward (training)

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.d_head

    def layer_is_global(self, i: int) -> bool:
        if self.global_every <= 0 or self.window is None:
            return True
        return (i + 1) % self.global_every == 0

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline math)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        if self.attention == "mla":
            m = self.mla
            attn = (
                d * m.q_lora_rank + m.q_lora_rank * m.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                + d * (m.kv_lora_rank + m.qk_rope_dim)
                + m.kv_lora_rank * m.n_heads * (m.qk_nope_dim + m.v_dim)
                + m.n_heads * m.v_dim * d
            )
        else:
            attn = d * self.attn_dim + 2 * d * self.kv_heads * self.d_head + self.attn_dim * d
        dense_ffn = 3 * d * f
        if self.moe is not None:
            moe_ffn = 3 * self.moe.d_ff * d * self.moe.n_experts + d * self.moe.n_experts
            moe_ffn += 3 * d * self.moe.d_ff * self.moe.n_shared
            n_moe = self.n_layers - self.n_dense_layers
            ffn_total = n_moe * moe_ffn + self.n_dense_layers * dense_ffn
        else:
            ffn_total = self.n_layers * dense_ffn
        return self.n_layers * attn + ffn_total + 2 * v * d + self.n_layers * 2 * d + d

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        all_experts = 3 * self.d_model * self.moe.d_ff * self.moe.n_experts
        active_experts = 3 * self.d_model * self.moe.d_ff * self.moe.top_k
        n_moe = self.n_layers - self.n_dense_layers
        return full - n_moe * (all_experts - active_experts)


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.attention not in ("gqa", "mla"):
        raise ValueError(f"unknown attention {cfg.attention!r}")
    if cfg.attention == "mla" and cfg.mla is None:
        raise ValueError("attention='mla' needs an MLAConfig")


def _windows(cfg: TransformerConfig):
    """Each stacked layer's window: None on global layers (the reference
    passes 1 << 30 there, which masks nothing)."""
    return [None if cfg.layer_is_global(i + cfg.n_dense_layers) else cfg.window
            for i in range(cfg.n_layers - cfg.n_dense_layers)]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _tree(spec, make) -> nn.ParameterDict:
    """{name: (shape, dtype) or a nested spec} -> a ParameterDict tree of
    ``make(name, shape, dtype)`` leaves."""
    return nn.ParameterDict({
        k: _tree(v, make) if isinstance(v, dict) else nn.Parameter(make(k, *v), requires_grad=False)
        for k, v in spec.items()})


def _layer_spec(cfg: TransformerConfig, dense_ffn: bool):
    d, dt = cfg.d_model, cfg.dtype
    if cfg.attention == "mla":
        attn = mla_shapes(cfg.mla, dt)
    else:
        kvd = cfg.kv_heads * cfg.d_head
        attn = {"wq": ((d, cfg.attn_dim), dt), "wk": ((d, kvd), dt), "wv": ((d, kvd), dt),
                "wo": ((cfg.attn_dim, d), dt)}
    spec = {"ln1": {"scale": ((d,), dt)}, "ln2": {"scale": ((d,), dt)}, "attn": attn}
    if cfg.moe is not None and not dense_ffn:
        spec["moe"] = moe_shapes(cfg.moe)
    else:
        spec["ffn"] = {"wi_gate": ((d, cfg.d_ff), dt), "wi_up": ((d, cfg.d_ff), dt), "wo": ((cfg.d_ff, d), dt)}
    return spec


def _layer(cfg: TransformerConfig, make, dense_ffn: bool) -> nn.ModuleDict:
    return nn.ModuleDict({k: _tree(v, make) for k, v in _layer_spec(cfg, dense_ffn).items()})


class Transformer(nn.Module):
    """The reference's parameter pytree as a module: ``embed`` (V, D),
    ``layers`` (one ``ModuleDict`` a stacked layer), ``prefix_layers``
    (the unstacked leading dense-FFN layers), ``ln_f``, ``lm_head`` (D, V)."""

    def __init__(self, cfg: TransformerConfig, make):
        super().__init__()
        _check_supported(cfg)
        self.embed = nn.Parameter(make("embed", (cfg.vocab, cfg.d_model), cfg.dtype), requires_grad=False)
        self.prefix_layers = nn.ModuleList([_layer(cfg, make, True) for _ in range(cfg.n_dense_layers)])
        self.layers = nn.ModuleList([_layer(cfg, make, False) for _ in range(cfg.n_layers - cfg.n_dense_layers)])
        self.ln_f = _tree({"scale": ((cfg.d_model,), cfg.dtype)}, make)
        self.lm_head = nn.Parameter(make("lm_head", (cfg.d_model, cfg.vocab), cfg.dtype), requires_grad=False)


def transformer_init(seed_or_generator, cfg: TransformerConfig, device=None) -> Transformer:
    """Random parameters as ``transformer_init`` draws them: embed
    normal * 0.02, dense and expert weights normal / sqrt(fan-in), norms
    ones; drawn in fp32 on ``device`` and stored in each leaf's dtype
    (``cfg.dtype``; MoE experts ``cfg.moe.dtype``, the router fp32).
    ``device`` is ``cuda`` unless the caller passes ``"cpu"``; on
    ``"meta"`` only the shapes exist (nothing is drawn).  The draws come
    from a ``torch.Generator`` (a seed makes one on the device), so they
    are other numbers than ``jax.random``'s for the same seed."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if dev.type == "meta":
        return Transformer(cfg, lambda name, shape, dtype: torch.empty(shape, dtype=dtype, device=dev))
    if isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed_or_generator))

    def make(name, shape, dtype):
        if name == "scale":
            return torch.ones(shape, dtype=dtype, device=dev)
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        w.mul_(0.02 if name == "embed" else 1.0 / math.sqrt(shape[-2]))
        return w.to(dtype)

    with torch.no_grad():
        return Transformer(cfg, make)


def transformer_from_jax(params, cfg: TransformerConfig, device=None) -> Transformer:
    """The port's module holding the reference's parameter pytree
    (arrays as numpy, or anything ``np.asarray`` takes): ``params["layers"]``
    is unstacked along its leading (layer) axis into ``layers``, and
    ``params["prefix_layers"]`` (a list) goes into ``prefix_layers``;
    the ``attn`` (MLA's included), ``ffn`` and ``moe`` (with ``shared``)
    subtrees come across whole.  Each value is stored in its leaf's own
    dtype on ``device`` (``cuda`` unless ``"cpu"``)."""
    dev = resolve_device(device)
    _check_supported(cfg)

    def tensor(a, dtype):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype)

    def fill(module, tree, i=None):
        for name, child in module.items():
            if isinstance(child, nn.Module):
                fill(child, tree[name], i)
            else:
                a = np.asarray(tree[name])
                child.copy_(tensor(a if i is None else a[i], child.dtype))

    model = Transformer(cfg, lambda name, shape, dtype: torch.empty(shape, dtype=dtype, device=dev))
    with torch.no_grad():
        model.embed.copy_(tensor(params["embed"], cfg.dtype))
        model.lm_head.copy_(tensor(params["lm_head"], cfg.dtype))
        fill(model.ln_f, params["ln_f"])
        for i, layer in enumerate(model.layers):
            fill(layer, params["layers"], i)
        for layer, tree in zip(model.prefix_layers, params.get("prefix_layers", [])):
            fill(layer, tree)
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _gqa_attend(p, cfg: TransformerConfig, h, positions, *, window, shard_act=Identity, shard_qkv=Identity):
    b, s, _ = h.shape
    q = split_heads(dense(p["wq"], h), b, s, cfg.n_heads, cfg.d_head)
    k = split_heads(dense(p["wk"], h), b, s, cfg.kv_heads, cfg.d_head)
    v = split_heads(dense(p["wv"], h), b, s, cfg.kv_heads, cfg.d_head)
    # the reference's Ulysses layout switch: the residual is sequence-sharded,
    # attention runs head-sharded with the whole sequence local
    q, k, v = shard_qkv(q), shard_qkv(k), shard_qkv(v)
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    o = blockwise_attention(q, k, v, causal=True, window=window, kv_block=cfg.kv_block)
    o = o.transpose(1, 2).reshape(b, s, cfg.attn_dim)
    return dense(p["wo"], o), (k, v)


def _ffn(p, cfg: TransformerConfig, x, moe_aux=None):
    """The layer's FFN on x (B, S, d): the dense SwiGLU, or the MoE over
    the B*S tokens (its aux dict appended to ``moe_aux`` when given)."""
    if "moe" not in p:
        return swiglu(p["ffn"], x)
    b, s, d = x.shape
    x = whole(x, 1)  # (B, S) flattens to tokens split as the batch is
    y, aux = moe_apply(p["moe"], cfg.moe, x.reshape(b * s, d))
    if moe_aux is not None:
        moe_aux.append(aux)
    return y.view(b, s, d)


def _layer_forward(p, cfg: TransformerConfig, h, positions, window, moe_aux=None, shard_act=Identity,
                   shard_layer_params=Identity, shard_qkv=Identity):
    p = shard_layer_params(p)
    x = rmsnorm(p["ln1"], h)
    if cfg.attention == "mla":
        attn_out, _ = mla_attention(p["attn"], cfg.mla, x, positions)
    else:
        attn_out, _ = _gqa_attend(p["attn"], cfg, x, positions, window=window, shard_act=shard_act,
                                  shard_qkv=shard_qkv)
    # each branch laid out as the residual before the sum, so that the sum's
    # gradient reaches the branch in its own layout (a DTensor redistribution)
    h = shard_act(h + shard_act(attn_out))
    return shard_act(h + shard_act(_ffn(p, cfg, rmsnorm(p["ln2"], h), moe_aux)))


def _embed(embed, tokens, dtype):
    """The rows of ``embed`` (V, D) for ``tokens``, in ``dtype``.  On
    DTensors each rank looks its own batch rows up in the table gathered
    over the vocabulary (its split of D kept): a ``local_map``, whose
    gradient is each rank's scatter of its rows (a ``Partial`` sum over
    the ranks that split the batch).  Where one mesh dimension splits both
    D and the batch (the windowed decode's all-axes table), the token ids
    are gathered there, not the table; a table split by rows alone (the
    same decode on 512 ranks: its D does not divide them) would be
    gathered whole, so each rank looks its own rows up instead
    (``layers.sharded_lookup``)."""
    if not is_dtensor(embed):
        return embed.to(dtype)[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not any(p.is_shard(1) for p in embed.placements) and any(p.is_shard(0) for p in embed.placements):
        return sharded_lookup(embed, tokens).to(dtype)

    table = tuple(Shard(1) if p.is_shard(1) else Replicate() for p in embed.placements)
    tok = tuple(Replicate() if t.is_shard(1) else b for t, b in zip(table, tokens.placements))
    grad = tuple(t if t.is_shard(1) else (Partial() if b.is_shard(0) else Replicate()) for t, b in zip(table, tok))
    out = [Shard(0) if b.is_shard(0) else (Shard(2) if t.is_shard(1) else Replicate()) for t, b in zip(table, tok)]
    return local_map(lambda e, t: e.to(dtype)[t], out_placements=out, in_placements=(table, tok),
                     in_grad_placements=(grad, tok), device_mesh=embed.device_mesh,
                     redistribute_inputs=True)(embed, tokens)


def _tokens(tokens, device):
    if is_dtensor(tokens):  # a sharded step's batch: already where its ranks hold it
        return tokens.long()
    return torch.as_tensor(tokens, device=device).long()


def _hidden(params: Transformer, cfg: TransformerConfig, tokens, moe_aux: Optional[list] = None, *,
            shard_act=Identity, shard_layer_params=Identity, shard_qkv=Identity):
    """The backbone in the caller's grad mode -> final hidden states (B,
    S, D) after ln_f; with grad enabled and ``cfg.remat`` each layer
    runs under ``torch.utils.checkpoint`` (``moe_aux`` is then left
    empty: a recomputed layer would append its aux twice)."""
    _check_supported(cfg)
    tokens = _tokens(tokens, params.embed.device)
    b, s = tokens.shape
    h = shard_act(_embed(params.embed, tokens, cfg.dtype))
    positions = torch.arange(s, device=params.embed.device).expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    layers = [(p, None) for p in params.prefix_layers] + list(zip(params.layers, _windows(cfg)))
    hooks = dict(shard_act=shard_act, shard_layer_params=shard_layer_params, shard_qkv=shard_qkv)
    for p, window in layers:
        if remat:
            h = checkpoint(_layer_forward, p, cfg, h, positions, window, use_reentrant=False,
                           preserve_rng_state=False, **hooks)
        else:
            h = _layer_forward(p, cfg, h, positions, window, moe_aux, **hooks)
    return rmsnorm(params.ln_f, h)


@torch.inference_mode()
def transformer_hidden(params: Transformer, cfg: TransformerConfig, tokens, *, moe_aux: Optional[list] = None,
                       shard_act=Identity, shard_layer_params=Identity, shard_qkv=Identity):
    """Backbone forward -> final hidden states (B, S, D) after ln_f.
    ``moe_aux``, a list, receives each MoE layer's aux dict in layer
    order (the reference drops them)."""
    return _hidden(params, cfg, tokens, moe_aux, shard_act=shard_act, shard_layer_params=shard_layer_params,
                   shard_qkv=shard_qkv)


@torch.inference_mode()
def transformer_forward(params: Transformer, cfg: TransformerConfig, tokens, *, moe_aux: Optional[list] = None,
                        shard_act=Identity, shard_layer_params=Identity):
    """Forward -> logits (B, S, V)."""
    return dense(params.lm_head, _hidden(params, cfg, tokens, moe_aux, shard_act=shard_act,
                                         shard_layer_params=shard_layer_params))


def transformer_loss(params: Transformer, cfg: TransformerConfig, tokens, labels, *, ce_chunk: Optional[int] = None,
                     shard_act=Identity, shard_layer_params=Identity, shard_logits=None, shard_qkv=Identity):
    """Mean next-token cross-entropy, in the caller's grad mode (the
    training objective: differentiable with respect to every parameter
    that requires a gradient).  ``ce_chunk``: the loss over sequence
    chunks of that length, each recomputed in the backward
    (``chunked_cross_entropy``, its logits laid out by
    ``shard_logits``); else over the whole (B, S, V) logits."""
    h = _hidden(params, cfg, tokens, shard_act=shard_act, shard_layer_params=shard_layer_params,
                shard_qkv=shard_qkv)
    labels = _tokens(labels, params.embed.device)
    if ce_chunk:
        return chunked_cross_entropy(params.lm_head, h, labels, chunk=ce_chunk, shard_logits=shard_logits)
    return cross_entropy_loss(dense(params.lm_head, h), labels)


@torch.inference_mode()
def transformer_prefill(params: Transformer, cfg: TransformerConfig, tokens, *, moe_aux: Optional[list] = None,
                        shard_act=Identity, shard_layer_params=Identity):
    """Prefill: full-sequence forward returning the last position's
    logits (B, V).  As in the reference, it fills no cache."""
    h = _hidden(params, cfg, tokens, moe_aux, shard_act=shard_act, shard_layer_params=shard_layer_params)
    return dense(params.lm_head, whole(h, 1)[:, -1])


# ---------------------------------------------------------------------------
# decode (KV cache)
# ---------------------------------------------------------------------------


def make_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, device=None):
    """Zeroed caches on ``device`` (``cuda`` unless ``"cpu"``): GQA K/V,
    (layers, B, Hkv, max_len, Dh) each; MLA ``ckv`` (layers, B, max_len,
    kv_lora) and ``krope`` (layers, B, max_len, rope).  The prefix
    layers get their own (``prefix_k``/``prefix_v``, ``prefix_ckv``/
    ``prefix_krope``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    n_stacked = cfg.n_layers - cfg.n_dense_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.attention == "mla":
        m = cfg.mla
        cache = {"ckv": zeros(n_stacked, batch, max_len, m.kv_lora_rank),
                 "krope": zeros(n_stacked, batch, max_len, m.qk_rope_dim)}
        if cfg.n_dense_layers:
            cache["prefix_ckv"] = zeros(cfg.n_dense_layers, batch, max_len, m.kv_lora_rank)
            cache["prefix_krope"] = zeros(cfg.n_dense_layers, batch, max_len, m.qk_rope_dim)
        return cache
    cache = {"k": zeros(n_stacked, batch, cfg.kv_heads, max_len, cfg.d_head),
             "v": zeros(n_stacked, batch, cfg.kv_heads, max_len, cfg.d_head)}
    if cfg.n_dense_layers:
        cache["prefix_k"] = zeros(cfg.n_dense_layers, batch, cfg.kv_heads, max_len, cfg.d_head)
        cache["prefix_v"] = zeros(cfg.n_dense_layers, batch, cfg.kv_heads, max_len, cfg.d_head)
    return cache


def _decode_qkv(a, cfg: TransformerConfig, x, cur_len: int):
    """The step's q (B, Hq, 1, Dh), k and v (B, Hkv, 1, Dh), RoPE at
    position ``cur_len``."""
    b = x.shape[0]
    q = split_heads(dense(a["wq"], x), b, 1, cfg.n_heads, cfg.d_head)
    k = split_heads(dense(a["wk"], x), b, 1, cfg.kv_heads, cfg.d_head)
    v = split_heads(dense(a["wv"], x), b, 1, cfg.kv_heads, cfg.d_head)
    pos = torch.full((b, 1), cur_len, dtype=torch.long, device=x.device)
    return apply_rope(q, pos[:, None, :], cfg.rope_theta), apply_rope(k, pos[:, None, :], cfg.rope_theta), v


def _decode_out(p, cfg: TransformerConfig, h, o):
    """The residual update of a decode layer from its attention output o
    (B, Hq, 1, Dh): the output projection, then the FFN."""
    h = h + dense(p["attn"]["wo"], o.transpose(1, 2).reshape(h.shape[0], 1, cfg.attn_dim))
    return h + _ffn(p, cfg, rmsnorm(p["ln2"], h))


def _gqa_decode_layer(p, cfg: TransformerConfig, h, k_cache, v_cache, cur_len: int, window):
    """h (B, 1, d); k/v_cache (B, Hkv, S, Dh), written in place at
    ``cur_len`` (``layers.cache_write``: on a sequence-sharded DTensor
    cache by its owning rank, then the layer's keys gathered);
    attention reads the prefix of ``cur_len + 1`` keys."""
    q, k, v = _decode_qkv(p["attn"], cfg, rmsnorm(p["ln1"], h), cur_len)
    k_cache, v_cache = cache_write(k_cache, 2, cur_len, k), cache_write(v_cache, 2, cur_len, v)
    o = blockwise_attention(
        q, k_cache, v_cache, causal=True, window=window,
        q_offset=cur_len, kv_block=cfg.kv_block, valid_len=cur_len + 1,
    )
    return _decode_out(p, cfg, h, o)


def _mla_decode_layer(p, cfg: TransformerConfig, h, ckv, krope, cur_len: int):
    attn, _, _ = mla_decode_step(p["attn"], cfg.mla, rmsnorm(p["ln1"], h), ckv, krope, cur_len)
    h = h + attn
    return h + _ffn(p, cfg, rmsnorm(p["ln2"], h))


@torch.inference_mode()
def transformer_decode_step(params: Transformer, cfg: TransformerConfig, token, cache, cur_len, *,
                            shard_act=Identity):
    """One decode step: token (B, 1), ``cur_len`` tokens already cached
    -> (logits (B, V), cache).

    The cache is updated in place (``k_cache[..., cur_len, :] = k``; MLA:
    ``ckv[:, cur_len] = c_kv``) and the same dict is returned; the
    reference returns a new cache built by ``dynamic_update_slice``.
    ``shard_act`` lays out the residual after the embedding and after
    each stacked layer, as the reference's scan body does."""
    _check_supported(cfg)
    cur_len = int(cur_len)
    token = _tokens(token, params.embed.device)
    h = shard_act(_embed(params.embed, token, cfg.dtype))
    if cfg.attention == "mla":
        for i, p in enumerate(params.prefix_layers):
            h = _mla_decode_layer(p, cfg, h, cache["prefix_ckv"][i], cache["prefix_krope"][i], cur_len)
        for i, p in enumerate(params.layers):
            h = shard_act(_mla_decode_layer(p, cfg, h, cache["ckv"][i], cache["krope"][i], cur_len))
    else:
        for i, p in enumerate(params.prefix_layers):
            h = _gqa_decode_layer(p, cfg, h, cache["prefix_k"][i], cache["prefix_v"][i], cur_len, None)
        for i, (p, window) in enumerate(zip(params.layers, _windows(cfg))):
            h = shard_act(_gqa_decode_layer(p, cfg, h, cache["k"][i], cache["v"][i], cur_len, window))
    h = rmsnorm(params.ln_f, h)
    return dense(params.lm_head, h)[:, 0], cache


# ---------------------------------------------------------------------------
# windowed decode (hybrid local/global configs: ring buffers on local layers)
# ---------------------------------------------------------------------------


def _hybrid_blocks(cfg: TransformerConfig):
    """(n_blocks, per_block, n_suffix): the local:global repeat pattern.
    gemma3: 62 layers at global_every 6 -> 10 blocks of (5 local + 1
    global) + 2 suffix local layers."""
    ge = cfg.global_every
    n_blocks = cfg.n_layers // ge
    return n_blocks, ge, cfg.n_layers - n_blocks * ge


def _check_hybrid(cfg: TransformerConfig) -> None:
    _check_supported(cfg)
    if cfg.attention != "gqa" or cfg.window is None or cfg.global_every <= 0 or cfg.n_dense_layers:
        raise ValueError("windowed decode needs a GQA config with a window, global_every > 0 and no "
                         "prefix layers (the hybrid local:global pattern)")


def make_cache_windowed(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, device=None):
    """Heterogeneous caches of the hybrid local/global decode, on
    ``device`` (``cuda`` unless ``"cpu"``): each local layer a ring of
    ``W = min(window, max_len)`` slots, only the global layers the full
    sequence.  ``loc_k``/``loc_v`` (blocks, per_block - 1, B, Hkv, W,
    Dh), ``glob_k``/``glob_v`` (blocks, B, Hkv, max_len, Dh),
    ``suf_k``/``suf_v`` (suffix layers, B, Hkv, W, Dh), as the
    reference lays them out.  gemma3-27b keeps 1024 slots on 52 of its
    62 layers."""
    _check_hybrid(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    nb, ge, ns = _hybrid_blocks(cfg)
    w = min(cfg.window, max_len)
    h, d = cfg.kv_heads, cfg.d_head

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "loc_k": zeros(nb, ge - 1, batch, h, w, d), "loc_v": zeros(nb, ge - 1, batch, h, w, d),
        "glob_k": zeros(nb, batch, h, max_len, d), "glob_v": zeros(nb, batch, h, max_len, d),
        "suf_k": zeros(ns, batch, h, w, d), "suf_v": zeros(ns, batch, h, w, d),
    }


@torch.inference_mode()
def transformer_prefill_windowed(params: Transformer, cfg: TransformerConfig, tokens, cache):
    """Prefill of the hybrid local/global decode: the forward of
    ``tokens`` (B, S) at positions 0..S-1 that also writes each layer's
    keys (RoPE applied) and values into ``make_cache_windowed``'s caches:
    a global layer's S positions, a local layer's last ``min(S, W)``
    into their ring slots (position t in slot t % W), as S decode steps
    would leave them.  ``transformer_decode_step_windowed`` goes on at
    ``cur_len = S``.  -> (the last position's logits (B, V), the same
    cache dict)."""
    _check_hybrid(cfg)
    nb, ge, _ = _hybrid_blocks(cfg)
    tokens = _tokens(tokens, params.embed.device)
    b, s = tokens.shape
    h = _embed(params.embed, tokens, cfg.dtype)
    positions = torch.arange(s, device=h.device).expand(b, s)
    for i, (p, window) in enumerate(zip(params.layers, _windows(cfg))):
        attn_out, (k, v) = _gqa_attend(p["attn"], cfg, rmsnorm(p["ln1"], h), positions, window=window)
        if window is None:
            cache["glob_k"][i // ge, :, :, :s] = k
            cache["glob_v"][i // ge, :, :, :s] = v
        else:
            kc, vc = ((cache["loc_k"][i // ge, i % ge], cache["loc_v"][i // ge, i % ge]) if i < nb * ge
                      else (cache["suf_k"][i - nb * ge], cache["suf_v"][i - nb * ge]))
            kept = torch.arange(max(0, s - kc.shape[2]), s, device=h.device)
            kc.index_copy_(2, kept % kc.shape[2], k[:, :, kept])
            vc.index_copy_(2, kept % vc.shape[2], v[:, :, kept])
        h = h + attn_out
        h = h + _ffn(p, cfg, rmsnorm(p["ln2"], h))
    return dense(params.lm_head, rmsnorm(params.ln_f, h)[:, -1]), cache


def _windowed_decode_layer(p, cfg: TransformerConfig, h, kc, vc, cur_len: int, is_global: bool):
    """One decode layer against a full (global) cache or a ring buffer
    (local): position t lives in slot t % W, RoPE applied at write time,
    so a stored key carries its absolute position.  The ring's valid
    slots are its first ``min(cur_len + 1, W)``, which hold exactly the
    last W positions: they are read as a prefix, unmasked (causal off,
    no window), since the softmax does not depend on their order."""
    if is_global:
        return _gqa_decode_layer(p, cfg, h, kc, vc, cur_len, None)
    q, k, v = _decode_qkv(p["attn"], cfg, rmsnorm(p["ln1"], h), cur_len)
    w = kc.shape[2]
    kc, vc = cache_write(kc, 2, cur_len % w, k), cache_write(vc, 2, cur_len % w, v)
    o = blockwise_attention(q, kc, vc, causal=False, kv_block=cfg.kv_block, valid_len=min(cur_len + 1, w))
    return _decode_out(p, cfg, h, o)


@torch.inference_mode()
def transformer_decode_step_windowed(params: Transformer, cfg: TransformerConfig, token, cache, cur_len):
    """One decode step over ``make_cache_windowed``'s caches: each
    (local^(per_block - 1), global) block, then the local suffix layers;
    the caches are written in place and the same dict is returned.
    Gives ``transformer_decode_step``'s logits on a full cache.  On
    DTensors (``launch.steps``' ``windowed`` decode cell) the ring is
    written by ``layers.cache_write``: a window split over ranks is
    written by the rank that owns the slot, then gathered."""
    _check_hybrid(cfg)
    cur_len = int(cur_len)
    nb, ge, ns = _hybrid_blocks(cfg)
    token = _tokens(token, params.embed.device)
    h = _embed(params.embed, token, cfg.dtype)
    for bi in range(nb):
        for j in range(ge - 1):
            h = _windowed_decode_layer(params.layers[bi * ge + j], cfg, h, cache["loc_k"][bi, j],
                                       cache["loc_v"][bi, j], cur_len, is_global=False)
        h = _windowed_decode_layer(params.layers[bi * ge + ge - 1], cfg, h, cache["glob_k"][bi],
                                   cache["glob_v"][bi], cur_len, is_global=True)
    for i in range(ns):
        h = _windowed_decode_layer(params.layers[nb * ge + i], cfg, h, cache["suf_k"][i], cache["suf_v"][i],
                                   cur_len, is_global=False)
    h = rmsnorm(params.ln_f, h)
    return dense(params.lm_head, h)[:, 0], cache
