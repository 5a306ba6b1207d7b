"""Decoder-only transformer LM, the serving path (port of
``repro.models.transformer``): GQA/MQA + RoPE, a dense SwiGLU FFN, an
optional per-layer sliding-window pattern (Gemma-3's local:global),
prefill and KV-cache decode.

The parameters are an ``nn.Module`` (``Transformer``) whose layers are an
``nn.ModuleList``; the reference stacks them on a leading axis and
``lax.scan``s over them.  Each layer is an ``nn.ModuleDict`` of
``nn.ParameterDict``s with the reference's names (``ln1``, ``ln2``,
``attn`` = ``wq``/``wk``/``wv``/``wo``, ``ffn`` = ``wi_gate``/``wi_up``/
``wo``), and dense weights keep the reference's (in, out) layout, so
``dense(w, x) = x @ w``.  ``transformer_from_jax`` carries the
reference's parameters across.

Attention runs ``layers.blockwise_attention``, i.e. the hand-written
``flash_attention`` kernel on the card.  The GEMMs are ``torch.matmul``
(cuBLAS), as the reference leaves them to XLA.  Serving functions run
under ``torch.inference_mode()``.

Not ported yet (ROADMAP A11): MoE FFNs (``moe.py``), MLA attention
(``mla.py``), the windowed ring-buffer decode of hybrid configs
(``transformer_decode_step_windowed``, ``make_cache_windowed``) and
training (gradients).  A config that needs MoE or MLA raises
``NotImplementedError`` in every function that would run it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from .layers import apply_rope, blockwise_attention, cross_entropy_loss, dense, rmsnorm, swiglu

__all__ = [
    "TransformerConfig", "Transformer", "transformer_init", "transformer_from_jax",
    "transformer_hidden", "transformer_forward", "transformer_loss", "transformer_prefill",
    "make_cache", "transformer_decode_step",
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
    moe: Optional[Any] = None        # the reference's MoEConfig (not ported: ROADMAP A11)
    n_dense_layers: int = 0          # leading layers with dense FFN even when moe set
    attention: str = "gqa"           # "gqa" | "mla" (mla not ported: ROADMAP A11)
    mla: Optional[Any] = None
    dtype: torch.dtype = torch.bfloat16
    kv_block: int = 1024             # the reference's attention KV chunk; the kernel tiles itself
    remat: bool = True               # the reference's checkpointing switch; no training here

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
    if cfg.attention == "mla" or cfg.mla is not None:
        raise NotImplementedError("MLA attention (mla.py) is not ported yet: ROADMAP A11")
    if cfg.moe is not None:
        raise NotImplementedError("MoE FFN layers (moe.py) are not ported yet: ROADMAP A11")
    if cfg.attention != "gqa":
        raise ValueError(f"unknown attention {cfg.attention!r}")


def _windows(cfg: TransformerConfig):
    """Each stacked layer's window: None on global layers (the reference
    passes 1 << 30 there, which masks nothing)."""
    return [None if cfg.layer_is_global(i + cfg.n_dense_layers) else cfg.window
            for i in range(cfg.n_layers - cfg.n_dense_layers)]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _params(shapes, make):
    return nn.ParameterDict({k: nn.Parameter(make(k, s), requires_grad=False) for k, s in shapes.items()})


def _layer(cfg: TransformerConfig, make) -> nn.ModuleDict:
    d, kvd = cfg.d_model, cfg.kv_heads * cfg.d_head
    return nn.ModuleDict({
        "ln1": _params({"scale": (d,)}, make),
        "ln2": _params({"scale": (d,)}, make),
        "attn": _params({"wq": (d, cfg.attn_dim), "wk": (d, kvd), "wv": (d, kvd), "wo": (cfg.attn_dim, d)}, make),
        "ffn": _params({"wi_gate": (d, cfg.d_ff), "wi_up": (d, cfg.d_ff), "wo": (cfg.d_ff, d)}, make),
    })


class Transformer(nn.Module):
    """The reference's parameter pytree as a module: ``embed`` (V, D),
    ``layers`` (one ``ModuleDict`` a stacked layer), ``prefix_layers``
    (the unstacked leading dense layers), ``ln_f``, ``lm_head`` (D, V)."""

    def __init__(self, cfg: TransformerConfig, make):
        super().__init__()
        _check_supported(cfg)
        self.embed = nn.Parameter(make("embed", (cfg.vocab, cfg.d_model)), requires_grad=False)
        self.prefix_layers = nn.ModuleList([_layer(cfg, make) for _ in range(cfg.n_dense_layers)])
        self.layers = nn.ModuleList([_layer(cfg, make) for _ in range(cfg.n_layers - cfg.n_dense_layers)])
        self.ln_f = _params({"scale": (cfg.d_model,)}, make)
        self.lm_head = nn.Parameter(make("lm_head", (cfg.d_model, cfg.vocab)), requires_grad=False)


def transformer_init(seed_or_generator, cfg: TransformerConfig, device=None) -> Transformer:
    """Random parameters as ``transformer_init`` draws them: embed
    normal * 0.02, dense weights normal / sqrt(d_in), norms ones; drawn
    in fp32 on ``device`` and stored in ``cfg.dtype``.  ``device`` is
    ``cuda`` unless the caller passes ``"cpu"``; on ``"meta"`` only the
    shapes exist (nothing is drawn).  The draws come from a
    ``torch.Generator`` (a seed makes one on the device), so they are
    other numbers than ``jax.random``'s for the same seed."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if dev.type == "meta":
        return Transformer(cfg, lambda name, shape: torch.empty(shape, dtype=cfg.dtype, device=dev))
    if isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed_or_generator))

    def make(name, shape):
        if name == "scale":
            return torch.ones(shape, dtype=cfg.dtype, device=dev)
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        w.mul_(0.02 if name == "embed" else 1.0 / math.sqrt(shape[0]))
        return w.to(cfg.dtype)

    with torch.no_grad():
        return Transformer(cfg, make)


def transformer_from_jax(params, cfg: TransformerConfig, device=None) -> Transformer:
    """The port's module holding the reference's parameter pytree
    (arrays as numpy, or anything ``np.asarray`` takes): ``params["layers"]``
    is unstacked along its leading (layer) axis into ``layers``, and
    ``params["prefix_layers"]`` (a list) goes into ``prefix_layers``.
    Values are stored in ``cfg.dtype`` on ``device`` (``cuda`` unless
    ``"cpu"``)."""
    dev = resolve_device(device)
    _check_supported(cfg)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=cfg.dtype)

    def fill(layer, tree, i=None):
        for group, p in layer.items():
            for name, param in p.items():
                a = np.asarray(tree[group][name])
                param.copy_(tensor(a if i is None else a[i]))

    model = Transformer(cfg, lambda name, shape: torch.empty(shape, dtype=cfg.dtype, device=dev))
    with torch.no_grad():
        model.embed.copy_(tensor(params["embed"]))
        model.lm_head.copy_(tensor(params["lm_head"]))
        model.ln_f["scale"].copy_(tensor(params["ln_f"]["scale"]))
        for i, layer in enumerate(model.layers):
            fill(layer, params["layers"], i)
        for layer, tree in zip(model.prefix_layers, params.get("prefix_layers", [])):
            fill(layer, tree)
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _heads(x, b, s, n, d):
    """(B, S, n*d) -> the (B, n, S, d) view the kernel reads in place."""
    return x.view(b, s, n, d).transpose(1, 2)


def _gqa_attend(p, cfg: TransformerConfig, h, positions, *, window):
    b, s, _ = h.shape
    q = _heads(dense(p["wq"], h), b, s, cfg.n_heads, cfg.d_head)
    k = _heads(dense(p["wk"], h), b, s, cfg.kv_heads, cfg.d_head)
    v = _heads(dense(p["wv"], h), b, s, cfg.kv_heads, cfg.d_head)
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    o = blockwise_attention(q, k, v, causal=True, window=window, kv_block=cfg.kv_block)
    o = o.transpose(1, 2).reshape(b, s, cfg.attn_dim)
    return dense(p["wo"], o), (k, v)


def _layer_forward(p, cfg: TransformerConfig, h, positions, window):
    attn_out, _ = _gqa_attend(p["attn"], cfg, rmsnorm(p["ln1"], h), positions, window=window)
    h = h + attn_out
    return h + swiglu(p["ffn"], rmsnorm(p["ln2"], h))


def _tokens(tokens, device):
    return torch.as_tensor(tokens, device=device).long()


@torch.inference_mode()
def transformer_hidden(params: Transformer, cfg: TransformerConfig, tokens):
    """Backbone forward -> final hidden states (B, S, D) after ln_f."""
    _check_supported(cfg)
    tokens = _tokens(tokens, params.embed.device)
    b, s = tokens.shape
    h = params.embed.to(cfg.dtype)[tokens]
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for p in params.prefix_layers:
        h = _layer_forward(p, cfg, h, positions, None)
    for p, window in zip(params.layers, _windows(cfg)):
        h = _layer_forward(p, cfg, h, positions, window)
    return rmsnorm(params.ln_f, h)


@torch.inference_mode()
def transformer_forward(params: Transformer, cfg: TransformerConfig, tokens):
    """Forward -> logits (B, S, V)."""
    return dense(params.lm_head, transformer_hidden(params, cfg, tokens))


@torch.inference_mode()
def transformer_loss(params: Transformer, cfg: TransformerConfig, tokens, labels, *, ce_chunk: Optional[int] = None):
    """Mean next-token cross-entropy (forward only: the port does not
    train yet)."""
    h = transformer_hidden(params, cfg, tokens)
    labels = _tokens(labels, h.device)
    if ce_chunk:
        from .layers import chunked_cross_entropy

        return chunked_cross_entropy(params.lm_head, h, labels, chunk=ce_chunk)
    return cross_entropy_loss(dense(params.lm_head, h), labels)


@torch.inference_mode()
def transformer_prefill(params: Transformer, cfg: TransformerConfig, tokens):
    """Prefill: full-sequence forward returning the last position's
    logits (B, V).  As in the reference, it fills no cache."""
    h = transformer_hidden(params, cfg, tokens)
    return dense(params.lm_head, h[:, -1])


# ---------------------------------------------------------------------------
# decode (KV cache)
# ---------------------------------------------------------------------------


def make_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, device=None):
    """Zeroed K/V caches, (layers, B, Hkv, max_len, Dh) each, on
    ``device`` (``cuda`` unless ``"cpu"``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers - cfg.n_dense_layers, batch, cfg.kv_heads, max_len, cfg.d_head)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=dev), "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if cfg.n_dense_layers:
        pshape = (cfg.n_dense_layers, batch, cfg.kv_heads, max_len, cfg.d_head)
        cache["prefix_k"] = torch.zeros(pshape, dtype=dtype, device=dev)
        cache["prefix_v"] = torch.zeros(pshape, dtype=dtype, device=dev)
    return cache


def _gqa_decode_layer(p, cfg: TransformerConfig, h, k_cache, v_cache, cur_len: int, window):
    """h (B, 1, d); k/v_cache (B, Hkv, S, Dh), written in place at
    ``cur_len``; attention reads the prefix of ``cur_len + 1`` keys."""
    b = h.shape[0]
    x = rmsnorm(p["ln1"], h)
    a = p["attn"]
    q = _heads(dense(a["wq"], x), b, 1, cfg.n_heads, cfg.d_head)
    k = _heads(dense(a["wk"], x), b, 1, cfg.kv_heads, cfg.d_head)
    v = _heads(dense(a["wv"], x), b, 1, cfg.kv_heads, cfg.d_head)
    pos = torch.full((b, 1), cur_len, dtype=torch.long, device=h.device)
    q = apply_rope(q, pos[:, None, :], cfg.rope_theta)
    k = apply_rope(k, pos[:, None, :], cfg.rope_theta)
    k_cache[:, :, cur_len] = k[:, :, 0].to(k_cache.dtype)
    v_cache[:, :, cur_len] = v[:, :, 0].to(v_cache.dtype)
    o = blockwise_attention(
        q, k_cache, v_cache, causal=True, window=window,
        q_offset=cur_len, kv_block=cfg.kv_block, valid_len=cur_len + 1,
    )
    o = o.transpose(1, 2).reshape(b, 1, cfg.attn_dim)
    h = h + dense(a["wo"], o)
    return h + swiglu(p["ffn"], rmsnorm(p["ln2"], h))


@torch.inference_mode()
def transformer_decode_step(params: Transformer, cfg: TransformerConfig, token, cache, cur_len):
    """One decode step: token (B, 1), ``cur_len`` tokens already cached
    -> (logits (B, V), cache).

    The cache is updated in place (``k_cache[..., cur_len, :] = k``) and
    the same dict is returned; the reference returns a new cache built
    by ``dynamic_update_slice``."""
    _check_supported(cfg)
    cur_len = int(cur_len)
    token = _tokens(token, params.embed.device)
    h = params.embed.to(cfg.dtype)[token]
    for i, p in enumerate(params.prefix_layers):
        h = _gqa_decode_layer(p, cfg, h, cache["prefix_k"][i], cache["prefix_v"][i], cur_len, None)
    for i, (p, window) in enumerate(zip(params.layers, _windows(cfg))):
        h = _gqa_decode_layer(p, cfg, h, cache["k"][i], cache["v"][i], cur_len, window)
    h = rmsnorm(params.ln_f, h)
    return dense(params.lm_head, h)[:, 0], cache
