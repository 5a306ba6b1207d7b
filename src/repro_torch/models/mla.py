"""Multi-head Latent Attention (port of ``repro.models.mla``; DeepSeek-V2,
arXiv:2405.04434).

KV compression: x -> c_kv (``kv_lora_rank``) + one shared RoPE key
(``qk_rope_dim``); per head K_nope and V expand from c_kv.  Queries go
through their own low-rank path and split into nope + rope parts.

``mla_attention`` is the prefill: q and k concatenate to ``qk_nope_dim +
qk_rope_dim`` (192 at full width) and run ``blockwise_attention``, i.e.
the ``flash_attention`` kernel on the card at the (192, 128) pair: v and
the output at their own 128, nothing padded.  ``mla_decode_step`` is the absorbed decode: W_uk
folds into the query and W_uv into the output, and the softmax runs in
the latent space over the (c_kv, k_rope) cache in plain fp32 PyTorch,
as the reference's jnp einsums do; the cache is written in place at
``cur_len`` and only its first ``cur_len + 1`` rows are read (the
reference masks the rest to -1e30, whose probabilities are exactly 0).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..distributed.sharding import is_dtensor
from .layers import apply_rope, blockwise_attention, cache_write, dense, rmsnorm, split_heads, whole

__all__ = ["MLAConfig", "mla_shapes", "mla_init", "mla_attention", "mla_decode_step"]


@dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    rope_theta: float = 10000.0


def mla_shapes(cfg: MLAConfig, dtype):
    """{name: (shape, dtype)} of the parameter tree, the reference's names
    (``q_norm`` and ``kv_norm`` are norm trees with a ``scale``)."""
    h = cfg.n_heads
    return {
        "wq_a": ((cfg.d_model, cfg.q_lora_rank), dtype),
        "q_norm": {"scale": ((cfg.q_lora_rank,), dtype)},
        "wq_b": ((cfg.q_lora_rank, h * (cfg.qk_nope_dim + cfg.qk_rope_dim)), dtype),
        "wkv_a": ((cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim), dtype),
        "kv_norm": {"scale": ((cfg.kv_lora_rank,), dtype)},
        "wk_b": ((cfg.kv_lora_rank, h * cfg.qk_nope_dim), dtype),
        "wv_b": ((cfg.kv_lora_rank, h * cfg.v_dim), dtype),
        "wo": ((h * cfg.v_dim, cfg.d_model), dtype),
    }


def mla_init(gen: torch.Generator, cfg: MLAConfig, dtype=torch.float32):
    """Random parameters as the reference's ``mla_init`` draws them
    (dense weights normal / sqrt(d_in), norms ones) from ``gen``, on its
    device: other numbers than ``jax.random``'s."""

    def draw(spec, name):
        if isinstance(spec, dict):
            return {k: draw(v, k) for k, v in spec.items()}
        shape, dt = spec
        if name == "scale":
            return torch.ones(shape, dtype=dt, device=gen.device)
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        return w.mul_(1.0 / math.sqrt(shape[0])).to(dt)

    return {k: draw(v, k) for k, v in mla_shapes(cfg, dtype).items()}


def _project_q(params, cfg: MLAConfig, x, positions):
    b, s, _ = x.shape
    q = dense(params["wq_b"], rmsnorm(params["q_norm"], dense(params["wq_a"], x)))
    q = split_heads(q, b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim :]
    q_rope = apply_rope(q_rope, positions[:, None, :], cfg.rope_theta)
    return q_nope, q_rope  # (B, H, S, nope), (B, H, S, rope)


def _compress_kv(params, cfg: MLAConfig, x, positions):
    ckv = whole(dense(params["wkv_a"], x), -1)  # (B, S, kv_lora + rope), cut in two below
    c_kv, k_rope = ckv[..., : cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank :]
    c_kv = rmsnorm(params["kv_norm"], c_kv)
    k_rope = apply_rope(k_rope[:, None], positions[:, None, :], cfg.rope_theta)
    return c_kv, k_rope[:, 0]  # (B, S, kv_lora), (B, S, rope)


def mla_attention(params, cfg: MLAConfig, x, positions, *, causal=True, kv_block=1024):
    """Prefill: x (B, S, d), positions (B, S) -> (out (B, S, d), (c_kv,
    k_rope)).  Scores decompose as q_nope·k_nope + q_rope·k_rope, so the
    concatenated features make one attention problem of width
    ``qk_nope_dim + qk_rope_dim`` with scale 1/sqrt of that width.

    On DTensors (a sharded step) the reference passes this layer no
    hook; the port chooses the kernel's local layout explicitly:
    ``blockwise_attention``'s sharded path, the batch over the data axes
    and the heads (q, k and v have ``n_heads`` each) over ``"model"``
    where they divide, else replicated."""
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _project_q(params, cfg, x, positions)
    c_kv, k_rope = _compress_kv(params, cfg, x, positions)
    k_nope = split_heads(dense(params["wk_b"], c_kv), b, s, h, cfg.qk_nope_dim)
    v = split_heads(dense(params["wv_b"], c_kv), b, s, h, cfg.v_dim)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope[:, None].expand(b, h, s, cfg.qk_rope_dim)], dim=-1)
    out = blockwise_attention(q_cat, k_cat, v, causal=causal, kv_block=kv_block)
    out = out.transpose(1, 2).reshape(b, s, h * cfg.v_dim)
    return dense(params["wo"], out), (c_kv, k_rope)


def mla_decode_step(params, cfg: MLAConfig, x, cache_ckv, cache_krope, cur_len: int):
    """Absorbed decode: x (B, 1, d); cache_ckv (B, S, kv_lora) and
    cache_krope (B, S, rope), written in place at ``cur_len`` -> (out
    (B, 1, d), cache_ckv, cache_krope).  On DTensors (a sharded decode)
    the projections are DTensor ops, the caches are written by
    ``cache_write`` (a sequence-sharded cache by the rank that owns
    ``cur_len``, then gathered) and the latent attention runs on each
    rank's batch rows with ``wk_b`` and ``wv_b`` whole (``local_map``)."""
    b = x.shape[0]
    cur_len = int(cur_len)
    positions = torch.full((b, 1), cur_len, dtype=torch.long, device=x.device)
    q_nope, q_rope = _project_q(params, cfg, x, positions)      # (B, H, 1, *)
    c_new, krope_new = _compress_kv(params, cfg, x, positions)   # (B, 1, kv_lora), (B, 1, rope)
    ckv = cache_write(cache_ckv, 1, cur_len, c_new)
    krope = cache_write(cache_krope, 1, cur_len, krope_new)
    args = (q_nope, q_rope, ckv, krope, params["wk_b"], params["wv_b"])

    def attend(qn, qr, ck, kr, wk, wv):
        return _absorbed_attention(cfg, qn, qr, ck[:, : cur_len + 1], kr[:, : cur_len + 1], wk, wv)

    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.experimental import local_map

        mesh = x.device_mesh
        rows = tuple(Replicate() if not p.is_shard(0) else p for p in ckv.placements)  # the batch as the cache's
        whole = (Replicate(),) * mesh.ndim
        o = local_map(attend, out_placements=list(rows), in_placements=(rows,) * 4 + (whole, whole),
                      device_mesh=mesh, redistribute_inputs=True)(*args)
    else:
        o = attend(*args)
    o = o.transpose(1, 2).reshape(b, 1, cfg.n_heads * cfg.v_dim).to(x.dtype)
    return dense(params["wo"], o), cache_ckv, cache_krope


def _absorbed_attention(cfg: MLAConfig, q_nope, q_rope, ckv, krope, wk_b, wv_b):
    """The latent attention of one decode step in fp32: q (B, H, 1, *)
    against the first n rows of the caches ckv (B, n, kv_lora) and krope
    (B, n, rope) -> (B, H, 1, v)."""
    h = cfg.n_heads
    ckv, krope = ckv.to(torch.float32), krope.to(torch.float32)
    # absorb W_uk: q_lat (B, H, 1, kv_lora) = q_nope @ W_uk (per head)
    wk = wk_b.to(torch.float32).view(cfg.kv_lora_rank, h, cfg.qk_nope_dim)
    q_lat = torch.einsum("bhqd,rhd->bhqr", q_nope.to(torch.float32), wk)
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    logits = (torch.einsum("bhqr,bkr->bhqk", q_lat, ckv)
              + torch.einsum("bhqd,bkd->bhqk", q_rope.to(torch.float32), krope)) * scale
    probs = torch.softmax(logits, dim=-1)
    # attend in the latent space, then absorb W_uv
    o_lat = torch.einsum("bhqk,bkr->bhqr", probs, ckv)           # (B, H, 1, kv_lora)
    wv = wv_b.to(torch.float32).view(cfg.kv_lora_rank, h, cfg.v_dim)
    return torch.einsum("bhqr,rhd->bhqd", o_lat, wv)              # (B, H, 1, v)
