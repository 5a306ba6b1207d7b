"""Plain PyTorch version of blocked online-softmax attention (the port's
counterpart of ``repro.kernels.flash_attention.ref``): exact fp32
softmax over the whole score matrix.

Query ``i`` sits at ``q_pos = q_offset + i`` (default ``Sk - Sq``: the
queries right-aligned against the keys); ``causal`` keeps
``k_pos <= q_pos`` and ``window`` keeps ``k_pos > q_pos - window``.  GQA
kv heads are read in place: query head ``h`` attends kv head
``h // (Hq // Hkv)``.  Masked scores are ``-1e30`` and their
probabilities exactly 0, and the normalizer is clamped at ``1e-30``, as
in the TPU kernel (``kernel.py:65-80``): a row with no key left gives 0
where ``attention_ref``'s ``-inf`` gives NaN; the two agree on every
other row.  The output is in ``q.dtype``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "merge_partials_ref", "NEG_INF"]

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=False, window=None, scale=None, q_offset=None):
    """q (B, Hq, Sq, D); k (B, Hkv, Sk, D); v (B, Hkv, Sk, Dv) -> (B, Hq,
    Sq, Dv) in q.dtype."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    qf = q.to(torch.float32).reshape(b, hkv, rep, sq, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kf).mul_(scale)
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq if q_offset is None else int(q_offset))
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s.masked_fill_(~mask, NEG_INF)
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_().masked_fill_(~mask, 0.0)
    l = s.sum(dim=-1, keepdim=True).clamp_(min=1e-30)
    out = torch.einsum("bgrqk,bgkd->bgrqd", s, vf).div_(l)
    return out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


def merge_partials_ref(m, l, acc):
    """Merge softmax partials over key chunks (the plain version of the
    decode mapping's merge kernel): chunk ``i`` holds its running max
    ``m[..., i]``, normalizer ``l[..., i]`` and unnormalized P·V
    ``acc[..., i, :]``, all fp32.  Returns ``sum_i e^(m_i - M) acc_i /
    max(sum_i e^(m_i - M) l_i, 1e-30)`` with ``M = max_i m_i``: a wholly
    masked chunk (``m = -1e30``, ``l = 0``, ``acc = 0``) adds exactly 0,
    and a query whose every chunk is masked gives 0."""
    mm = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - mm)
    l_all = (w * l).sum(dim=-1, keepdim=True).clamp_(min=1e-30)
    return (w[..., None] * acc).sum(dim=-2) / l_all
