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

``attention_ref(..., return_lse=True)`` also gives each query's fp32
log-sum-exp of the scaled scores (``+inf`` where no key is left), which
the kernel's prefill mappings write for training, and
``attention_bwd_ref`` is the plain version of the backward kernel
(``csrc/flash_attention_bwd.cu``): dQ, dK, dV from the same inputs, the
probabilities recomputed from the log-sum-exp.  With grad mode on and an
operand that requires a gradient, ``attention_ref`` runs out of place,
so that autograd can differentiate it (the plain path a gradient check
holds the kernels to).
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "attention_bwd_ref", "merge_partials_ref", "NEG_INF"]

NEG_INF = -1e30


def _mask(sq, sk, causal, window, q_offset, device):
    """(Sq, Sk) bool: the (query, key) pairs the mask keeps."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq if q_offset is None else int(q_offset))
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_ref(q, k, v, *, causal=False, window=None, scale=None, q_offset=None, return_lse=False):
    """q (B, Hq, Sq, D); k (B, Hkv, Sk, D); v (B, Hkv, Sk, Dv) -> (B, Hq,
    Sq, Dv) in q.dtype; with ``return_lse``, also the (B, Hq, Sq) fp32
    log-sum-exp of each query's scaled scores (``+inf`` where the mask
    leaves no key)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    qf = q.to(torch.float32).reshape(b, hkv, rep, sq, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    mask = _mask(sq, sk, causal, window, q_offset, q.device)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kf)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        # out of place, so that autograd keeps what each step's backward reads
        s = (s * scale).masked_fill(~mask, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        s = torch.exp(s - m).masked_fill(~mask, 0.0)
        l = s.sum(dim=-1, keepdim=True)
        out = torch.einsum("bgrqk,bgkd->bgrqd", s, vf) / l.clamp(min=1e-30)
    else:
        s.mul_(scale).masked_fill_(~mask, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        s.sub_(m).exp_().masked_fill_(~mask, 0.0)
        l = s.sum(dim=-1, keepdim=True)
        out = torch.einsum("bgrqk,bgkd->bgrqd", s, vf).div_(l.clamp(min=1e-30))
    out = out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, math.inf))
    return out, lse.reshape(b, hq, sq)


def attention_bwd_ref(q, k, v, out, lse, dout, *, causal=False, window=None, scale=None, q_offset=None):
    """The gradient of ``attention_ref``'s output: (dq, dk, dv) for the
    upstream gradient ``dout`` (B, Hq, Sq, Dv), each in its input's
    dtype, computed in fp32 as the backward kernel does: p = exp(s -
    lse) where the mask keeps the pair (else 0), D = rowsum(dout * out)
    from the forward's stored ``out``, dS = p (dout . v - D), dq = scale
    dS k, dk = scale dS^T q, dv = p^T dout, the kv heads' gradients
    summed over their query groups."""
    b, hq, sq, d = q.shape
    hkv, sk, dv_w = k.shape[1], k.shape[2], v.shape[-1]
    rep = hq // hkv
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    f32 = torch.float32
    qf = q.to(f32).reshape(b, hkv, rep, sq, d)
    kf, vf = k.to(f32), v.to(f32)
    of = out.to(f32).reshape(b, hkv, rep, sq, dv_w)
    gf = dout.to(f32).reshape(b, hkv, rep, sq, dv_w)
    mask = _mask(sq, sk, causal, window, q_offset, q.device)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kf).mul_(scale)
    p = torch.exp(s.sub_(lse.to(f32).reshape(b, hkv, rep, sq, 1))).masked_fill_(~mask, 0.0)
    dv = torch.einsum("bgrqk,bgrqd->bgkd", p, gf)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", gf, vf)
    delta = (gf * of).sum(dim=-1, keepdim=True)
    ds = p.mul_(dp.sub_(delta))
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds, kf).mul_(scale)
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds, qf).mul_(scale)
    return dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
