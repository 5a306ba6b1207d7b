#!/usr/bin/env python3
"""Whose is the loss's rise under the reference's constant ``adamw(3e-4)``
at llama3-8b's full width: the reference's step, or the port's attention
kernels?  The same steps run through the kernels and through the plain
``attention_ref`` with autograd, from the same weights on the same batch.

    python3 scripts/train_lm_lr_witness.py                 # one CUDA card, ~3 min with the build
    python3 scripts/train_lm_lr_witness.py --layers 2 --warmups

llama3-8b at full width (d_model 4,096, 32 heads, 8 kv heads, d_ff
14,336, vocab 128,256), ``--layers`` of 32 (8, as ``chip_smoke.py``'s
phase 14), bf16, remat, B 8 x 4,096, ``lm_batches(0, 8, 4096, 128256)``'s
batch 0 repeated, ``ce_chunk`` 512, ``--steps`` ``lm_train_step``s (clip
1.0) from ``transformer_init(0)``'s weights in each run:

* ``kernel_1mb``: the kernels, one microbatch (phase 14's step), the
  reference's constant ``adamw(3e-4)``;
* ``kernel_8mb`` and ``plain_8mb``: 8 microbatches of one row (the
  reference's fp32 accumulation), through the kernels and through
  ``attention_ref`` in place of ``layers.flash_attention`` (its (1, 32,
  4,096, 4,096) fp32 scores fit beside the state; at 8 rows they would
  not), constant ``adamw(3e-4)``;
* ``warmup_<W>`` for each of ``--warmups``: the kernels, one microbatch,
  ``adamw(warmup_linear(3e-4, W, 10000))``.

Each run prints one JSON line: the loss and the gradient norm before each
update, the step seconds, and the share of the bf16 parameters each
update changed.  The last line compares ``plain_8mb`` with ``kernel_8mb``.
Exits nonzero if a run fails or a loss is not finite.

``--leaf-norms`` runs none of these: from the same weights and batch it
takes the first step's gradients at 1 and at 8 microbatches (accumulated
as ``lm_train_step`` does, no update) and prints each leaf's norm at both,
the leaves that carry the gap between the two global norms, and, for the
embedding, the bf16 gradient against an fp32 scatter-add of the same
tokens' gradients (the gradient at the gathered rows, captured at the
first layer's input).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--warmups", type=int, nargs="*", default=[10, 100])
    ap.add_argument("--leaf-norms", action="store_true", help="the gradient norms a leaf at 1 and 8 microbatches")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("train_lm_lr_witness: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.steps import lm_ce_chunk, lm_optimizer, lm_train_step
    from repro_torch.models import layers
    from repro_torch.models.transformer import transformer_init
    from repro_torch.train.optimizer import adamw, param_tree, tree_leaves
    from repro_torch.train.schedule import warmup_linear

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.build_all(["flash_attention", "flash_attention_bwd"])
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    cfg = dataclasses.replace(get_arch("llama3-8b").make_config(), n_layers=args.layers)
    batch = lm_batches(0, 8, 4096, cfg.vocab)(0)
    chunk = lm_ce_chunk(cfg)
    if args.leaf_norms:
        return leaf_norms(cfg, batch, chunk)

    def run(name, n_mb, opt, plain=False):
        kernel_fn = layers.flash_attention
        if plain:
            layers.flash_attention = lambda q, k, v, **kw: attention_ref(q, k, v, **kw)
        try:
            model = transformer_init(0, cfg, device="cuda").requires_grad_(True)
            params = param_tree(model)
            state = opt.init(params)
            prev = [p.detach().clone() for p in tree_leaves(params)]
            total = sum(p.numel() for p in prev)
            losses, norms, secs, changed = [], [], [], []
            for _ in range(args.steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, state, m = lm_train_step(model, cfg, params, state, batch, n_microbatches=n_mb, ce_chunk=chunk,
                                            opt=opt)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                n = 0
                for p, c in zip(tree_leaves(params), prev):
                    n += int((p.detach() != c).sum())
                    c.copy_(p.detach())
                changed.append(n / total)
            line = {"run": name, "n_layers": cfg.n_layers, "microbatches": n_mb, "attention": "plain" if plain
                    else "kernel", "losses": losses, "grad_norms": norms, "step_s": secs,
                    "changed_share": changed, "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        finally:
            layers.flash_attention = kernel_fn
            model = params = state = prev = None
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        print(json.dumps(line), flush=True)
        return line

    out = {"kernel_1mb": run("kernel_1mb", 1, lm_optimizer(cfg)),
           "plain_8mb": run("plain_8mb", 8, lm_optimizer(cfg), plain=True),
           "kernel_8mb": run("kernel_8mb", 8, lm_optimizer(cfg))}
    for w in args.warmups:
        out[f"warmup_{w}"] = run(f"warmup_{w}", 1, adamw(lr=warmup_linear(3e-4, w, 10_000)))
    k, p = out["kernel_8mb"]["losses"], out["plain_8mb"]["losses"]
    print(json.dumps({"constant_3e-4_rises": {r: out[r]["losses"][-1] > out[r]["losses"][0]
                                              for r in ("kernel_1mb", "kernel_8mb", "plain_8mb")},
                      "kernel_vs_plain_rel_diff": [abs(a - b) / abs(b) for a, b in zip(k, p)],
                      "warmups_fall": {r: v["losses"][-1] < v["losses"][0] for r, v in out.items()
                                       if r.startswith("warmup_")}}), flush=True)
    return 0 if all(math.isfinite(x) for v in out.values() for x in v["losses"]) else 1


def leaf_norms(cfg, batch, chunk, dev="cuda") -> int:
    """Each leaf's gradient norm at 1 and 8 microbatches, and the
    embedding's bf16 gradient against an fp32 scatter of the same
    tokens' gradients (see the module's docstring)."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.models.transformer import transformer_init, transformer_loss

    model = transformer_init(0, cfg, device=dev).requires_grad_(True)
    tokens = torch.from_numpy(batch["tokens"]).to(dev).long()
    labels = torch.from_numpy(batch["labels"]).to(dev).long()
    layer_forward, armed, rows = transformer._layer_forward, [False], {}

    def capture(p, c, h, *args, **kw):  # the gradient at the gathered rows h = embed[tokens]
        if armed[0] and h.requires_grad:
            armed[0] = False
            h.register_hook(lambda g: rows.__setitem__("dh", g.detach()))
        return layer_forward(p, c, h, *args, **kw)

    transformer._layer_forward = capture
    out = {}
    try:
        for n_mb in (1, 8):
            acc, emb32 = {}, torch.zeros(model.embed.shape, dtype=torch.float32, device=dev)
            for i in range(n_mb):  # lm_train_step's split: row r of microbatch i is batch row r * n_mb + i
                for p in model.parameters():
                    p.grad = None
                armed[0] = True
                transformer_loss(model, cfg, tokens[i::n_mb], labels[i::n_mb], ce_chunk=chunk).backward()
                for n, p in model.named_parameters():
                    acc[n] = p.grad.float() if n not in acc else acc[n] + p.grad.float()
                emb32.index_add_(0, tokens[i::n_mb].reshape(-1), rows.pop("dh").float().reshape(-1, cfg.d_model))
            grads = {n: g / n_mb for n, g in acc.items()}
            emb32 /= n_mb
            eg = grads["embed"]
            counts = torch.bincount(tokens.reshape(-1), minlength=cfg.vocab)
            top = [int(t) for t in torch.argsort(counts, descending=True)[:3]]
            out[n_mb] = {"norms": {n: float(g.norm()) for n, g in grads.items()},
                         "global_norm": float(torch.sqrt(sum(g.pow(2).sum() for g in grads.values()))),
                         "embed_fp32_scatter_norm": float(emb32.norm()),
                         "embed_vs_fp32_rel_l2": float((eg - emb32).norm() / emb32.norm()),
                         "embed_rows": {t: {"count": int(counts[t]), "bf16_norm": float(eg[t].norm()),
                                            "fp32_norm": float(emb32[t].norm())} for t in top}}
            print(json.dumps({"microbatches": n_mb, "global_norm": out[n_mb]["global_norm"],
                              **{k: v for k, v in out[n_mb].items() if k not in ("norms", "global_norm")}}),
                  flush=True)
            del acc, grads, emb32
    finally:
        transformer._layer_forward = layer_forward
    n1, n8 = out[1]["norms"], out[8]["norms"]
    gap = sorted(((n8[n] ** 2 - n1[n] ** 2, n) for n in n1), key=lambda x: -abs(x[0]))
    total = out[8]["global_norm"] ** 2 - out[1]["global_norm"] ** 2
    print(json.dumps({"leaf_norms": {n: [n1[n], n8[n]] for n in n1},
                      "gap_of_squared_global_norm": total,
                      "largest_leaf_shares": [(n, d / total if total else None) for d, n in gap[:5]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
