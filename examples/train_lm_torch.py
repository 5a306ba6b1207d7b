"""End-to-end LM training on the PyTorch/CUDA port: train a ~100M-param
llama-style model for a few hundred steps with the full substrate (data
pipeline, AdamW, clipping, checkpointing + resume, straggler policy).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300          # on the card
    PYTHONPATH=src python examples/train_lm_torch.py --small --device cpu --steps 20

The twin of ``examples/train_lm.py`` on ``repro_torch`` alone: the same
configs, batches (``lm_batches``) and optimizer; each step is
``launch.steps.lm_train_step`` (the attention forward and backward are
the ``flash_attention`` kernels on the card at head width 64, their
plain versions on the CPU).  A second run with the same ``--ckpt-dir``
resumes from its last checkpoint.
"""

import argparse
import functools

from repro_torch.data.pipeline import lm_batches
from repro_torch.launch.steps import lm_train_step
from repro_torch.models.transformer import TransformerConfig, transformer_init
from repro_torch.train.optimizer import adamw, param_tree
from repro_torch.train.trainer import TrainLoopConfig, train_loop

import torch


def make_config(small: bool) -> TransformerConfig:
    """The ~100M-parameter model (d_model 640, 12 layers, 10 query heads
    over 2 kv heads, d_head 64, fp32), or ~10M with ``small``."""
    if small:
        return TransformerConfig(vocab=4096, d_model=256, n_layers=4, n_heads=4, kv_heads=2, d_head=64, d_ff=1024,
                                 dtype=torch.float32, kv_block=128)
    return TransformerConfig(vocab=16384, d_model=640, n_layers=12, n_heads=10, kv_heads=2, d_head=64,
                             d_ff=2560, dtype=torch.float32, kv_block=128)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="artifacts/train_lm_torch_ckpt")
    ap.add_argument("--small", action="store_true", help="~10M params for smoke runs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = make_config(args.small)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params on {args.device}")

    model = transformer_init(0, cfg, device=args.device)
    params = param_tree(model)
    opt = adamw(lr=3e-4, weight_decay=0.1)
    step = functools.partial(lm_train_step, model, cfg, opt=opt, n_microbatches=1, ce_chunk=0)

    out = train_loop(
        TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=10),
        step, params, opt.init(params), lm_batches(0, args.batch, args.seq, cfg.vocab),
    )
    losses = [h["loss"] for h in out["history"]]
    if losses:
        print(f"\nloss: first={losses[0]:.3f} last={losses[-1]:.3f} "
              f"({'improved' if losses[-1] < losses[0] else 'no improvement'})")


if __name__ == "__main__":
    main()
