"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global sliding-window hybrid, 128k context
[hf:google/gemma-3]; the ONE assigned LM arch that runs long_500k
(sub-quadratic local layers)."""

import torch

from ..models.transformer import TransformerConfig
from .registry import ArchSpec, LM_SHAPES, register


def make_config():
    return TransformerConfig(
        vocab=262144,
        d_model=5376,
        n_layers=62,
        n_heads=32,
        kv_heads=16,
        d_head=128,
        d_ff=21504,
        window=1024,       # local sliding window
        global_every=6,    # 5 local : 1 global
        rope_theta=1000000.0,
        dtype=torch.bfloat16,
    )


def make_reduced_config():
    return TransformerConfig(
        vocab=512, d_model=128, n_layers=6, n_heads=4, kv_heads=2, d_head=32,
        d_ff=512, window=8, global_every=6, dtype=torch.float32, kv_block=64,
    )


SPEC = register(
    ArchSpec(
        name="gemma3-27b",
        family="lm",
        make_config=make_config,
        make_reduced_config=make_reduced_config,
        shapes=LM_SHAPES,
        notes="runs long_500k (5:1 local:global hybrid attention)",
    )
)
