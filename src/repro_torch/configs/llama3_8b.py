"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — GQA, 128k vocab [arXiv:2407.21783]."""

import torch

from ..models.transformer import TransformerConfig
from .registry import ArchSpec, FULL_ATTENTION_SKIP, LM_SHAPES, register


def make_config():
    return TransformerConfig(
        vocab=128256,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        kv_heads=8,
        d_head=128,
        d_ff=14336,
        rope_theta=500000.0,
        dtype=torch.bfloat16,
    )


def make_reduced_config():
    return TransformerConfig(
        vocab=512, d_model=128, n_layers=2, n_heads=4, kv_heads=1, d_head=32,
        d_ff=448, rope_theta=500000.0, dtype=torch.float32, kv_block=64,
    )


SPEC = register(
    ArchSpec(
        name="llama3-8b",
        family="lm",
        make_config=make_config,
        make_reduced_config=make_reduced_config,
        shapes=LM_SHAPES,
        skips={"long_500k": FULL_ATTENTION_SKIP},
    )
)
