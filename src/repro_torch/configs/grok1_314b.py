"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 [hf:xai-org/grok-1]."""

import torch

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .registry import ArchSpec, FULL_ATTENTION_SKIP, LM_SHAPES, register


def make_config():
    return TransformerConfig(
        vocab=131072,
        d_model=6144,
        n_layers=64,
        n_heads=48,
        kv_heads=8,
        d_head=128,
        d_ff=32768,
        moe=MoEConfig(
            d_model=6144, d_ff=32768, n_experts=8, top_k=2,
            capacity_factor=1.25, dtype=torch.bfloat16,
        ),
        dtype=torch.bfloat16,
    )


def make_reduced_config():
    return TransformerConfig(
        vocab=512, d_model=64, n_layers=2, n_heads=4, kv_heads=2, d_head=16,
        d_ff=256,
        moe=MoEConfig(d_model=64, d_ff=256, n_experts=4, top_k=2,
                      capacity_factor=2.0, dtype=torch.float32),
        dtype=torch.float32, kv_block=64,
    )


SPEC = register(
    ArchSpec(
        name="grok-1-314b",
        family="lm",
        make_config=make_config,
        make_reduced_config=make_reduced_config,
        shapes=LM_SHAPES,
        skips={"long_500k": FULL_ATTENTION_SKIP},
    )
)
