"""granite-20b [dense]: 52L d_model=6144 48H (GQA kv=1 → MQA) d_ff=24576
vocab=49152 — llama-arch, code [arXiv:2405.04324]."""

import torch

from ..models.transformer import TransformerConfig
from .registry import ArchSpec, FULL_ATTENTION_SKIP, LM_SHAPES, register


def make_config():
    return TransformerConfig(
        vocab=49152,
        d_model=6144,
        n_layers=52,
        n_heads=48,
        kv_heads=1,   # MQA
        d_head=128,
        d_ff=24576,
        dtype=torch.bfloat16,
    )


def make_reduced_config():
    return TransformerConfig(
        vocab=512, d_model=96, n_layers=2, n_heads=6, kv_heads=1, d_head=16,
        d_ff=384, dtype=torch.float32, kv_block=64,
    )


SPEC = register(
    ArchSpec(
        name="granite-20b",
        family="lm",
        make_config=make_config,
        make_reduced_config=make_reduced_config,
        shapes=LM_SHAPES,
        skips={"long_500k": FULL_ATTENTION_SKIP},
    )
)
