"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536 vocab=102400,
MLA kv_lora=512, MoE 2 shared + 160 routed top-6 [arXiv:2405.04434]."""

import torch

from ..models.mla import MLAConfig
from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .registry import ArchSpec, FULL_ATTENTION_SKIP, LM_SHAPES, register


def make_config():
    return TransformerConfig(
        vocab=102400,
        d_model=5120,
        n_layers=60,
        n_heads=128,
        kv_heads=128,
        d_head=128,
        d_ff=12288,        # first (dense) layer FFN
        attention="mla",
        mla=MLAConfig(
            d_model=5120,
            n_heads=128,
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_dim=128,
            qk_rope_dim=64,
            v_dim=128,
        ),
        moe=MoEConfig(
            d_model=5120, d_ff=1536, n_experts=160, top_k=6, n_shared=2,
            capacity_factor=1.25, dtype=torch.bfloat16,
        ),
        n_dense_layers=1,
        dtype=torch.bfloat16,
    )


def make_reduced_config():
    return TransformerConfig(
        vocab=512, d_model=64, n_layers=3, n_heads=4, kv_heads=4, d_head=16,
        d_ff=192, attention="mla",
        mla=MLAConfig(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_dim=16, qk_rope_dim=8, v_dim=16),
        moe=MoEConfig(d_model=64, d_ff=32, n_experts=8, top_k=2, n_shared=1,
                      capacity_factor=2.0, dtype=torch.float32),
        n_dense_layers=1, dtype=torch.float32, kv_block=64,
    )


SPEC = register(
    ArchSpec(
        name="deepseek-v2-236b",
        family="lm",
        make_config=make_config,
        make_reduced_config=make_reduced_config,
        shapes=LM_SHAPES,
        skips={"long_500k": FULL_ATTENTION_SKIP},
        notes="MLA latent cache: decode_32k caches (ckv 512 + krope 64) per token",
    )
)
