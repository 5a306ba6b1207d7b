"""autoint [recsys]: 39 fields, embed_dim=16, 3 self-attn layers,
2 heads, d_attn=32 [arXiv:1810.11921]."""

import torch

from ..models.recsys import AutoIntConfig
from .deepfm import CRITEO39_VOCABS, REDUCED_VOCABS
from .registry import ArchSpec, RECSYS_SHAPES, register


def make_config():
    return AutoIntConfig(vocab_sizes=CRITEO39_VOCABS, embed_dim=16,
                         n_attn_layers=3, n_heads=2, d_attn=32, dtype=torch.float32)


def make_reduced_config():
    return AutoIntConfig(vocab_sizes=REDUCED_VOCABS, embed_dim=8,
                         n_attn_layers=2, n_heads=2, d_attn=8, dtype=torch.float32)


SPEC = register(
    ArchSpec(
        name="autoint",
        family="recsys",
        make_config=make_config,
        make_reduced_config=make_reduced_config,
        shapes=RECSYS_SHAPES,
    )
)
