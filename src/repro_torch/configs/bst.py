"""bst [recsys]: Behavior Sequence Transformer (Alibaba): embed_dim=32,
seq_len=20, 1 block, 8 heads, MLP 1024-512-256 [arXiv:1905.06874]."""

import torch

from ..models.recsys import BSTConfig
from .dien import ITEM_VOCAB
from .registry import ArchSpec, RECSYS_SHAPES, register


def make_config():
    return BSTConfig(item_vocab=ITEM_VOCAB, embed_dim=32, seq_len=20,
                     n_blocks=1, n_heads=8, mlp_dims=(1024, 512, 256),
                     dtype=torch.float32)


def make_reduced_config():
    return BSTConfig(item_vocab=1000, embed_dim=16, seq_len=8,
                     n_blocks=1, n_heads=2, mlp_dims=(32, 16), dtype=torch.float32)


SPEC = register(
    ArchSpec(
        name="bst",
        family="recsys",
        make_config=make_config,
        make_reduced_config=make_reduced_config,
        shapes=RECSYS_SHAPES,
    )
)
