"""dien [recsys]: embed_dim=18, behavior seq_len=100, gru_dim=108,
MLP 200-80, AUGRU interaction [arXiv:1809.03672]."""

import torch

from ..models.recsys import DIENConfig
from .registry import ArchSpec, RECSYS_SHAPES, register

ITEM_VOCAB = 5_000_000  # production-scale item catalogue


def make_config():
    return DIENConfig(item_vocab=ITEM_VOCAB, embed_dim=18, seq_len=100,
                      gru_dim=108, mlp_dims=(200, 80), dtype=torch.float32)


def make_reduced_config():
    return DIENConfig(item_vocab=1000, embed_dim=8, seq_len=12,
                      gru_dim=16, mlp_dims=(16, 8), dtype=torch.float32)


SPEC = register(
    ArchSpec(
        name="dien",
        family="recsys",
        make_config=make_config,
        make_reduced_config=make_reduced_config,
        shapes=RECSYS_SHAPES,
    )
)
