"""deepfm [recsys]: 39 sparse fields, embed_dim=10, MLP 400-400-400, FM
interaction [arXiv:1703.04247].  Criteo-style vocab distribution (heavy
tail: a few 10M-row tables + many small ones) — 18,992,800 rows."""

import torch

from ..models.recsys import DeepFMConfig
from .registry import ArchSpec, RECSYS_SHAPES, register

# deterministic heavy-tailed vocab sizes, 39 fields
CRITEO39_VOCABS = tuple(
    [10_000_000, 4_000_000, 2_000_000, 1_000_000]
    + [500_000] * 3
    + [100_000] * 4
    + [10_000] * 8
    + [1_000] * 12
    + [100] * 8
)
assert len(CRITEO39_VOCABS) == 39

REDUCED_VOCABS = tuple([1000, 500] + [100] * 6)


def make_config():
    return DeepFMConfig(vocab_sizes=CRITEO39_VOCABS, embed_dim=10,
                        mlp_dims=(400, 400, 400), dtype=torch.float32)


def make_reduced_config():
    return DeepFMConfig(vocab_sizes=REDUCED_VOCABS, embed_dim=4,
                        mlp_dims=(16, 16), dtype=torch.float32)


SPEC = register(
    ArchSpec(
        name="deepfm",
        family="recsys",
        make_config=make_config,
        make_reduced_config=make_reduced_config,
        shapes=RECSYS_SHAPES,
    )
)
