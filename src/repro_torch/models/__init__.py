"""Model zoo of the port (counterpart of ``repro.models``): the shared
layers, the decoder-only transformer's serving path (GQA/MQA, sliding
windows with a ring-buffer decode, MoE FFNs in ``moe``, MLA attention
in ``mla``), the recsys rankers (DeepFM, AutoInt, DIEN, BST) with
their user towers and retrieval scoring, and the GAT (``gnn``)."""

from .recsys import (  # noqa: F401
    AutoIntConfig, BSTConfig, DeepFMConfig, DIENConfig,
    autoint_forward, autoint_init, autoint_user_embedding,
    bce_loss, bst_forward, bst_init, bst_user_embedding,
    deepfm_forward, deepfm_init, deepfm_user_embedding,
    dien_forward, dien_init, dien_user_embedding,
    lookup_fields, recsys_from_jax, retrieval_scores,
)
