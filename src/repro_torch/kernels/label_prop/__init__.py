from .ops import (  # noqa: F401
    col_reduce,
    label_prop_fixpoint,
    label_prop_rect,
    label_prop_round,
    label_prop_update,
    label_propagation_pallas,
    packed_cluster_fixpoint,
    packed_cluster_labels,
    packed_connectivity,
)
