"""gat-cora [gnn]: 2 layers, d_hidden=8, 8 heads, attention aggregator
[arXiv:1710.10903] (port of ``repro.configs.gat_cora``).  Shapes:
full-batch Cora, sampled Reddit-scale minibatch (fanout 15-10 — the
neighbor sampler in ``repro_torch.data.graph_sampler``), OGB products
full-batch-large (its edges split over a mesh: ``launch.steps.build_gnn_train``),
batched molecules."""

from ..models.gnn import GATConfig
from .registry import GNN_SHAPES, ArchSpec, register


def make_config():
    return GATConfig(d_in=1433, d_hidden=8, n_heads=8, n_layers=2, n_classes=7)


def make_reduced_config():
    return GATConfig(d_in=32, d_hidden=4, n_heads=2, n_layers=2, n_classes=5)


# per-shape input feature dims differ (cora 1433 / reddit 602 / products 100);
# the caller builds a shape-matched GATConfig via ``config_for_shape``.
def config_for_shape(shape_name: str) -> GATConfig:
    d_feat = {
        "full_graph_sm": 1433,
        "minibatch_lg": 602,
        "ogb_products": 100,
        "molecule": 64,
    }[shape_name]
    n_classes = {"full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47, "molecule": 7}[
        shape_name
    ]
    return GATConfig(d_in=d_feat, d_hidden=8, n_heads=8, n_layers=2, n_classes=n_classes)


SPEC = register(
    ArchSpec(
        name="gat-cora",
        family="gnn",
        make_config=make_config,
        make_reduced_config=make_reduced_config,
        shapes=GNN_SHAPES,
        notes="LAF inapplicable (message passing over given edges; no range queries) — DESIGN.md §4",
    )
)
