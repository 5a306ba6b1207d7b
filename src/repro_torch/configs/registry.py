"""Architecture registry (port of ``repro.configs.registry``).

Each arch module registers an ``ArchSpec`` carrying its full config, a
reduced same-family config for CPU tests, its shape table and its
documented skips.  ``_ensure_loaded`` imports the configs the port can
run: the five LMs (``llama3_8b``, ``gemma3_27b``, ``granite_20b``,
``grok1_314b``, ``deepseek_v2_236b``), the four recsys rankers
``bst``, ``deepfm``, ``dien`` and ``autoint``, and the GNN
``gat_cora`` (its ``ogb_products`` shape edge-sharded by
``launch.steps.build_gnn_train``), and ``laf_dbscan``, the
paper's own workload (``LAFClusterConfig``, family ``cluster``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping

__all__ = [
    "ShapeSpec", "ArchSpec", "register", "get_arch", "list_archs", "REGISTRY",
    "LM_SHAPES", "FULL_ATTENTION_SKIP", "RECSYS_SHAPES", "GNN_SHAPES",
]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode | forward | retrieval
    meta: Mapping[str, int]


@dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str          # lm | gnn | recsys | cluster
    make_config: Callable[[], Any]
    make_reduced_config: Callable[[], Any]
    shapes: Mapping[str, ShapeSpec]
    skips: Mapping[str, str] = field(default_factory=dict)
    notes: str = ""

    def runnable_shapes(self):
        return {k: v for k, v in self.shapes.items() if k not in self.skips}


REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    REGISTRY[spec.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    _ensure_loaded()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs():
    _ensure_loaded()
    return sorted(REGISTRY)


def _ensure_loaded():
    from . import (  # noqa: F401  (each registers on first import)
        autoint, bst, deepfm, deepseek_v2_236b, dien, gat_cora, gemma3_27b, granite_20b, grok1_314b, laf_dbscan,
        llama3_8b,
    )


# ---------------------------------------------------------------------------
# shared shape tables
# ---------------------------------------------------------------------------

LM_SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    "decode_32k": ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    "long_500k": ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
}

FULL_ATTENTION_SKIP = (
    "long_500k skipped: pure full-attention arch; the 500k-token decode "
    "regime is reserved for sub-quadratic/hybrid archs per the assignment "
    "(DESIGN.md §4)."
)

GNN_SHAPES: Dict[str, ShapeSpec] = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "train", {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}
    ),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg",
        "train",
        {
            "n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
            "fanout1": 15, "fanout2": 10, "d_feat": 602,
        },
    ),
    "ogb_products": ShapeSpec(
        "ogb_products", "train", {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}
    ),
    "molecule": ShapeSpec(
        "molecule", "train", {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 64}
    ),
}

RECSYS_SHAPES: Dict[str, ShapeSpec] = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeSpec("serve_p99", "forward", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "forward", {"batch": 262144}),
    "retrieval_cand": ShapeSpec(
        "retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1000000}
    ),
}
