"""Neighbor sampling for GNN minibatch training (numpy copy of
``repro.data.graph_sampler``: the same samples from the same rng; the
``minibatch_lg`` shape's real sampler — GraphSAGE-style uniform fanout
over CSR).

``build_csr`` converts an edge list once; ``sample_fanout`` draws seed
nodes' k-hop neighborhoods with per-hop fanouts (15, 10), emitting a
padded, fixed-shape subgraph block (src/dst/feats/mask) ready for the
fixed-shape GAT train step — padding with a dead node keeps the shapes
static across steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["CSRGraph", "build_csr", "sample_fanout"]


@dataclass
class CSRGraph:
    indptr: np.ndarray    # (N+1,)
    indices: np.ndarray   # (E,) neighbor ids
    n_nodes: int

    def degree(self, nodes):
        return self.indptr[np.asarray(nodes) + 1] - self.indptr[np.asarray(nodes)]


def _stable_order(dst: np.ndarray) -> np.ndarray:
    """``np.argsort(dst, kind="stable")`` for node ids in [0, 2^31): two
    stable passes over the low and the high 16 bits, which numpy sorts by
    radix where its stable sort of int32 keys is a timsort (a stable
    sort's order is unique, so it is the reference's)."""
    dst = np.asarray(dst, dtype=np.int64)
    low = np.argsort((dst & 0xFFFF).astype(np.uint16), kind="stable")
    return low[np.argsort((dst[low] >> 16).astype(np.uint16), kind="stable")]


def build_csr(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> CSRGraph:
    """CSR over incoming edges: neighbors(v) = sources of edges into v."""
    order = _stable_order(dst)
    sorted_dst = dst[order]
    sorted_src = src[order]
    counts = np.bincount(sorted_dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr, sorted_src.astype(np.int32), n_nodes)


def _sample_neighbors(
    g: CSRGraph, nodes: np.ndarray, fanout: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For each node draw ``fanout`` incoming neighbors (with replacement
    when degree < fanout; isolated nodes yield masked self-edges).

    Returns (src (n*f,), dst (n*f,), valid (n*f,)).
    """
    n = len(nodes)
    deg = g.degree(nodes)
    starts = g.indptr[nodes]
    offs = rng.integers(0, np.maximum(deg, 1)[:, None], size=(n, fanout))
    idx = starts[:, None] + offs
    src = g.indices[np.minimum(idx, len(g.indices) - 1 if len(g.indices) else 0)]
    valid = np.broadcast_to((deg > 0)[:, None], (n, fanout)).copy()
    src = np.where(valid, src, nodes[:, None])  # masked self-edge placeholder
    dst = np.broadcast_to(nodes[:, None], (n, fanout))
    return src.reshape(-1), dst.reshape(-1).astype(np.int32), valid.reshape(-1)


def sample_fanout(
    g: CSRGraph,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    feats: np.ndarray,
    rng: np.random.Generator,
) -> Dict[str, np.ndarray]:
    """k-hop fanout sample -> fixed-shape padded subgraph block.

    Block node order: [seeds | hop-1 samples | hop-2 samples | ...] with
    duplicates allowed (each sampled edge brings its own slot — the
    standard trade for static shapes; dedup happens in the aggregation
    by node id).  Edges point child -> parent (message flows to seeds).
    """
    frontier = np.asarray(seeds, dtype=np.int32)
    all_nodes = [frontier]
    srcs, dsts, valids = [], [], []
    offset = len(frontier)
    frontier_pos = np.arange(len(frontier), dtype=np.int32)
    for fanout in fanouts:
        src, dst_nodes, valid = _sample_neighbors(g, frontier, fanout, rng)
        n_new = len(src)
        src_pos = np.arange(offset, offset + n_new, dtype=np.int32)
        dst_pos = np.repeat(frontier_pos, fanout)
        srcs.append(src_pos)
        dsts.append(dst_pos)
        valids.append(valid)
        all_nodes.append(src.astype(np.int32))
        frontier = src.astype(np.int32)
        frontier_pos = src_pos
        offset += n_new

    node_ids = np.concatenate(all_nodes)
    return {
        "node_ids": node_ids,
        "feats": feats[node_ids],
        "src": np.concatenate(srcs),
        "dst": np.concatenate(dsts),
        "edge_mask": np.concatenate(valids),
        "n_seeds": len(seeds),
    }
