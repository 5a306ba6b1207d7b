"""The recsys and GNN cells across ranks: one gloo spawn at (2, 2) on the
CPU against the same cells at world 1.

Every recsys arch's three cells (tables of ``RECSYS_ROWS`` rows,
row-sharded over both axes by the >= 4,096-row rule; the smaller ones
by the FSDP x TP rule; lookups through ``layers.sharded_lookup``, BST's user
tower through the ``embedding_bag`` kernel's plain version) and the
GAT's ``full_graph_sm`` cell (edges padded to a multiple of 4, split
over both axes, the node arrays replicated) run their ``step_fn`` on
each rank's shards (``launch.cell.shard_args``) and are held to the
same cells on a one-rank group, from the same weights (the port's own
inits) and batches.  The summation order changes with the split, so the
tolerances are test_torch_cells.py's fp32 ones: losses, probabilities
and scores 1e-5 relative, updated leaves 1e-4 relative L2.

This module imports no JAX: its rank body runs in spawned children that
import it.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.testing.ranks import run_ranks

RECSYS = ["deepfm", "autoint", "dien", "bst"]
CASES = ([(n, s) for n in RECSYS for s in ("train_batch", "serve_p99", "retrieval_cand")]
         + [("gat-cora", "full_graph_sm")])
SHAPE = (2, 2)
REL, REL_LEAF = 1e-5, 1e-4


def _full_args(name, shape_name):
    """A case's whole arguments from the port's own init (seed 0) and a
    numpy batch."""
    from test_torch_cells import _inputs, cell_cfg, reduced_shape

    from repro_torch.launch.steps import pad_edges
    from repro_torch.models import gnn, recsys

    shp = reduced_shape(name, shape_name)
    cfg = cell_cfg(name, shp)
    batch = _inputs(name, shp, cfg)
    if name == "gat-cora":
        params = gnn.gat_init(0, cfg, device="cpu")
        batch = pad_edges(batch, SHAPE[0] * SHAPE[1])
    else:
        init = {"deepfm": recsys.deepfm_init, "autoint": recsys.autoint_init, "dien": recsys.dien_init,
                "bst": recsys.bst_init}[name]
        params = {n: p.detach().clone() for n, p in init(0, cfg, device="cpu").named_parameters()}
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    if shp.kind == "train":
        from repro_torch.train.optimizer import tree_map

        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32)  # noqa: E731
        opt = {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": torch.zeros((), dtype=torch.int32)}
        return params, opt, tensors
    if shp.kind == "forward":
        return params, tensors
    cands = tensors.pop("candidates")
    return params, tensors, cands


def _np(x):
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.detach().float().numpy()


def _run(mesh):
    """Every case's cell on ``mesh``: {case: {output name: numpy}}."""
    from test_torch_cells import _flat, reduced_arch, reduced_shape

    from repro_torch.launch.cell import shard_args
    from repro_torch.launch.steps import build_cell

    out = {}
    for name, shape_name in CASES:
        shp = reduced_shape(name, shape_name)
        arch = reduced_arch(name, "repro_torch")
        cell = build_cell(arch, shp, mesh)
        res = cell.step_fn(*shard_args(cell, mesh, _full_args(name, shape_name)))
        if shp.kind == "train":
            params, _, metrics = res
            got = {"loss": _np(metrics["loss"])}
            got.update({f"leaf:{k}": _np(v) for k, v in _flat(params).items()})
        else:
            got = {"out": _np(res)}
        out[f"{name}:{shape_name}"] = got
    return out


def _rank_body(rank, world, shape):
    from torch.distributed.device_mesh import init_device_mesh

    torch.manual_seed(0)
    return _run(init_device_mesh("cpu", shape, mesh_dim_names=("data", "model")))


@functools.lru_cache(maxsize=None)
def _results():
    """(the (2, 2) ranks' results, world 1's): the spawn runs while this
    process runs world 1."""
    from concurrent.futures import ThreadPoolExecutor

    from test_torch_cells import world1

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, _rank_body, SHAPE[0] * SHAPE[1], SHAPE, backend="gloo", timeout=240.0,
                            threads=1)
        with world1() as mesh:
            one = _run(mesh)
        return ranks.result(), one


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", [f"{n}:{s}" for n, s in CASES])
def test_cell_across_2x2_ranks_equals_world_1(case):
    ranks, one = _results()
    want = one[case]
    for r, got_all in enumerate(ranks):
        got = got_all[case]
        assert set(got) == set(want)
        for k, v in want.items():
            tol = REL_LEAF if k.startswith("leaf:") else REL
            assert _rel(got[k], v) <= tol, (r, case, k, _rel(got[k], v))
