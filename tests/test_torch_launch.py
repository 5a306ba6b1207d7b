"""The port's launch layer (``repro_torch.launch``) against the JAX
package's, on the CPU.

* ``build_laf_cluster`` at the reduced config is held to the JAX cell's
  jitted ``step_fn`` on a one-device mesh (RMI weights carried by
  ``rmi_from_jax``), the random-projection cell through both evaluators
  (``index_device`` False and True): counts and the gate equal, pairs on
  the threshold counted; predictions within 1e-5 relative;
* the one-launch cell is held to ``repro.kernels.label_prop.
  packed_cluster_fixpoint`` on the same slab (the JAX cell itself does
  not trace in this JAX: ROADMAP C7);
* both cells at worlds 2 and 4 over gloo equal world 1, and the fake
  group's trace of the one-launch cell at world 2 issues the collectives
  the gloo run's ``plane.*`` counters count;
* ``model_flops`` and the roofline terms against the reference's; the
  cost functions against ``PERF.md`` §6's bound inputs; the production
  mesh under a fake group; a dry run of the reduced cells on 8 fake
  ranks.

This module imports no JAX at import time: its rank bodies run in
spawned children that import it.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.testing.ranks import run_ranks

N, D, FRONTIER, TAU = 2048, 64, 256, 5


def _unit(n, d, seed, k=24):
    """Clustered unit rows: k centres, each row a centre plus noise."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, d))
    x = centres[rng.integers(0, k, n)] + 0.55 * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _arch(**overrides):
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.dryrun import cluster_arch

    return cluster_arch(get_arch("laf_dbscan"), reduced=True, **overrides)


def _shape():
    from repro_torch.configs.registry import ShapeSpec

    return ShapeSpec("reduced", "cluster", {"n_points": N, "dim": D})


def _slab(data):
    """The frontier rows' packed exact adjacency against every column."""
    from repro_torch.core.range_query import pack_bitmap

    hit = (data[:FRONTIER] @ data.T) > np.float32(0.45)
    return pack_bitmap(hit).view(np.int32), np.arange(FRONTIER, dtype=np.int32)


def _rmi(seed=0):
    from repro_torch.core.cardinality.rmi import RMI, RMIConfig

    return RMI(RMIConfig(input_dim=D + 1), generator=torch.Generator().manual_seed(seed))


def _cells_on(mesh, device="cpu", **overrides):
    from repro_torch.launch.laf_cluster import build_laf_cluster, build_one_launch_cluster

    arch = _arch(**overrides)
    return build_laf_cluster(arch, _shape(), mesh, device=device), build_one_launch_cluster(arch, _shape(), mesh,
                                                                                              device=device)


def _run_cells(mesh, data, rmi, **overrides):
    """Both cells on this rank's blocks: numpy outputs."""
    from repro_torch.launch.laf_cluster import frontier_inputs, slab_inputs

    frontier, one = _cells_on(mesh, **overrides)
    db, q, sig = frontier_inputs(frontier, mesh, data, data[:FRONTIER], device="cpu")
    counts, partial, pred = frontier.step_fn(rmi, db, q, sig)
    slab, rows = _slab(data)
    outs = one.step_fn(*slab_inputs(one, mesh, slab, rows, TAU, device="cpu"))
    return {"counts": counts.numpy(), "partial": partial.numpy(), "pred": pred.numpy(),
            "labels": outs[0].numpy(), "owner": outs[1].numpy(), "col_sum": outs[2].numpy(),
            "counts1": outs[3].numpy(), "rounds": int(outs[4])}


def _rank_body(rank, world, seed):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import obs
    from repro_torch.obs import metrics

    obs.enable(trace=False, metrics_on=True)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    data = _unit(N, D, seed)
    out = _run_cells(mesh, data, _rmi(), backend="random_projection", index_device=True, telemetry=False)
    metrics.reset()
    _, one = _cells_on(mesh, backend="random_projection", index_device=True, telemetry=False)
    from repro_torch.launch.laf_cluster import slab_inputs

    slab, rows = _slab(data)
    one.step_fn(*slab_inputs(one, mesh, slab, rows, TAU, device="cpu"))
    out["plane"] = metrics.snapshot("plane.")
    return out


@functools.lru_cache(maxsize=None)
def _world_run(world):
    return run_ranks(_rank_body, world, 7, backend="gloo", timeout=180.0, threads=1)


@functools.lru_cache(maxsize=None)
def _world1():
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import fake_group

    with fake_group(1):
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        return _run_cells(mesh, _unit(N, D, 7), _rmi(), backend="random_projection", index_device=True,
                          telemetry=False)


# -- the frontier round against the JAX cell ----------------------------------


@pytest.fixture(scope="module")
def jax_cell_case():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs.laf_dbscan import make_reduced_config
    from repro.configs.registry import ShapeSpec, get_arch
    from repro.core.cardinality.rmi import RMIConfig, init_rmi
    from repro.index.signatures import make_projection, pack_bits
    from repro.launch.laf_cluster import build_laf_cluster as jax_build

    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    data = _unit(N, D, 3)
    params = init_rmi(jax.random.PRNGKey(0), RMIConfig(input_dim=D + 1))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    out = {}
    for backend in ("exact", "random_projection"):
        base = dataclasses.replace(make_reduced_config(), backend=backend)
        arch = dataclasses.replace(get_arch("laf_dbscan"), make_config=lambda base=base: base)
        cell = jax_build(arch, ShapeSpec("reduced", "cluster", {"n_points": N, "dim": D}), mesh)
        args = [params, jnp.asarray(data), jnp.asarray(data[:FRONTIER])]
        sig = None
        if backend == "random_projection":
            proj = jnp.asarray(make_projection(D, base.index_bits, seed=base.index_seed))
            sig = np.asarray(pack_bits((jnp.asarray(data) @ proj) >= 0.0))
            args.append(jnp.asarray(sig))
        counts, partial, pred = jax.jit(cell.step_fn)(*args)
        out[backend] = {"counts": np.asarray(counts), "partial": np.asarray(partial), "pred": np.asarray(pred),
                        "sig": sig, "meta": cell.meta}
    return data, params_np, out


def _boundary(data, eps, rows):
    """Per query row, the pairs within 1e-6 of the threshold in float64."""
    dots = data[rows].astype(np.float64) @ data.astype(np.float64).T
    return (np.abs(dots - (1.0 - eps)) < 1e-6).sum(axis=1)


# (backend, index_device): the random-projection cell through the plain
# band_hits dataflow and through the Hamming kernel's sweep on the plane
JAX_CELL_CASES = [("exact", "auto"), ("random_projection", False), ("random_projection", True)]


@pytest.mark.parametrize("backend,index_device", JAX_CELL_CASES,
                         ids=["exact", "random_projection", "random_projection-kernel"])
def test_laf_cluster_matches_the_jax_cell(jax_cell_case, backend, index_device):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.cardinality.rmi import RMIConfig, rmi_from_jax
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.laf_cluster import build_laf_cluster

    data, params_np, ref = jax_cell_case
    want = ref[backend]
    rmi = rmi_from_jax(params_np, RMIConfig(input_dim=D + 1), device="cpu")
    with fake_group(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        cell = build_laf_cluster(_arch(backend=backend, index_device=index_device), _shape(), mesh, device="cpu")
        args = [rmi, torch.from_numpy(data), torch.from_numpy(data[:FRONTIER])]
        if backend == "random_projection":
            args.append(torch.from_numpy(want["sig"].view(np.int32)))
        counts, partial, pred = cell.step_fn(*args)
    assert cell.meta["n_points"] == want["meta"]["n_points"]
    if backend == "random_projection":
        assert cell.meta["fused_kernel"] is index_device
    np.testing.assert_allclose(pred.numpy(), want["pred"], rtol=1e-5, atol=1e-6)
    alpha_tau = 1.5 * TAU  # the reduced config's alpha * tau
    gate, gate_ref = pred.numpy() >= alpha_tau, want["pred"] >= alpha_tau
    near = np.abs(want["pred"] - alpha_tau) <= 1e-5 * alpha_tau
    assert np.array_equal(gate[~near], gate_ref[~near])
    diff = np.abs(counts.numpy().astype(np.int64) - want["counts"])
    flips = _boundary(data, 0.55, np.arange(FRONTIER))
    print(f"{backend} (index_device={index_device}): {int((diff > 0).sum())} rows differ, {int(flips.sum())} pairs on the threshold, "
          f"{int(near.sum())} gates on alpha*tau")
    assert np.all(diff <= flips + near * 10 ** 6)
    dp = np.abs(partial.numpy().astype(np.int64) - want["partial"])
    assert dp.sum() <= flips.sum()


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (case, edits to the all-equal inputs, want (counts_ok, partial_ok)); band (10, 20)
PARITY_CASES = [
    ("equal", {}, (True, True)),
    ("count_without_cause", {"dc": (0, 1)}, (False, True)),
    ("partial_without_cause", {"dp": (4, 1)}, (True, False)),
    ("near_pair", {"near": (0, 3), "dc": (0, 1), "dp": (3, 1)}, (True, True)),
    ("query_flip_on_t_hi", {"q_flips": (1, 1), "ham": (1, 5, 20), "dc": (1, 1), "dp": (5, 1)}, (True, True)),
    ("beyond_the_pairs_that_may_flip", {"q_flips": (1, 1), "ham": (1, 5, 20), "dc": (1, 2)}, (False, True)),
    ("a_flip_excuses_only_its_row", {"q_flips": (1, 1), "ham": (1, 5, 20), "dc": (0, 1)}, (False, True)),
    ("db_flip_on_t_lo", {"db_flips": (9, 2), "ham": (3, 9, 12), "dc": (3, 1), "dp": (9, 1)}, (True, True)),
    ("gate_excuses_its_count", {"gate_near": 2, "dc": (2, 100)}, (True, True)),
    ("gate_never_excuses_a_partial", {"gate_near": 2, "dp": (7, 1)}, (True, False)),
]


@pytest.mark.parametrize("case,edits,want", PARITY_CASES, ids=[c[0] for c in PARITY_CASES])
def test_smoke_frontier_parity_excuses_only_the_pairs_that_may_flip(case, edits, want):
    """``chip_smoke.frontier_parity`` (the card's frontier cell against its
    CPU copy) lets a count or partial count differ only by the pairs on
    the threshold or moved across a band edge by their own flipped
    signature bits, and a gate on alpha * tau excuse only its row's
    count."""
    rows, n = 4, 12
    dc, dp = torch.zeros(rows, dtype=torch.long), torch.zeros(n, dtype=torch.long)
    near = torch.zeros((rows, n), dtype=torch.bool)
    ham = torch.full((rows, n), 40, dtype=torch.int32)
    q_flips, db_flips = torch.zeros(rows, dtype=torch.long), torch.zeros(n, dtype=torch.long)
    gate_near = torch.zeros(rows, dtype=torch.bool)
    named = {"dc": dc, "dp": dp, "q_flips": q_flips, "db_flips": db_flips}
    for key, v in edits.items():
        if key in named:
            named[key][v[0]] = v[1]
        elif key == "near":
            near[v] = True
        elif key == "ham":
            ham[v[0], v[1]] = v[2]
        else:
            gate_near[v] = True
    got = _chip_smoke().frontier_parity(dc, dp, near, ham, q_flips, db_flips, gate_near, (10, 20))
    assert got[:2] == want


# -- the one-launch cell against packed_cluster_fixpoint ----------------------


def test_one_launch_cell_matches_packed_cluster_fixpoint():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.label_prop import packed_cluster_fixpoint as jax_fixpoint

    data = _unit(N, D, 7)
    slab, rows = _slab(data)
    want = jax_fixpoint(jnp.asarray(slab.view(np.uint32)), jnp.asarray(rows), jnp.int32(TAU), 0, n=N, cap=N,
                        row_tile=256, word_tile=64, interpret=True)
    got = _world1()
    for key, w in zip(("labels", "owner", "col_sum", "counts1"), want[:4]):
        np.testing.assert_array_equal(got[key], np.asarray(w), err_msg=key)
    assert got["rounds"] == int(want[4])
    assert (np.asarray(want[0]) < N).sum() > 0  # some core components


# -- worlds 2 and 4 against world 1 ------------------------------------------


def _concat(ranks, key):
    return np.concatenate([r[key] for r in ranks])


@pytest.mark.parametrize("world", [2, 4])
def test_frontier_cell_across_ranks_equals_world_1(world):
    one, ranks = _world1(), _world_run(world)
    for r in ranks:
        np.testing.assert_array_equal(r["counts"], one["counts"])
        np.testing.assert_array_equal(r["pred"], one["pred"])
    np.testing.assert_array_equal(_concat(ranks, "partial")[:N], one["partial"][:N])


@pytest.mark.parametrize("world", [2, 4])
def test_one_launch_cell_across_ranks_equals_world_1(world):
    one, ranks = _world1(), _world_run(world)
    for r in ranks:
        for key in ("labels", "counts1"):
            np.testing.assert_array_equal(r[key], one[key], err_msg=key)
        assert r["rounds"] == one["rounds"]
    np.testing.assert_array_equal(_concat(ranks, "owner"), one["owner"])
    np.testing.assert_array_equal(_concat(ranks, "col_sum"), one["col_sum"])


def test_fake_trace_collectives_equal_gloo_counters():
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.laf_cluster import build_one_launch_cluster
    from repro_torch.launch.trace_analysis import analyze_trace

    with fake_group(2):
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
        cell = build_one_launch_cluster(_arch(backend="random_projection", telemetry=False), _shape(), mesh)
        tr = analyze_trace(cell.step_fn, *cell.args)
    plane = _world_run(2)[0]["plane"]

    def traced(reduce):
        cs = [c for c in tr.collectives if c.op == "all_reduce" and c.reduce == reduce]
        return len(cs), sum(c.bytes for c in cs)

    assert traced("sum") == (plane["plane.psum.calls"], plane["plane.psum.bytes"])
    assert traced("min") == (plane["plane.pmin.calls"], plane["plane.pmin.bytes"])
    assert traced("min")[0] == 64 and not any(c.op == "all_gather" for c in tr.collectives)
    assert tr.launches == {"kernel.row_popcount.launches": 1, "kernel.label_prop_rect.launches": 64,
                           "kernel.label_prop_update.launches": 64, "kernel.col_reduce.launches": 1}


@pytest.mark.parametrize("mode", ["inference", "grad"])
def test_trace_counts_a_dtensor_product_on_its_local_shards(mode):
    """A product of DTensors on 8 fake ranks, on ``meta`` shards: the
    trace counts rank 0's own product (its FLOPs, its output) and none of
    the ops DTensor's sharding propagation runs on the global shapes
    (torch 2.13 decomposes ``matmul`` there, on plain ``meta`` tensors);
    under ``inference_mode`` the composite ``matmul`` reaches the trace
    whole and is counted as its product."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.trace_analysis import analyze_trace

    b, s, d, f = 64, 32, 128, 256

    def step(x, w):
        with torch.inference_mode() if mode == "inference" else contextlib.nullcontext():
            xd = DTensor.from_local(x, mesh, [Shard(0)], run_check=False)
            wd = DTensor.from_local(w, mesh, [Replicate()], run_check=False)
            return torch.matmul(xd, wd).to_local()

    with fake_group(8):
        mesh = init_device_mesh("cuda", (8,), mesh_dim_names=("data",))
        tr = analyze_trace(step, torch.empty((b, s, d), device="meta"), torch.empty((d, f), device="meta"))
    assert tr.error is None
    assert tr.flops == 2 * b * s * d * f
    assert tr.peak_live_bytes == 4 * (b * s * d + d * f + b * s * f)
    assert tr.foreign_ops  # the propagation ran, and was left out
    assert max(p[0] for p in tr.peak_storages) == 4 * b * s * f


# -- the roofline against the reference's ------------------------------------


META = [
    {"kind": "cluster", "n_points": 152320, "dim": 768, "frontier": 4096},
    {"kind": "train", "active_param_count": 8.0e9, "tokens_per_step": 1 << 20},
    {"kind": "prefill", "active_param_count": 2.1e10, "tokens_per_step": 1 << 15},
    {"kind": "train", "n_edges": 10556},
    {"kind": "one_launch_cluster", "n_points": 152185, "cap": 155648, "frontier": 4096},
]


@pytest.mark.parametrize("meta", META, ids=[m["kind"] for m in META])
def test_model_flops_equal_the_reference(meta):
    pytest.importorskip("jax")
    from repro.launch import roofline as ref

    from repro_torch.launch import roofline

    for n_dev in (1, 256, 512):
        assert roofline.model_flops(meta, meta["kind"], n_dev) == ref.model_flops(meta, meta["kind"], n_dev)


def test_roofline_terms_scale_with_the_constants():
    pytest.importorskip("jax")
    from repro.launch import roofline as ref

    from repro_torch.launch import roofline

    flops, nbytes, coll = 3.1e12, 7.7e11, 1.3e9
    base = {"arch": "laf_dbscan", "shape": "web_1b", "mesh": "pod16x16", "n_devices": 256, "status": "ok"}
    meta = {"kind": "cluster", "n_points": 1 << 30, "dim": 768, "frontier": 4096}
    want = ref.roofline_row({**base, "meta": meta, "hlo_analysis": {
        "flops": flops, "bytes_accessed": nbytes, "collectives": {"total": {"bytes": coll}}},
        "memory_analysis": {"bytes_per_device": {"total": 2 ** 33}}})
    got = roofline.roofline_row({**base, "meta": {**meta, "dtype": "bfloat16"}, "trace_analysis": {
        "flops": flops, "kernel_ops": {}, "kernel_compute_s": 0.0, "bytes_accessed": nbytes,
        "collectives": {"total": {"bytes": coll}}}, "memory": {"bytes_per_rank": {"peak": 2 ** 33}}})
    assert got.compute_s == pytest.approx(want.compute_s * ref.PEAK_FLOPS / roofline.PEAKS["bfloat16"], rel=1e-12)
    assert got.memory_s == pytest.approx(want.memory_s * ref.HBM_BW / roofline.HBM_BW, rel=1e-12)
    assert got.collective_s == pytest.approx(want.collective_s * ref.LINK_BW / roofline.LINK_BW, rel=1e-12)
    assert got.model_flops == want.model_flops and got.mem_gib == want.mem_gib
    fp32 = roofline.roofline_row({**base, "meta": {**meta, "dtype": "float32"}, "trace_analysis": {
        "flops": flops, "kernel_ops": {}, "kernel_compute_s": 0.0, "bytes_accessed": nbytes,
        "collectives": {"total": {"bytes": coll}}}, "memory": {"bytes_per_rank": {"peak": 2 ** 33}}})
    assert fp32.compute_s / got.compute_s == pytest.approx(989 / 67, rel=1e-9)


# -- the cost functions against PERF.md's bound inputs ----------------------

COSTS = [
    # (cost, the number PERF.md §6 states, what it is)
    ("attention_prefill_ops", 5.50e11, "flash_attention prefill at B 4, Hq 32, S 4096, D 128, causal"),
    ("attention_prefill_bound_ms", 0.556, "its bound on the bf16 tensor cores"),
    ("attention_decode_bytes", 2.15e9, "the decode at B 16, Hq 32, Hkv 8, Sk 32,768, D 128"),
    ("attention_decode_bound_ms", 0.641, "its bytes bound"),
    ("attention_pair_bound_ms", 1.390, "MLA's (192, 128) prefill at B 2, H 128, S 4096: 2·pairs·(192 + 128)"),
    ("attention_bwd_bound_ms", 1.390, "flash_attention_bwd at the D 128 prefill shape"),
    ("attention_bwd_pair_ops", 3.574e12, "flash_attention_bwd at the (192, 128) pair"),
    ("attention_bwd_pair_bound_ms", 3.614, "its bound"),
    ("attention_window_ops", 5.412e11, "gemma3-27b's local layer: prefill at B 1, Hq 32, Hkv 16, S 32,768, D 128, "
                                       "window 1,024 (1/16 of the causal pairs)"),
    ("attention_window_bwd_ops", 1.353e12, "flash_attention_bwd at the same windowed shape"),
    ("attention_offset_decode_bytes", 6.737e7, "a decode at B 16, Hq 32, Hkv 8, Sk 32,768 whose query sits at "
                                               "position 1,023: the first 1,024 keys read"),
    ("embedding_bag_bytes_distinct", 470.2e6, "embedding_bag, 262,144 bags of 20 from 5M x 32, distinct rows"),
    ("embedding_bag_bound_ms", 0.2166, "the same with every id a row (the cost function's upper bound)"),
    ("hamming_filter_ops", 1.28e11, "K1 at 4096 x 30,437, 512 bits"),
    ("rmi_predict_ops", 3.49e11, "rmi_mlp at 30,437 x 769, 1 + 2 + 4 experts"),
    ("hamming_bound_ms", 0.0645, "K1's bytes bound at the same shape"),
    ("row_popcount_bytes", 4 * (18432 * 952 + 18432), "row_popcount on the 18,432 x 952 slab"),
    ("fixpoint_bytes_round", 4 * (18432 * 952 + 32 * 952 + 2 * 18432) + 4 * (3 * 30464 + 18432),
     "a fixpoint round: K2's bytes and the update's"),
]


@pytest.mark.parametrize("name,want,what", COSTS, ids=[c[0] for c in COSTS])
def test_cost_functions_reproduce_the_bound_inputs(name, want, what):
    from repro_torch.kernels import cost

    got = {
        "hamming_filter_ops": lambda: cost.hamming_filter_cost(4096, 30437, 768, 16, bitmap=True).ops,
        "rmi_predict_ops": lambda: cost.rmi_predict_cost(30437, 769, (512, 512, 256, 128), (1, 2, 4)).ops,
        "hamming_bound_ms": lambda: cost.hamming_filter_cost(4096, 30437, 768, 16, bitmap=True).bound_ms()[0],
        "row_popcount_bytes": lambda: cost.row_popcount_cost(18432, 952).bytes,
        "fixpoint_bytes_round": lambda: cost.label_prop_fixpoint_cost(18432, 952, 1).bytes,
        "attention_prefill_ops": lambda: cost.attention_cost(4, 32, 8, 4096, 4096, 128, 128, causal=True).ops,
        "attention_prefill_bound_ms": lambda: cost.attention_cost(4, 32, 8, 4096, 4096, 128, 128,
                                                                  causal=True).bound_ms()[0],
        "attention_decode_bytes": lambda: cost.attention_cost(16, 32, 8, 1, 32768, 128, 128, causal=True).bytes,
        "attention_decode_bound_ms": lambda: cost.attention_cost(16, 32, 8, 1, 32768, 128, 128,
                                                                 causal=True).bound_ms()[0],
        "attention_pair_bound_ms": lambda: cost.attention_cost(2, 128, 128, 4096, 4096, 192, 128,
                                                               causal=True).bound_ms()[0],
        "attention_bwd_bound_ms": lambda: cost.attention_bwd_cost(4, 32, 8, 4096, 4096, 128, 128,
                                                                  causal=True).bound_ms()[0],
        "attention_bwd_pair_ops": lambda: cost.attention_bwd_cost(2, 128, 128, 4096, 4096, 192, 128, causal=True).ops,
        "attention_bwd_pair_bound_ms": lambda: cost.attention_bwd_cost(2, 128, 128, 4096, 4096, 192, 128,
                                                                       causal=True).bound_ms()[0],
        "attention_window_ops": lambda: cost.attention_cost(1, 32, 16, 32768, 32768, 128, 128, causal=True,
                                                            window=1024).ops,
        "attention_window_bwd_ops": lambda: cost.attention_bwd_cost(1, 32, 16, 32768, 32768, 128, 128, causal=True,
                                                                    window=1024).ops,
        "attention_offset_decode_bytes": lambda: cost.attention_cost(16, 32, 8, 1, 32768, 128, 128, causal=True,
                                                                     q_offset=1023).bytes,
        "embedding_bag_bytes_distinct": lambda: cost.embedding_bag_cost(262144, 20, 32, rows=3_247_500).bytes,
        "embedding_bag_bound_ms": lambda: cost.embedding_bag_cost(262144, 20, 32).bound_ms()[0],
    }[name]()
    assert got == pytest.approx(want, rel=0.01), what


@pytest.mark.parametrize("sq,sk,causal,window,q_offset", [
    (7, 7, True, None, None), (5, 9, True, 3, None), (1, 40, True, None, 12), (1, 40, True, 8, 30),
    (6, 6, False, 2, None), (4, 20, True, 5, 2), (3, 3, True, 1, None)])
def test_attention_span_counts_the_kernels_mask(sq, sk, causal, window, q_offset):
    """The pairs and keys the cost functions count are the ones the
    plain version's mask keeps, at every causal, window and offset."""
    from repro_torch.kernels import cost

    off = sk - sq if q_offset is None else q_offset
    qpos = np.arange(sq)[:, None] + off
    kpos = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), dtype=bool)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    read = np.flatnonzero(keep.any(axis=0))
    assert cost.attention_span(sq, sk, causal, window, q_offset) == (
        int(keep.sum()), int(read[-1] - read[0] + 1) if read.size else 0)


# -- the meshes and the dry run ----------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_the_reference(multi_pod, monkeypatch):
    pytest.importorskip("jax")
    import repro.launch.mesh as ref_mesh

    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_production_mesh

    monkeypatch.setattr(ref_mesh.jax, "make_mesh", lambda shape, axes: (tuple(shape), tuple(axes)))
    want = ref_mesh.make_production_mesh(multi_pod=multi_pod)
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert (tuple(mesh.shape), tuple(mesh.mesh_dim_names)) == want


def _model_cell(case):
    """A reduced (arch, shape, variant) of one model builder (the dry-run
    cases below)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import ShapeSpec

    name, kind, variant = {
        "lm-train": ("llama3-8b", "train", "baseline"), "lm-prefill": ("deepseek-v2-236b", "prefill", "baseline"),
        "lm-decode": ("grok-1-314b", "decode", "baseline"), "lm-windowed": ("gemma3-27b", "decode", "windowed"),
        "lm-windowed-b1": ("gemma3-27b", "decode1", "windowed"),
        "recsys-train": ("dien", "train", "baseline"), "recsys-forward": ("autoint", "forward", "baseline"),
        "recsys-retrieval": ("bst", "retrieval", "baseline"), "gnn-molecule": ("gat-cora", "molecule", "baseline"),
        "gnn-edges": ("gat-cora", "full_graph_sm", "baseline")}[case]
    arch = get_arch(name)
    if arch.family == "gnn":
        meta = ({"n_nodes": 6, "n_edges": 10, "batch": 8, "d_feat": 64} if kind == "molecule"
                else {"n_nodes": 40, "n_edges": 101, "d_feat": 1433})
        return arch, ShapeSpec(kind, "train", meta), variant
    cfg = arch.make_reduced_config()
    arch = dataclasses.replace(arch, make_config=lambda: cfg)
    meta = {"train": {"seq_len": 64, "global_batch": 8}, "prefill": {"seq_len": 64, "global_batch": 8},
            "decode": {"seq_len": 64, "global_batch": 8}, "decode1": {"seq_len": 64, "global_batch": 1},
            }.get(kind) if arch.family == "lm" else ({"batch": 1, "n_candidates": 64} if kind == "retrieval"
                                                     else {"batch": 16})
    name = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k", "decode1": "long_500k"}
    return arch, ShapeSpec(name.get(kind, kind) if arch.family == "lm" else kind,
                           "decode" if kind == "decode1" else kind, meta), variant


MODEL_CASES = ["lm-train", "lm-prefill", "lm-decode", "lm-windowed", "lm-windowed-b1", "recsys-train",
               "recsys-forward", "recsys-retrieval", "gnn-molecule", "gnn-edges"]


@pytest.mark.parametrize("variant", ["baseline", "one_launch"] + MODEL_CASES)
def test_dry_run_of_the_reduced_cells_on_8_fake_ranks(variant, tmp_path):
    """One reduced cell of every builder (the cluster cell's two variants,
    each model builder) traced on 8 fake ranks: an ``ok`` record with no
    trace finding, and a roofline row."""
    import json

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.roofline import roofline_row

    with dryrun.fake_group(8):
        mesh = make_test_mesh(8)
        if variant == "lm-windowed-b1":  # B 1: the ring split over ("pod", "data"), written by its one owner
            from torch.distributed.device_mesh import init_device_mesh

            mesh = init_device_mesh("cuda", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        if variant in MODEL_CASES:
            arch, shape, v = _model_cell(variant)
            rec = dryrun.run_cell(arch, shape, mesh, "test2x4", tmp_path, variant=v, verbose=False)
            assert rec["trace_device"] == "meta" and "whole_weights" in rec
        else:
            rec = dryrun.run_cell(_arch(backend="random_projection"), _shape(), mesh, "test2x4", tmp_path,
                                  variant=variant, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    for key in ("meta", "placements", "memory", "trace_analysis", "collectives", "analysis_findings", "wall_s",
                "trace_s", "n_devices"):
        assert key in rec, key
    assert rec["n_devices"] == 8 and rec["analysis_findings"] == []
    assert json.loads(next(tmp_path.glob("test2x4/*.json")).read_text())["status"] == "ok"
    row = roofline_row(rec)
    assert row.status == "ok" and row.mem_gib > 0 and max(row.compute_s, row.memory_s) > 0


def test_dry_run_records_an_injected_fault(tmp_path):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.testing import faults

    with dryrun.fake_group(8), faults.inject("seed=1,dryrun.cell=1:1"):
        mesh = make_test_mesh(8)
        rec = dryrun.run_cell(_arch(backend="random_projection"), _shape(), mesh, "test2x4", tmp_path,
                              verbose=False)
    assert rec["status"] == "error" and "dryrun.cell" in rec["error"] and "fault_plan" in rec
