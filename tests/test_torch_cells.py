"""The port's LM, recsys and GNN cells (``repro_torch.launch.steps``'
``build_cell``) against the JAX package's, on the CPU.

* Structure: every LM, recsys and GNN cell of the registry at (16, 16)
  (gemma3-27b's two ``windowed`` decode cells among them), and one cell
  of each builder at (2, 16, 16), built under the fake process group
  (256 or 512 ranks), against the reference's ``build_cell`` on a
  ``jax.sharding.AbstractMesh`` (no devices): ``meta`` equal on every
  reference key but ``donate``; every argument's global shape (the
  rank's shard shape times its shard counts) and dtype equal; every
  placement equal to ``spec_to_placements`` of the reference's
  in-sharding.  The port's layers are unstacked: a per-layer leaf
  ``layers.i.X`` maps to the reference's stacked leaf with the layer
  axis dropped, its placements the reference's ``_lm_leaf_spec`` of the
  slice (the layout its scan body pins; for every leaf but deepseek-v2's
  shared expert, whose stacked 3-D leaf the MoE rule takes, that is the
  in-sharding less the layer axis), and a 1-D slice is replicated
  (``tests/test_torch_sharding.py``'s mapping).
* Numbers: at the reduced configs, one LM train, prefill, decode and
  windowed decode cell, every recsys arch's three cells and the GNN's
  ``molecule`` and ``full_graph_sm`` run their ``step_fn`` on real CPU
  tensors at world 1 (a one-rank gloo group), against the reference
  cell's jitted ``step_fn`` on a (1, 1) mesh of this process's CPU
  device.  The weights fill the reference's ``jax.eval_shape`` from
  numpy (its own recsys draws compile for a minute) and are carried by
  ``transformer_from_jax``, ``recsys_from_jax`` and ``gnn_from_jax``.
  fp32 tolerances: losses, logits and scores 1e-5 relative (logits and
  scores as relative L2); updated leaves 1e-4 relative L2.  The recsys
  tables hold 4,096 rows (``RECSYS_ROWS``), so the >= 4,096-row rule
  row-shards them and the lookups run through ``layers.sharded_lookup``.
* Operators: each new kernel operator's fake implementation gives the
  plain version's output shapes and dtypes (prefill, decode, MLA's
  (192, 128) pair, the backward, both combiners of ``embedding_bag``).
* ``LafLintPlugin`` (the flake8 entry point) on the corpus's
  traced-branch twins.
"""

import dataclasses
import os
import tempfile
from contextlib import contextmanager

import numpy as np
import pytest
import torch

LM = ["llama3-8b", "gemma3-27b", "granite-20b", "grok-1-314b", "deepseek-v2-236b"]
RECSYS = ["deepfm", "autoint", "dien", "bst"]
RECSYS_ROWS = 4096
REL, REL_LEAF = 1e-5, 1e-4


def _registry_cells():
    from repro_torch.configs import get_arch, list_archs

    out = []
    for name in list_archs():
        arch = get_arch(name)
        if arch.family == "cluster":
            continue
        for shape in arch.shapes:
            if shape not in arch.skips:
                out.append((name, shape, "baseline"))
    return out + [("gemma3-27b", "decode_32k", "windowed"), ("gemma3-27b", "long_500k", "windowed")]


CELLS = _registry_cells()
# one cell of each builder at (2, 16, 16)
SAMPLE = [("llama3-8b", "train_4k", "baseline"), ("deepseek-v2-236b", "prefill_32k", "baseline"),
          ("grok-1-314b", "decode_32k", "baseline"), ("gemma3-27b", "long_500k", "windowed"),
          ("dien", "train_batch", "baseline"), ("deepfm", "serve_p99", "baseline"),
          ("bst", "retrieval_cand", "baseline"), ("gat-cora", "ogb_products", "baseline"),
          ("gat-cora", "molecule", "baseline")]
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


# ---------------------------------------------------------------------------
# structure: the port's cells against the reference's on an AbstractMesh
# ---------------------------------------------------------------------------


def _ref_path(tree, name):
    """The reference's leaf for the port's dotted ``name`` (``layers.i.X``:
    the stacked leaf ``layers.X``, flagged)."""
    parts, node, stacked, i = name.split("."), tree, False, 0
    while i < len(parts):
        q = parts[i]
        node = node[int(q)] if isinstance(node, (list, tuple)) else node[q]
        if q == "layers" and isinstance(node, dict) and i + 1 < len(parts) and parts[i + 1].isdigit():
            stacked, i = True, i + 1  # the reference's stacked layers: the port's layer index has no node
        i += 1
    return node, stacked


def _flat(tree, prefix=""):
    """A port argument tree as {dotted name: leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)) and not (tree and not isinstance(tree[0], (dict, list, tuple, torch.Tensor))):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _dtype_name(dt):
    return str(dt).split(".")[-1]


def _compare_tree(port_args, port_pl, ref_args, ref_sh, pmesh, what, slice_rule=None):
    """Every leaf's global shape, dtype and placements against the
    reference's.  A stacked layer's leaf with a slice of two or more
    dimensions takes ``slice_rule(key, slice shape)`` (the rule the
    reference's scan body pins on the slice) when given, else its
    in-sharding without the layer axis."""
    from repro_torch.distributed.sharding import replicated, spec_to_placements
    from repro_torch.launch.cell import global_shape

    args, pls = _flat(port_args), _flat_pl(port_pl)
    assert set(args) == set(pls), what
    n = 0
    for name, local in args.items():
        pl = pls[name]
        ref, stacked = _ref_path(ref_args, name)
        sh, _ = _ref_path(ref_sh, name)
        spec, shape = tuple(sh.spec), tuple(ref.shape)
        if stacked:
            shape = shape[1:]
            spec = spec[1:] if len(shape) >= 2 else ()
            if len(shape) < 2:
                want = replicated(pmesh)
            elif slice_rule is not None:
                rest = name.split(".")
                rest = rest[rest.index("layers") + 2:]
                key = "['layers']" + "".join(f"['{q}']" for q in rest)
                want = spec_to_placements(pmesh, tuple(slice_rule(key, shape).spec))
            else:
                assert not len(sh.spec) or sh.spec[0] is None, (what, name, sh.spec)
                want = spec_to_placements(pmesh, spec)
        else:
            want = spec_to_placements(pmesh, spec)
        got = tuple(local.shape) if local.dim() == 0 else global_shape(local.shape, pmesh, pl)
        assert got == shape, (what, name, got, shape)
        assert _dtype_name(local.dtype) == _dtype_name(ref.dtype), (what, name, local.dtype, ref.dtype)
        assert tuple(pl) == tuple(want), (what, name, pl, want)
        n += 1
    return n


def _flat_pl(tree, prefix=""):
    from repro_torch.launch.cell import _is_placements

    if _is_placements(tree):
        return {prefix[:-1]: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_pl(v, f"{prefix}{k}."))
        return out
    out = {}
    for i, v in enumerate(tree):
        out.update(_flat_pl(v, f"{prefix}{i}."))
    return out


def _ref_structure(mesh, name, shape, variant):
    """The reference cell's (args, in_shardings, meta) as trees whose
    layout matches the port's argument tuple."""
    from repro.launch import steps as js

    cell = js.build_cell(name, shape, mesh, variant=variant)
    args = cell.args if isinstance(cell.args, tuple) else (cell.args,)
    return args, cell.in_shardings, cell.meta


@pytest.mark.parametrize("mesh_name,name,shape,variant",
                         [("16x16", *c) for c in CELLS] + [("2x16x16", *c) for c in SAMPLE],
                         ids=[f"16x16-{c[0]}-{c[1]}-{c[2]}" for c in CELLS]
                         + [f"2x16x16-{c[0]}-{c[1]}-{c[2]}" for c in SAMPLE])
def test_cell_structure_matches_the_reference(mesh_name, name, shape, variant):
    pytest.importorskip("jax")
    from jax.sharding import AbstractMesh

    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell

    from repro.launch import steps as js

    dims, axes = MESHES[mesh_name]
    jmesh = AbstractMesh(dims, axes)
    ref_args, ref_sh, ref_meta = _ref_structure(jmesh, name, shape, variant)
    # the LM's per-layer leaves: the reference's slice rule (``_lm_leaf_spec``, test_torch_sharding's mapping); the
    # windowed decode's serving rule reads only the last two dimensions, so its stacked spec less the layer axis
    slice_rule = (lambda key, shp: js._lm_leaf_spec(jmesh, key, shp)) if variant == "baseline" else None
    with fake_group(int(np.prod(dims))):
        pmesh = make_production_mesh(multi_pod=len(dims) == 3)
        cell = build_cell(name, shape, pmesh, variant)
        for k, v in ref_meta.items():
            if k != "donate":
                assert cell.meta[k] == v, (k, cell.meta[k], v)
        assert len(cell.args) == len(ref_args) == len(cell.placements)
        n = 0
        for i, (pa, pp, ra, rs) in enumerate(zip(cell.args, cell.placements, ref_args, ref_sh)):
            if isinstance(pa, torch.Tensor):
                pa, pp, ra, rs = {"x": pa}, {"x": pp}, {"x": ra}, {"x": rs}
            n += _compare_tree(pa, pp, ra, rs, pmesh, f"{name}:{shape} arg {i}", slice_rule)
        assert n > 0


# ---------------------------------------------------------------------------
# numbers: the reduced cells at world 1 against the reference's jitted cells
# ---------------------------------------------------------------------------


@contextmanager
def world1():
    """A one-rank gloo group and the (1, 1) ("data", "model") mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        finally:
            dist.destroy_process_group()


def reduced_arch(name, package):
    """The arch with its reduced config (recsys tables at
    ``RECSYS_ROWS`` rows), from ``package`` (``repro`` or
    ``repro_torch``)."""
    import importlib

    arch = importlib.import_module(f"{package}.configs").get_arch(name)
    cfg = arch.make_reduced_config()
    if arch.family == "recsys":
        if hasattr(cfg, "item_vocab"):
            cfg = dataclasses.replace(cfg, item_vocab=RECSYS_ROWS)
        else:
            cfg = dataclasses.replace(cfg, vocab_sizes=(RECSYS_ROWS, *cfg.vocab_sizes[1:]))
    return dataclasses.replace(arch, make_config=lambda: cfg)


def reduced_shape(name, shape):
    from repro_torch.configs.registry import ShapeSpec

    kind = {"train_4k": "train", "prefill_32k": "prefill", "decode_32k": "decode", "long_500k": "decode",
            "train_batch": "train", "serve_p99": "forward", "retrieval_cand": "retrieval"}.get(shape, "train")
    meta = {"train_4k": {"seq_len": 16, "global_batch": 4}, "prefill_32k": {"seq_len": 16, "global_batch": 4},
            "decode_32k": {"seq_len": 8, "global_batch": 4}, "long_500k": {"seq_len": 8, "global_batch": 1},
            "train_batch": {"batch": 8}, "serve_p99": {"batch": 8},
            "retrieval_cand": {"batch": 2, "n_candidates": 64},
            "full_graph_sm": {"n_nodes": 24, "n_edges": 61, "d_feat": 1433},
            "molecule": {"n_nodes": 6, "n_edges": 10, "batch": 4, "d_feat": 64}}[shape]
    return ShapeSpec(shape, kind, meta)


def _fill(abstract, seed):
    """Numpy values for the reference's abstract tree: normal * 0.05 in
    fp32 (ints and bools zero), each leaf's dtype kept."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)

    def one(s):
        if jnp.issubdtype(s.dtype, jnp.floating):
            return jnp.asarray((rng.standard_normal(s.shape) * 0.05).astype(np.float32), dtype=s.dtype)
        return jnp.zeros(s.shape, s.dtype)

    return jax.tree_util.tree_map(one, abstract)


def _inputs(name, shape, cfg, seed=3):
    """The batch of a reduced cell (numpy), one per family and kind."""
    rng = np.random.default_rng(seed)
    m = shape.meta
    if shape.kind in ("train", "prefill") and "seq_len" in m:
        b, s = m["global_batch"], m["seq_len"]
        return {k: rng.integers(0, cfg.vocab, (b, s)).astype(np.int32) for k in ("tokens", "labels")}
    if shape.kind == "decode":
        return {"token": rng.integers(0, cfg.vocab, (m["global_batch"], 1)).astype(np.int32)}
    if name in RECSYS:
        b = m["batch"]
        if name in ("deepfm", "autoint"):
            out = {"ids": np.stack([rng.integers(0, v, b) for v in cfg.vocab_sizes], 1).astype(np.int32)}
        else:
            out = {"hist": rng.integers(0, cfg.item_vocab, (b, cfg.seq_len)).astype(np.int32),
                   "target": rng.integers(0, cfg.item_vocab, b).astype(np.int32)}
        if shape.kind == "train":
            out["label"] = rng.integers(0, 2, b).astype(np.float32)
        if shape.kind == "retrieval":
            out["candidates"] = rng.standard_normal((m["n_candidates"], cfg.embed_dim)).astype(np.float32)
        return out
    if shape.name == "molecule":
        b, n, e, d = m["batch"], m["n_nodes"], m["n_edges"], m["d_feat"]
        return {"feats": rng.standard_normal((b, n, d)).astype(np.float32),
                "src": rng.integers(0, n, (b, e)).astype(np.int32), "dst": rng.integers(0, n, (b, e)).astype(np.int32),
                "y": rng.standard_normal(b).astype(np.float32)}
    n, e, d = m["n_nodes"], m["n_edges"], m["d_feat"]
    return {"feats": rng.standard_normal((n, d)).astype(np.float32), "src": rng.integers(0, n, e).astype(np.int32),
            "dst": rng.integers(0, n, e).astype(np.int32), "labels": rng.integers(0, 7, n).astype(np.int32),
            "label_mask": (rng.random(n) < 0.6).astype(np.float32), "edge_mask": np.ones(e, bool)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(x):
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def port_full_args(name, shape, cell, ref_params, batch):
    """The port cell's whole arguments (before ``shard_args``) from the
    reference's parameters and a numpy batch."""
    from repro_torch.configs import get_arch
    from repro_torch.models import gnn, recsys, transformer

    cfg = cell_cfg(name, shape)
    fam = get_arch(name).family
    if fam == "lm":
        model = transformer.transformer_from_jax(ref_params, cfg, device="cpu")
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
    elif fam == "recsys":
        model = recsys.recsys_from_jax(ref_params, cfg, device="cpu")
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
    else:
        params = gnn.gnn_from_jax(ref_params, device="cpu")
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    kind = shape.kind
    if kind == "train":
        dt = torch.float32 if fam != "lm" or cfg.param_count() <= 1e11 else torch.bfloat16
        zeros = lambda p: torch.zeros(p.shape, dtype=dt)  # noqa: E731
        if fam == "gnn":
            from repro_torch.train.optimizer import tree_map

            opt = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                   "step": torch.zeros((), dtype=torch.int32)}
        else:
            opt = {"m": {n: zeros(p) for n, p in params.items()}, "v": {n: zeros(p) for n, p in params.items()},
                   "step": torch.zeros((), dtype=torch.int32)}
        if fam == "gnn" and shape.name != "molecule":
            from repro_torch.launch.steps import pad_edges

            tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in pad_edges(batch, 1).items()}
        return params, opt, tensors
    if kind == "prefill":
        return params, tensors["tokens"]
    if kind == "decode":
        return None
    if kind == "forward":
        return params, tensors
    cands = tensors.pop("candidates")
    return params, tensors, cands


def cell_cfg(name, shape):
    from repro_torch.configs.gat_cora import config_for_shape

    if name == "gat-cora":
        return config_for_shape(shape.name)
    return reduced_arch(name, "repro_torch").make_config()


NUMBERS = ([("llama3-8b", "train_4k", "baseline"), ("llama3-8b", "prefill_32k", "baseline"),
            ("llama3-8b", "decode_32k", "baseline"), ("gemma3-27b", "decode_32k", "windowed")]
           + [(n, s, "baseline") for n in RECSYS for s in ("train_batch", "serve_p99", "retrieval_cand")]
           + [("gat-cora", "molecule", "baseline"), ("gat-cora", "full_graph_sm", "baseline")])


def ref_cell(name, shape, variant):
    """The reference's cell at the reduced config on a (1, 1) mesh of
    this process's CPU device, its step jitted, and the filled
    parameters."""
    import jax

    from repro.configs.registry import ShapeSpec as JShape
    from repro.launch import steps as js

    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    arch = reduced_arch(name, "repro")
    jshape = JShape(shape.name, shape.kind, dict(shape.meta))
    if arch.family == "lm":
        build = {"train": js.build_lm_train, "prefill": js.build_lm_prefill}.get(shape.kind)
        cell = build(arch, jshape, mesh) if build else js.build_lm_decode(arch, jshape, mesh, variant=variant)
    elif arch.family == "gnn":
        cell = js.build_gnn_train(arch, jshape, mesh)
    else:
        cell = {"train": js.build_recsys_train, "forward": js.build_recsys_forward,
                "retrieval": js.build_recsys_retrieval}[shape.kind](arch, jshape, mesh)
    params = _fill(cell.args[0], 7)
    return cell, jax.jit(cell.step_fn), params, mesh


@pytest.mark.parametrize("name,shape,variant", NUMBERS, ids=[f"{n}-{s}-{v}" for n, s, v in NUMBERS])
def test_reduced_cell_equals_the_reference_cell(name, shape, variant):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro_torch.launch.cell import shard_args
    from repro_torch.launch.steps import build_cell

    shp = reduced_shape(name, shape)
    cfg = cell_cfg(name, shp)
    jcell, jstep, jparams, jmesh = ref_cell(name, shp, variant)
    batch = _inputs(name, shp, cfg)
    with world1() as mesh:
        cell = build_cell(reduced_arch(name, "repro_torch"), shp, mesh, variant)
        if shp.kind == "decode":
            from repro_torch.models import transformer as tt

            model = tt.transformer_from_jax(jparams, cfg, device="cpu")
            params = {n: p.detach().clone() for n, p in model.named_parameters()}
            jcache = _fill(jcell.args[2], 11)
            cache = {k: torch.from_numpy(np.array(v, np.float32)).to(cell.args[2][k].dtype) for k, v in jcache.items()}
            cur = shp.meta["seq_len"] // 2
            args = shard_args(cell, mesh, (params, torch.from_numpy(batch["token"]), cache,
                                           torch.tensor(cur, dtype=torch.int32)))
            logits, new_cache = cell.step_fn(*args)
            jlogits, jnew = jstep(jparams, jnp.asarray(batch["token"]), jcache, jnp.int32(cur))
            assert _rel(_np(logits), np.asarray(jlogits, np.float32)) <= REL
            for k in jnew:
                assert _rel(_np(new_cache[k]), np.asarray(jnew[k], np.float32)) <= REL, k
            return
        full = port_full_args(name, shp, cell, jparams, batch)
        args = shard_args(cell, mesh, full)
        out = cell.step_fn(*args)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "candidates"}
    if shp.kind == "train":
        jopt = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), jcell.args[1])
        if name == "gat-cora" and shape != "molecule":
            from repro_torch.launch.steps import pad_edges

            jbatch = {k: jnp.asarray(v) for k, v in pad_edges(batch, 1).items()}
        jp, _, jm = jstep(jparams, jopt, jbatch)
        params, _, metrics = out
        assert abs(float(_np(metrics["loss"])) - float(jm["loss"])) <= REL * abs(float(jm["loss"]))
        for pname, leaf in _flat(params).items():
            ref, stacked = _ref_path(jp, pname)
            ref = np.asarray(ref, np.float32)
            if stacked:
                ref = ref[int(pname.split(".")[1])]
            assert _rel(_np(leaf), ref) <= REL_LEAF, pname
    elif shp.kind == "prefill":
        assert _rel(_np(out), np.asarray(jstep(jparams, jbatch["tokens"]), np.float32)) <= REL
    elif shp.kind == "forward":
        assert _rel(_np(out), np.asarray(jstep(jparams, jbatch), np.float32)) <= REL
    else:
        want = np.asarray(jstep(jparams, jbatch, jnp.asarray(batch["candidates"])), np.float32)
        assert _rel(_np(out), want) <= REL


# ---------------------------------------------------------------------------
# the operators' fake implementations
# ---------------------------------------------------------------------------

ATTN_CASES = {
    "prefill": ((2, 4, 8, 32), (2, 2, 8, 32), (2, 2, 8, 32), torch.bfloat16),
    "decode": ((2, 4, 1, 128), (2, 2, 40, 128), (2, 2, 40, 128), torch.bfloat16),
    "pair": ((1, 2, 8, 192), (1, 2, 8, 192), (1, 2, 8, 128), torch.bfloat16),
    "fp32": ((1, 2, 8, 16), (1, 1, 8, 16), (1, 1, 8, 16), torch.float32),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_operators_fake_shapes_equal_the_plain_version(case):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention.ops import _attention_bwd_op, _attention_lse_op, _attention_op
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

    qs, ks, vs, dt = ATTN_CASES[case]
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).to(dt) for s in (qs, ks, vs))
    want, lse_want = attention_ref(q, k, v, causal=True, return_lse=True)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fq, fk, fv = (torch.empty(t.shape, dtype=t.dtype, device="cuda") for t in (q, k, v))
        out = _attention_op(fq, fk, fv, True, None, 0.1, ks[2] - qs[2])
        assert (tuple(out.shape), out.dtype) == (tuple(want.shape), want.dtype)
        out, lse = _attention_lse_op(fq, fk, fv, True, None, 0.1, ks[2] - qs[2])
        assert (tuple(out.shape), out.dtype) == (tuple(want.shape), want.dtype)
        assert (tuple(lse.shape), lse.dtype) == (tuple(lse_want.shape), lse_want.dtype)
        if qs[2] > 1:
            grads = _attention_bwd_op(fq, fk, fv, out, lse, torch.empty_like(out), True, None, 0.1, 0)
            ref = attention_bwd_ref(q, k, v, want, lse_want, torch.ones_like(want), causal=True)
            for a, b in zip(grads, ref):
                assert (tuple(a.shape), a.dtype) == (tuple(b.shape), b.dtype)
    meta = _attention_op(*(torch.empty(t.shape, dtype=t.dtype, device="meta") for t in (q, k, v)), True, None,
                         0.1, ks[2] - qs[2])
    assert (tuple(meta.shape), meta.dtype) == (tuple(want.shape), want.dtype)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_operator_fake_shape_equals_the_plain_version(combiner):
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    for dt in (torch.float32, torch.bfloat16):
        table = torch.randn(50, 12).to(dt)
        ids = torch.randint(-1, 50, (7, 5), dtype=torch.int32)
        want = embedding_bag_ref(table, ids, combiner=combiner)
        got = embedding_bag(torch.empty(table.shape, dtype=dt, device="meta"), ids.to("meta"), combiner=combiner)
        assert (tuple(got.shape), got.dtype, got.device.type) == (tuple(want.shape), want.dtype, "meta")


# ---------------------------------------------------------------------------
# laf-lint's flake8 entry point
# ---------------------------------------------------------------------------


def test_laf_lint_plugin_yields_the_ast_codes():
    import ast
    from pathlib import Path

    from repro_torch.analysis.ast_lint import LafLintPlugin

    corpus = Path(__file__).parent / "analysis_corpus_torch"
    bad, ok = corpus / "ast_traced_branch__bad.py", corpus / "ast_traced_branch__ok.py"
    assert LafLintPlugin.name and LafLintPlugin.version
    got = list(LafLintPlugin(ast.parse(bad.read_text()), filename=str(bad)).run())
    assert got and all(msg.startswith("LAF3") for _, _, msg, _ in got)
    assert all(t is LafLintPlugin for *_, t in got)
    assert list(LafLintPlugin(ast.parse(ok.read_text()), filename=str(ok)).run()) == []
