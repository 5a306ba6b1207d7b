"""The port's sharding rules (``repro_torch.distributed.sharding`` and the
LM rules of ``repro_torch.launch.steps``) against the JAX package's, on
shapes only.

The reference's rules take a ``jax.sharding.AbstractMesh``; the port's
take a stand-in with the two attributes its rules read
(``mesh_dim_names``, ``shape``), so full-size configs cost no memory and
no process group.  A reference ``PartitionSpec`` is compared through
``spec_to_placements`` (an axis that names tensor dimension i is
``Shard(i)`` on that mesh dimension), whose own cases come first.

The mapping for the port's unstacked layers: the reference stacks the
layers on a leading axis and pins each scan slice with
``_lm_shard_layer_params``; the port's per-layer leaf ``layers.i.X``
takes the reference's ``_lm_leaf_spec`` of the slice (its name, the
stacked shape without the layer axis) where the slice has two or more
dimensions, and is replicated where it has one (the reference leaves a
1-D slice unconstrained; its stacked (L, d) norm is ``P(dp, model)``).
``prefix_layers.i.X`` and the top-level leaves (``embed``, ``lm_head``,
``ln_f``) take ``_lm_param_shardings``' rule on their own shapes.
"""

import types

import pytest
import torch

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import get_arch as jax_get_arch
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import transformer as jt

from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.launch import steps
from repro_torch.models import transformer as tt
from torch.distributed.tensor import Replicate, Shard

LM = ["llama3-8b", "gemma3-27b", "granite-20b", "grok-1-314b", "deepseek-v2-236b"]
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), types.SimpleNamespace(mesh_dim_names=names, shape=shape)


def _pl(port_mesh, spec):
    return sh.spec_to_placements(port_mesh, tuple(spec))


@pytest.fixture
def hook_specs(monkeypatch):
    """The reference's hooks return the sharding they would pin."""
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: s)


# ---------------------------------------------------------------------------
# spec_to_placements, named, replicated, param_sharding_rule
# ---------------------------------------------------------------------------


def test_spec_to_placements_maps_each_axis_to_its_dimension():
    m = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 4, 8))
    assert sh.spec_to_placements(m, (None, "model")) == (Replicate(), Replicate(), Shard(1))
    assert sh.spec_to_placements(m, (("pod", "data"), None, "model")) == (Shard(0), Shard(0), Shard(2))
    assert sh.spec_to_placements(m, ("data",)) == (Replicate(), Shard(0), Replicate())
    assert sh.named(m, None, ("pod", "data")) == (Shard(1), Shard(1), Replicate())
    assert sh.replicated(m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sh.spec_to_placements(m, (("data", "pod"),))
    with pytest.raises(ValueError, match="two dimensions"):
        sh.spec_to_placements(m, ("model", "model"))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", [(4096, 14336), (14336, 4096), (128256, 4096), (4096,), (7, 4096), (4096, 7),
                                   (8, 6144, 32768), (16, 16), (8, 8), (3, 5, 7)])
def test_param_sharding_rule_matches_the_reference(mesh, shape):
    jmesh, pmesh = _meshes(mesh)
    assert sh.param_sharding_rule(pmesh, shape) == _pl(pmesh, jsh.param_sharding_rule(jmesh, shape).spec)


def test_tree_rules_map_over_a_port_tree():
    _, pmesh = _meshes("16x16")
    tree = {"a": torch.empty(64, 32), "b": [torch.empty(16), torch.empty(32, 48)]}
    got = sh.tree_param_shardings(pmesh, tree)
    assert got == {"a": (Shard(0), Shard(1)), "b": [(Replicate(), Replicate()), (Shard(0), Shard(1))]}
    assert sh.tree_replicated(pmesh, tree) == {"a": (Replicate(),) * 2, "b": [(Replicate(),) * 2] * 2}


# ---------------------------------------------------------------------------
# the LM rules at full size
# ---------------------------------------------------------------------------


def _ref_leaf(name, abstract):
    """(the reference's keystr, its shape for the port's leaf ``name``,
    whether it is a stacked layer's slice)."""
    parts = name.split(".")
    if parts[0] == "layers":
        node, path = abstract["layers"], ["layers"]
        for q in parts[2:]:
            node, path = node[q], path + [q]
        return "".join(f"['{p}']" for p in path), tuple(node.shape[1:]), True
    if parts[0] == "prefix_layers":
        node, path = abstract["prefix_layers"][int(parts[1])], f"['prefix_layers'][{parts[1]}]"
        for q in parts[2:]:
            node, path = node[q], path + f"['{q}']"
        return path, tuple(node.shape), False
    node = abstract
    for q in parts:
        node = node[q]
    return "".join(f"['{p}']" for p in parts), tuple(node.shape), False


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", LM)
def test_every_lm_leaf_gets_the_reference_placement(name, mesh):
    """Every parameter of each full-size LM config: the port's rule
    (``_lm_param_shardings``) equals the reference's ``_lm_leaf_spec``
    under the mapping of the module docstring; both MoE regimes among
    them (deepseek-v2's 160 experts expert parallel, grok-1's 8 tensor
    parallel)."""
    jmesh, pmesh = _meshes(mesh)
    jcfg = jax_get_arch(name).make_config()
    abstract = jax.eval_shape(lambda: jt.transformer_init(jax.random.PRNGKey(0), jcfg))
    model = tt.transformer_init(0, get_arch(name).make_config(), device="meta")
    rules = steps._lm_param_shardings(pmesh, model)
    assert set(rules) == {n for n, _ in model.named_parameters()}
    moe_leaves = 0
    for pname, p in model.named_parameters():
        key, shape, sliced = _ref_leaf(pname, abstract)
        assert tuple(p.shape) == shape, pname
        if sliced and len(shape) < 2:
            want = sh.replicated(pmesh)
        else:
            want = _pl(pmesh, jsteps._lm_leaf_spec(jmesh, key, shape).spec)
        assert rules[pname] == want, (pname, rules[pname], want)
        moe_leaves += ".moe.w" in pname
    if jcfg.moe is not None:
        assert moe_leaves > 0
        ep = jcfg.moe.n_experts % 16 == 0
        wo = next(r for n, r in rules.items() if n.endswith("moe.wo"))
        assert (wo[-1] == Shard(0)) == ep  # experts over "model" only in the expert-parallel regime


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", LM)
def test_cache_microbatches_and_moe_groups_match_the_reference(name, mesh, hook_specs):
    """``_cache_shardings`` (batch 128 and 1), ``_lm_microbatches``
    (the train, prefill and a per-shard-odd batch), ``_moe_group_config``'s
    groups and the layouts its four hooks pin, and ``_lm_shard_act``."""
    jmesh, pmesh = _meshes(mesh)
    jcfg, cfg = jax_get_arch(name).make_config(), get_arch(name).make_config()
    for batch in (128, 1):
        want = jsteps._cache_shardings(jcfg, jmesh, batch)
        got = steps._cache_shardings(cfg, pmesh, batch)
        assert got == {k: _pl(pmesh, v.spec) for k, v in want.items()}
    for batch in (256, 32, 96, 1):
        assert steps._lm_microbatches(cfg, batch, pmesh) == jsteps._lm_microbatches(jcfg, batch, jmesh), batch
    assert steps.lm_microbatches(cfg, 256) == steps._lm_microbatches(cfg, 256)

    class Rec:  # a stand-in DTensor: its redistribution is the layout asked for
        def __init__(self, *shape):
            self.shape, self.ndim = shape, len(shape)

        def redistribute(self, mesh, placements):
            return placements

    d = cfg.d_model
    assert steps._lm_shard_act(pmesh)(Rec(256, 4096, d)) == _pl(pmesh, jsteps._lm_shard_act(jmesh)(Rec(2, 3, 4)).spec)
    jg, g = jsteps._moe_group_config(jcfg, jmesh), steps._moe_group_config(cfg, pmesh)
    if cfg.moe is None:
        assert g is cfg
        return
    assert g.moe.groups == jg.moe.groups == jsh.axis_size(jmesh, jsh.data_axes(jmesh))
    e, c = cfg.moe.n_experts, 64
    for hook, shape in (("shard_tokens", (g.moe.groups, 512, d)), ("shard_entries", (g.moe.groups, 1024, d)),
                        ("shard_dispatch", (g.moe.groups, e, c, d)), ("shard_buffers", (g.moe.groups, e, c, d))):
        want = _pl(pmesh, getattr(jg.moe, hook)(types.SimpleNamespace(shape=shape)).spec)
        assert getattr(g.moe, hook)(Rec(*shape)) == want, hook
    ep = e % 16 == 0
    assert (g.moe.shard_buffers(Rec(32, e, c, d))[-1] == Shard(1)) == ep


def test_lm_leaf_spec_tensor_parallel_pair():
    """The tensor-parallel regime's Megatron pair at a (2, 4) mesh (3
    experts do not divide 4): wi column-parallel, wo row-parallel, as the
    reference's."""
    jmesh = AbstractMesh((2, 4), ("data", "model"))
    pmesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 4))
    for key, shape in (("['layers']['moe']['wi_gate']", (3, 64, 256)), ("['layers']['moe']['wo']", (3, 256, 64)),
                       ("['layers']['moe']['router']", (64, 3))):
        assert steps._lm_leaf_spec(pmesh, key, shape) == _pl(pmesh, jsteps._lm_leaf_spec(jmesh, key, shape).spec)
    assert steps._lm_leaf_spec(pmesh, "moe.wo", (3, 256, 64)) == (Shard(2), Shard(1))
    assert steps._lm_leaf_spec(pmesh, "moe.wi_up", (3, 64, 256)) == (Shard(1), Shard(2))
    assert jsteps._lm_leaf_spec(jmesh, "x", (64,)).spec == P(None)
