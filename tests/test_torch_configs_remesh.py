"""Port parity for laf_dbscan's config (``repro_torch.configs.laf_dbscan``)
and ``train.fault_tolerance.plan_elastic_remesh`` against the JAX
package: every field of ``LAFClusterConfig`` (``dtype`` as
``torch.float32``), the full and reduced configs, ``LAF_SHAPES``, the
registry entry, and the remesh plan for every survivor count 1..600."""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.configs import laf_dbscan as jcfg
from repro.configs.registry import get_arch as jax_get_arch
from repro.train.fault_tolerance import plan_elastic_remesh as jax_remesh

from repro_torch.configs import get_arch
from repro_torch.configs import laf_dbscan as tcfg
from repro_torch.train.fault_tolerance import plan_elastic_remesh


def _fields(cfg):
    """Field name -> value, the stream config as its own field dict and
    the dtype by name."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        elif f.name == "dtype":
            v = np.dtype(v).name if not isinstance(v, torch.dtype) else str(v).removeprefix("torch.")
        out[f.name] = v
    return out


@pytest.mark.parametrize("make", ["make_config", "make_reduced_config"])
def test_laf_cluster_config_matches_jax(make):
    got, want = getattr(tcfg, make)(), getattr(jcfg, make)()
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert _fields(got) == _fields(want)
    assert got.dtype is torch.float32


def test_laf_cluster_config_defaults_match_jax():
    got, want = tcfg.LAFClusterConfig(n_points=7, dim=3), jcfg.LAFClusterConfig(n_points=7, dim=3)
    assert _fields(got) == _fields(want)
    assert dataclasses.asdict(tcfg.StreamConfig()) == dataclasses.asdict(jcfg.StreamConfig())


def test_laf_shapes_and_registry_entry_match_jax():
    assert {k: (s.name, s.kind, dict(s.meta)) for k, s in tcfg.LAF_SHAPES.items()} == \
        {k: (s.name, s.kind, dict(s.meta)) for k, s in jcfg.LAF_SHAPES.items()}
    spec, jspec = get_arch("laf_dbscan"), jax_get_arch("laf_dbscan")
    assert (spec.family, spec.notes, dict(spec.skips)) == (jspec.family, jspec.notes, dict(jspec.skips))
    assert set(spec.shapes) == set(jspec.shapes)
    assert _fields(spec.make_reduced_config()) == _fields(jspec.make_reduced_config())


def test_plan_elastic_remesh_matches_jax_for_1_to_600():
    for kw in ({}, {"prefer_model": 8, "min_model": 2}, {"prefer_model": 16, "min_model": 16}):
        for alive in range(1, 601):
            try:
                want = jax_remesh(alive, **kw)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    plan_elastic_remesh(alive, **kw)
                continue
            assert plan_elastic_remesh(alive, **kw) == want, (alive, kw)
