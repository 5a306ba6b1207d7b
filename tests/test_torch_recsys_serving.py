"""Port parity for the recsys serving example (``examples/recsys_serving_torch.py``)
against the reference's flow (``examples/recsys_serving.py``'s steps, built
here from ``repro``) on the same seeded catalogue and the same bst
parameters (the reference's ``bst_init`` draws, carried across by
``recsys_from_jax``), at a small catalogue: 2,000 items in batches of
500, 4 users, bst's reduced config.

* the stream's labels equal the reference's up to relabelling, and with
  them the cluster count, each user's shortlist of clusters and their
  members;
* both top-10 lists, recall@10 and the scored share are equal;
* ``assign``'s labels, confidence and hits are equal;
* the user embeddings agree within 1e-5 (1 + |x|) (one mean of fp32 rows
  in another summation order).

On the CPU the port runs its kernels' plain versions (``device="cpu"``).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import recsys as jr
from repro.stream import StreamingLAF as JStream

from repro_torch.configs import get_arch
from repro_torch.models.recsys import recsys_from_jax

ROOT = Path(__file__).resolve().parents[1]
N_CAND, BATCH, USERS = 2000, 500, 4
TOL_EMB = 1e-5


def _example():
    import importlib.util

    spec = importlib.util.spec_from_file_location("recsys_serving_torch", ROOT / "examples" / "recsys_serving_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(jcfg, jparams, seed=0):
    """``examples/recsys_serving.py``'s steps on the JAX package, at this
    file's sizes (its catalogue, batches and users are arguments here)."""
    rng = np.random.default_rng(seed)
    d = jcfg.embed_dim
    centers = rng.standard_normal((120, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    genre = rng.integers(0, 120, N_CAND)
    cands = centers[genre] + 0.05 * rng.standard_normal((N_CAND, d)).astype(np.float32)
    cands /= np.linalg.norm(cands, axis=1, keepdims=True)
    stream = JStream(0.12, 5, backend="random_projection", device="auto")
    for start in range(0, N_CAND, BATCH):
        stream.partial_fit(cands[start : start + BATCH])
    labels = stream.labels()
    snapshot = stream.snapshot()
    hist = jnp.asarray(rng.integers(0, jcfg.item_vocab, (USERS, jcfg.seq_len)).astype(np.int32))
    q = np.array(jr.bst_user_embedding(jparams, jcfg, hist))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    full = np.asarray(jr.retrieval_scores(jnp.asarray(q), jnp.asarray(cands)))
    top_full = np.argsort(-full, axis=1)[:, :10]
    top_c = snapshot.shortlist(q, 8)
    top_pruned = []
    for b in range(len(q)):
        idx = np.concatenate([snapshot.members(c) for c in top_c[b]])
        s = q[b] @ cands[idx].T
        top_pruned.append(idx[np.argsort(-s)[:10]])
    recall = np.mean([len(set(top_full[b]) & set(top_pruned[b])) / 10 for b in range(len(q))])
    frac = np.mean([np.isin(labels, top_c[b]).mean() for b in range(len(q))])
    return {"stream": stream, "snapshot": snapshot, "catalogue": cands, "labels": labels, "user_embeddings": q,
            "top_clusters": top_c, "top_full": top_full, "top_pruned": top_pruned, "recall": recall,
            "scored_frac": frac, "assign": stream.assign(q)}


@pytest.fixture(scope="module")
def both():
    jcfg = jax_get_arch("bst").make_reduced_config()
    jparams = jr.bst_init(jax.random.PRNGKey(0), jcfg)
    cfg = get_arch("bst").make_reduced_config()
    params = recsys_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    got = _example().serve(cfg, params, n_cand=N_CAND, batch=BATCH, n_users=USERS, device="cpu")
    return _reference(jcfg, jparams), got


def _relabelling(want, got):
    """The port's cluster id -> the reference's, where the labels are
    equal up to relabelling (noise -1 on both)."""
    assert np.array_equal(want < 0, got < 0)
    pairs = set(zip(got[got >= 0].tolist(), want[want >= 0].tolist()))
    to_ref = dict(pairs)
    assert len(to_ref) == len(pairs) == len(set(to_ref.values())), "labels differ beyond relabelling"
    return to_ref


def test_labels_and_clusters_match_reference(both):
    want, got = both
    to_ref = _relabelling(want["labels"], got["labels"])
    assert got["n_clusters"] == want["stream"].n_clusters == len(to_ref)
    assert got["n_clusters"] >= 8 and (got["labels"] >= 0).mean() > 0.5  # the flow has clusters to prune to
    mapped = np.vectorize(to_ref.get)(got["top_clusters"])
    np.testing.assert_array_equal(mapped, want["top_clusters"])
    for c in np.unique(got["top_clusters"]):
        np.testing.assert_array_equal(got["snapshot"].members(c), want["snapshot"].members(to_ref[c]))


def test_user_embeddings_match_reference(both):
    want, got = both
    np.testing.assert_array_equal(got["catalogue"], want["catalogue"])
    w = want["user_embeddings"]
    assert np.all(np.abs(got["user_embeddings"] - w) <= TOL_EMB * (1 + np.abs(w)))


def test_retrieval_lists_and_recall_match_reference(both):
    want, got = both
    np.testing.assert_array_equal(got["top_full"], want["top_full"])
    assert len(got["top_pruned"]) == USERS
    for g, w in zip(got["top_pruned"], want["top_pruned"]):
        np.testing.assert_array_equal(g, w)
    assert got["recall"] == want["recall"] and got["scored_frac"] == want["scored_frac"]
    assert 0 < got["scored_frac"] < 1


def test_assign_matches_reference(both):
    want, got = both
    to_ref = {**_relabelling(want["labels"], got["labels"]), -1: -1}
    np.testing.assert_array_equal([to_ref[int(x)] for x in got["assign_labels"]], want["assign"].labels)
    np.testing.assert_array_equal(got["assign_confidence"], want["assign"].confidence)
    np.testing.assert_array_equal(got["assign_hits"], want["assign"].n_hits)


def test_example_runs_on_the_cpu_and_needs_a_card_otherwise():
    """``examples/recsys_serving_torch.py --device cpu`` prints the
    reference's lines; without ``--device`` it asks for a card and raises
    where none is present."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    cmd = [sys.executable, str(ROOT / "examples" / "recsys_serving_torch.py"), "--n-cand", "1000", "--batch", "500"]
    out = subprocess.run(cmd + ["--device", "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    for head in ("streaming ingest:", "full scan:", "cluster-pruned:", "recall@10 vs full:", "user 3: cluster"):
        assert head in out.stdout, out.stdout
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
        assert out.returncode != 0 and "device='cpu'" in out.stderr
