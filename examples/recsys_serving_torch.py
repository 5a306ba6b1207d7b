"""RecSys serving with LAF-clustered retrieval on the PyTorch/CUDA port:
ingest the candidate item embeddings through the streaming LAF-DBSCAN
subsystem (``repro_torch.stream``), then serve retrieval requests by
scoring cluster centroids first and expanding only the best clusters
(``ClusterIndex.shortlist``), plus cluster assignment with confidence for
the user embeddings themselves (``stream.assign``).

    PYTHONPATH=src python examples/recsys_serving_torch.py                  # on the card
    PYTHONPATH=src python examples/recsys_serving_torch.py --device cpu

The twin of ``examples/recsys_serving.py`` on ``repro_torch`` alone, with
the same steps and printout: the catalogue drawn from ``--seed`` (120
"genres"), ingested in batches by ``StreamingLAF(backend=
"random_projection")`` (the Hamming-filter sweeps and the packed
connectivity on the card), the user tower ``bst_user_embedding`` (one
``embedding_bag`` launch), the full scan (``retrieval_scores``), the
cluster-pruned scan over the 8 best clusters' members, recall@10 against
the full scan, and ``assign``.  ``serve()`` does the work and returns
its results; ``main()`` prints them.  ``--device cpu`` runs every
kernel's plain PyTorch version; on the card a stream or kernel fault
raises (no fallback to the host).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.models.recsys import bst_init, bst_user_embedding, retrieval_scores
from repro_torch.stream import StreamingLAF

N_GENRES = 120
EPS, TAU = 0.12, 5
TOP, EXPAND = 10, 8  # the lists' length; the clusters a pruned scan expands


def catalogue(rng: np.random.Generator, n_cand: int, d: int) -> np.ndarray:
    """(n_cand, d) unit item embeddings around ``N_GENRES`` unit centres
    (noise 0.05), drawn from ``rng`` as the reference example draws them."""
    centers = rng.standard_normal((N_GENRES, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    genre = rng.integers(0, N_GENRES, n_cand)
    cands = centers[genre] + 0.05 * rng.standard_normal((n_cand, d)).astype(np.float32)
    cands /= np.linalg.norm(cands, axis=1, keepdims=True)
    return cands


def _clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def serve(cfg, params, *, seed: int = 0, n_cand: int = 20000, batch: int = 4000, n_users: int = 4,
          device=None) -> dict:
    """The example's flow on ``device`` (``None``: cuda) with the bst
    parameters ``params`` of ``cfg``: the catalogue and the users'
    histories drawn from ``seed``; returns the stream, its snapshot, the
    labels, the user embeddings, both top-``TOP`` lists, recall, the
    scored share, ``assign``'s result and the seconds of each step."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cands = catalogue(rng, n_cand, cfg.embed_dim)

    # offline -> online: the catalogue arrives in batches; each is appended
    # to the signed-RP index on the device and the clusters are maintained
    stream = StreamingLAF(EPS, TAU, backend="random_projection", device=dev)
    t0 = _clock(dev)
    reports = [stream.partial_fit(cands[s : s + batch]) for s in range(0, n_cand, batch)]
    labels = stream.labels()
    ingest_s = _clock(dev) - t0
    snapshot = stream.snapshot()  # centroids + members + signature band

    # online: user query -> score centroids -> expand the best clusters only
    hist = rng.integers(0, cfg.item_vocab, (n_users, cfg.seq_len)).astype(np.int32)
    t0 = _clock(dev)
    q = bst_user_embedding(params, cfg, torch.from_numpy(hist).to(dev)).cpu().numpy()
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_dev = torch.from_numpy(q).to(dev)
    embed_s = _clock(dev) - t0
    cands_dev = torch.from_numpy(cands).to(dev)

    t0 = _clock(dev)
    top_full = torch.topk(retrieval_scores(q_dev, cands_dev), TOP, dim=1).indices.cpu().numpy()
    full_s = _clock(dev) - t0

    t0 = _clock(dev)
    top_c = snapshot.shortlist(q, EXPAND)
    picked = []
    for b in range(len(q)):
        idx = torch.from_numpy(np.concatenate([snapshot.members(c) for c in top_c[b]])).to(dev)
        s = retrieval_scores(q_dev[b : b + 1], cands_dev[idx])[0]
        picked.append(idx[torch.topk(s, min(TOP, len(idx))).indices])
    top_pruned = [p.cpu().numpy() for p in picked]
    pruned_s = _clock(dev) - t0

    recall = float(np.mean([len(set(top_full[b]) & set(top_pruned[b])) / TOP for b in range(len(q))]))
    scored = float(np.mean([np.isin(labels, top_c[b]).mean() for b in range(len(q))]))

    # serving-grade assignment: which cluster each user belongs to, and the
    # share of their eps-neighbors in it; -1 = no cluster reaches them
    t0 = _clock(dev)
    res = stream.assign(q)
    assign_s = _clock(dev) - t0
    return {"stream": stream, "snapshot": snapshot, "catalogue": cands, "labels": labels,
            "n_clusters": stream.n_clusters, "user_embeddings": q, "top_clusters": top_c, "top_full": top_full,
            "top_pruned": top_pruned, "recall": recall, "scored_frac": scored, "assign_labels": res.labels,
            "assign_confidence": res.confidence, "assign_hits": res.n_hits, "n_batches": len(reports),
            "last_batch_s": reports[-1].elapsed_s,
            "seconds": {"ingest": ingest_s, "embed": embed_s, "full_scan": full_s, "pruned_scan": pruned_s,
                        "assign": assign_s}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true", help="bst's full config (a 5M-row item table)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-cand", type=int, default=20000, help="catalogue items")
    ap.add_argument("--batch", type=int, default=4000, help="items a stream batch")
    ap.add_argument("--users", type=int, default=4)
    args = ap.parse_args()

    spec = get_arch("bst")
    cfg = spec.make_config() if args.full else spec.make_reduced_config()
    params = bst_init(args.seed, cfg, device=args.device)
    out = serve(cfg, params, seed=args.seed, n_cand=args.n_cand, batch=args.batch, n_users=args.users,
                device=args.device)
    sec = out["seconds"]
    print(f"streaming ingest:   {out['n_clusters']} clusters in {sec['ingest']:.1f}s "
          f"({np.mean(out['labels'] >= 0) * 100:.0f}% of items clustered, "
          f"{out['n_batches']} batches, last batch {out['last_batch_s'] * 1e3:.0f} ms)")
    print(f"full scan:          {sec['full_scan'] * 1e3:.1f} ms")
    print(f"cluster-pruned:     {sec['pruned_scan'] * 1e3:.1f} ms "
          f"(scored {out['scored_frac'] * 100:.0f}% of candidates)")
    print(f"recall@10 vs full:  {out['recall'] * 100:.0f}%")
    for b in range(len(out["assign_labels"])):
        print(f"user {b}: cluster {out['assign_labels'][b]:>3d}  "
              f"confidence {out['assign_confidence'][b]:.2f}  ({out['assign_hits'][b]} eps-neighbors)")


if __name__ == "__main__":
    main()
