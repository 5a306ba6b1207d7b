"""LAF applied to LM-produced embeddings on the PyTorch/CUDA port — the
framework integration the paper targets (clustering neural embeddings).

    PYTHONPATH=src python examples/cluster_embeddings_torch.py              # on the card
    PYTHONPATH=src python examples/cluster_embeddings_torch.py --device cpu --n 1500

The twin of ``examples/cluster_embeddings.py`` on ``repro_torch`` alone.
Trains nothing: a tiny llama-style model (``transformer_init``, random
weights from a seed) embeds token sequences; the final-hidden-state
mean (``transformer_hidden``) becomes each sequence's embedding;
``LAFPipeline`` clusters them with the learned estimator, vs exact
DBSCAN.
"""

import argparse

import numpy as np
import torch

from repro_torch.core.metrics import adjusted_rand_index
from repro_torch.core.pipeline import LAFPipeline
from repro_torch.models.transformer import TransformerConfig, transformer_hidden, transformer_init


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=4000, help="documents embedded (the test split is a fifth)")
    args = ap.parse_args()

    cfg = TransformerConfig(vocab=512, d_model=128, n_layers=2, n_heads=4,
                            kv_heads=2, d_head=32, d_ff=512, dtype=torch.float32,
                            kv_block=64)
    model = transformer_init(0, cfg, device=args.device)

    # synthesize "documents": 12 topics = 12 token distributions
    rng = np.random.default_rng(0)
    n_docs, seq = args.n, 64
    n_topics = 12
    topic_of_doc = rng.integers(0, n_topics, n_docs)
    topic_vocab = rng.integers(0, cfg.vocab, size=(n_topics, 12))  # 12 words/topic
    toks = np.stack([rng.choice(topic_vocab[t], size=seq) for t in topic_of_doc]).astype(np.int64)

    print(f"embedding {n_docs} documents with the LM backbone ({args.device})...")
    embs = []
    with torch.inference_mode():
        for i in range(0, n_docs, 512):
            tk = torch.from_numpy(toks[i : i + 512]).to(model.embed.device)
            embs.append(transformer_hidden(model, cfg, tk).mean(dim=1).float().cpu().numpy())
    embs = np.concatenate(embs)
    # center then normalize: raw untrained-LM embeddings share a huge
    # common component; centering exposes the topical signal (standard
    # embedding post-processing)
    embs -= embs.mean(axis=0, keepdims=True)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)  # angular space

    # auto-select eps: median distance to the tau-th neighbor (the
    # classic k-dist heuristic), so the example is robust to whatever
    # geometry the untrained backbone produces
    tau = 5
    sample = embs[:512]
    dots = sample @ embs.T
    kth = np.sort(1.0 - dots, axis=1)[:, tau]
    eps = float(np.round(np.median(kth) * 1.2, 3))
    print(f"auto-selected eps={eps} (k-dist heuristic)")
    grid = tuple(np.round(np.linspace(eps * 0.5, eps * 1.5, 4), 3))
    pipe = LAFPipeline(eps_grid=grid, epochs=4, seed=0, device=args.device)
    # unshuffled 8:2 split so test rows stay aligned with their topics
    k = int(0.8 * len(embs))
    pipe.fit(embs[:k])
    test, test_topics = embs[k:], topic_of_doc[k:]

    gt = pipe.cluster_dbscan(test, eps, tau).result
    out = pipe.cluster_laf_dbscan(test, eps, tau, alpha=1.2)
    print(f"DBSCAN: {gt.n_clusters} clusters | LAF-DBSCAN: {out.result.n_clusters} "
          f"({out.elapsed_s:.2f}s, {out.result.extras['n_skipped']} queries skipped)")
    print(f"ARI vs DBSCAN:   {adjusted_rand_index(out.result.labels, gt.labels):.4f}")
    print(f"ARI vs topics:   {adjusted_rand_index(out.result.labels, test_topics):.4f} "
          f"(how well clusters recover the true topics)")


if __name__ == "__main__":
    main()
