"""RMI estimator training, stage by stage (port of
``repro.core.cardinality.training``).

Paper §3.1: every net trains with batch size 512 on MSE of z = log2(1 +
count).  Stage 0 trains on all examples; examples are then routed by the
trained stage's predictions to the next stage's experts, each of which
trains on its share.  Plain autograd with ``torch.optim.Adam`` (betas
0.9/0.999, eps 1e-8: the reference's ``adam``).  The epoch loss is
summed on the device and read once per epoch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import resolve_device
from .features import DEFAULT_EPS_GRID, build_training_set, featurize
from .rmi import MLP, RMI, RMIConfig, rmi_predict, rmi_predict_counts, rmi_route

__all__ = ["TrainedEstimator", "train_mlp", "train_rmi"]

_PREDICT_BATCH = 65536


@dataclass
class TrainedEstimator:
    model: RMI
    cfg: RMIConfig
    history: Dict[str, List[float]] = field(default_factory=dict)
    train_seconds: float = 0.0
    train_n: int = 0  # size of the split the counts were learned against
    set_seconds: float = 0.0  # share of train_seconds spent counting the targets

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _features(self, queries, eps) -> torch.Tensor:
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.device)
        return featurize(q, eps)

    def predict_z(self, queries, eps) -> torch.Tensor:
        return rmi_predict(self.model, self._features(queries, eps))

    def predict_counts(self, queries, eps, *, reference_n: Optional[int] = None) -> np.ndarray:
        """Predicted cardinalities on the host; ``reference_n`` rescales
        from the training-split scale to a target dataset size."""
        c = rmi_predict_counts(self.model, self._features(queries, eps)).cpu().numpy()
        if reference_n is not None and self.train_n:
            c = c * (reference_n / self.train_n)
        return c


def _predict_mlp(mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return torch.cat([mlp(x[s : s + _PREDICT_BATCH]) for s in range(0, x.shape[0], _PREDICT_BATCH)])


def train_mlp(
    feats: torch.Tensor,
    targets: torch.Tensor,
    cfg: RMIConfig,
    *,
    epochs: int,
    batch_size: int,
    lr: float,
    seed: int,
) -> Tuple[MLP, List[float]]:
    """Train one net with Adam/MSE; ``seed`` draws its initial weights
    (CPU generator) and its per-epoch shuffles (device generator)."""
    dev = feats.device
    mlp = MLP(cfg.input_dim, cfg.hidden, generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(mlp.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    shuffle = torch.Generator(device=dev).manual_seed(seed)
    n = feats.shape[0]
    nb = max(1, n // batch_size)
    losses: List[float] = []
    for _ in range(epochs):
        perm = torch.randperm(n, generator=shuffle, device=dev)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for b in range(nb):
            idx = perm[b * batch_size : (b + 1) * batch_size]
            loss = torch.mean(torch.square(mlp(feats[idx]) - targets[idx]))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            total += loss.detach()
        losses.append(float(total) / nb)  # the epoch's one host read
    return mlp, losses


def train_rmi(
    train_vectors,
    *,
    eps_grid=None,
    epochs: int = 200,
    batch_size: int = 512,
    lr: float = 1e-3,
    seed: int = 0,
    feats_targets: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    device=None,
) -> TrainedEstimator:
    """Full stage-wise RMI training on a training split."""
    dev = resolve_device(device)
    t0 = time.time()
    if feats_targets is None:
        feats, targets = build_training_set(train_vectors, eps_grid or DEFAULT_EPS_GRID, device=dev)
    else:
        feats, targets = (torch.as_tensor(np.asarray(a, np.float32)).to(dev) for a in feats_targets)
    set_seconds = time.time() - t0
    cfg = RMIConfig(input_dim=feats.shape[1], target_max=float(targets.max()) + 1e-6)
    model = RMI(cfg, generator=torch.Generator().manual_seed(seed)).to(dev)
    history: Dict[str, List[float]] = {}
    kw = dict(epochs=epochs, batch_size=batch_size, lr=lr)
    net_seed = iter(range(seed * 1000, seed * 1000 + 1000))

    stage0, history["stage0"] = train_mlp(feats, targets, cfg, seed=next(net_seed), **kw)
    model.stages[0][0] = stage0
    pred = _predict_mlp(stage0, feats)
    for s in range(1, len(cfg.stage_sizes)):
        experts = model.stages[s]
        route = rmi_route(pred, len(experts), cfg.target_max)
        new_pred = torch.zeros_like(pred)
        for e in range(len(experts)):
            sel = torch.nonzero(route == e)[:, 0]
            if len(sel) < 2:  # degenerate share: keep the untrained net
                history[f"stage{s}_expert{e}"] = []
                net = experts[e]
                next(net_seed)
            else:
                net, history[f"stage{s}_expert{e}"] = train_mlp(
                    feats[sel], targets[sel], cfg, seed=next(net_seed), **kw
                )
                experts[e] = net
            if len(sel):
                new_pred[sel] = _predict_mlp(net, feats[sel])
        pred = new_pred
    model.eval()
    return TrainedEstimator(model, cfg, history, time.time() - t0, train_n=len(train_vectors),
                            set_seconds=set_seconds)
