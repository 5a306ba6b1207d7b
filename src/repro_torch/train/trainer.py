"""Training loop (port of ``repro.train.trainer``): ties steps, data
pipeline, checkpointing, fault tolerance, straggler policy and metrics
together.

Used by ``examples/train_lm_torch.py`` and ``chip_smoke.py``'s training
phase.  The loop is deliberately dumb and observable: every component
it calls is separately tested.  As in the reference, ``step_fn(params,
opt_state, batch) -> (params, opt_state, metrics)``; the port's steps
update their trees in place and return them.  A restore (on resume, or
after ``GuardedStep`` gives up on a step) copies the checkpoint's
leaves into the live tensors in place, so a module whose parameters the
tree holds (``param_tree``) sees them; a checkpoint either package's
``train_loop`` wrote restores here (same leaf order and paths).  The
final save is skipped when the last step's checkpoint is already on
disk (saved by ``ckpt_every`` on that step, or restored with no step
left to run), where the reference writes the same state again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint, to_tensor
from .fault_tolerance import GuardedStep, StragglerPolicy
from .optimizer import tree_leaves

__all__ = ["TrainLoopConfig", "train_loop"]


@dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 200
    keep_ckpts: int = 3
    log_every: int = 10
    max_retries: int = 2
    resume: bool = True


@torch.no_grad()
def _restore_into(root, template):
    """Restore the newest checkpoint under ``root`` into ``template``'s
    tensors in place; returns its step."""
    restored, step = restore_checkpoint(root, template=template)
    for live, saved in zip(tree_leaves(template), tree_leaves(restored)):
        live.copy_(to_tensor(saved, live))
    return step


def _loss(metrics) -> float:
    loss = metrics.get("loss", np.nan)
    return float(loss.item() if torch.is_tensor(loss) else loss)


def train_loop(
    cfg: TrainLoopConfig,
    step_fn: Callable,                    # (params, opt_state, batch) -> (params, opt_state, metrics)
    params: Any,
    opt_state: Any,
    make_batch: Callable[[int], Any],     # step -> host batch
    *,
    to_device: Callable[[Any], Any] = lambda x: x,
    log: Callable[[str], None] = print,
) -> Dict[str, Any]:
    start = 0
    saved = None  # the step whose checkpoint holds the current state
    ckpt = AsyncCheckpointer(cfg.ckpt_dir, cfg.keep_ckpts) if cfg.ckpt_dir else None
    if ckpt and cfg.resume and latest_step(cfg.ckpt_dir) is not None:
        saved = _restore_into(cfg.ckpt_dir, (params, opt_state))
        start = saved + 1
        log(f"resumed from step {start - 1}")

    state = {"params": params, "opt_state": opt_state}

    def restore():
        if not ckpt:
            raise RuntimeError("unrecoverable failure without checkpointing")
        ckpt.wait()
        s = _restore_into(cfg.ckpt_dir, (state["params"], state["opt_state"]))
        log(f"restored from checkpoint step {s} after repeated failures")

    guarded = GuardedStep(step_fn, max_retries=cfg.max_retries, on_restore=restore)
    straggler = StragglerPolicy()
    history: List[Dict[str, float]] = []

    for step in range(start, cfg.total_steps):
        batch = to_device(make_batch(step))
        res = guarded(state["params"], state["opt_state"], batch)
        state["params"], state["opt_state"], metrics = res.value
        verdict = straggler.observe(res.elapsed_s)
        row = {
            "step": step,
            "loss": _loss(metrics),
            "step_s": res.elapsed_s,
            "slow": bool(verdict["slow"]),
        }
        history.append(row)
        if step % cfg.log_every == 0:
            log(f"step {step}: loss={row['loss']:.4f} ({res.elapsed_s:.2f}s)"
                + (" [straggler]" if verdict["slow"] else ""))
        if verdict["recommend_eject"]:
            log("straggler policy: recommend ejecting slow host / re-mesh")
        saved = None
        if ckpt and (step + 1) % cfg.ckpt_every == 0:
            ckpt.save(step, (state["params"], state["opt_state"]))
            saved = step
    if ckpt:
        if saved != cfg.total_steps - 1:
            ckpt.save(cfg.total_steps - 1, (state["params"], state["opt_state"]))
        ckpt.wait()
    return {"params": state["params"], "opt_state": state["opt_state"], "history": history}
