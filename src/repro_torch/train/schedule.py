"""Learning-rate schedules (port of ``repro.train.schedule``): pure
functions of the integer step (a 0-d tensor or an int) returning a 0-d
fp32 tensor on the step's device, in the reference's fp32 arithmetic."""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine", "warmup_linear"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.0):
    def fn(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        lin = peak_lr * (1 - (1 - final_frac) * progress)
        return torch.where(step < warmup_steps, warm, lin)

    return fn
