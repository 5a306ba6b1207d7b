"""LAF301 bad twin: host reads of device values in a hot path."""
import torch


def sweep_step(counts: torch.Tensor, flags: torch.Tensor):
    if counts.any():                 # an `if` on a device reduction
        counts = counts - 1
    while bool((flags != 0).any()):  # bool() of one, in a loop
        flags = flags >> 1
    return counts.sum().item()       # .item() of one
