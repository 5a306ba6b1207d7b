"""LAF301 ok twin: decisions stay on the device; the plain-version branch
and host arrays read host memory."""
import numpy as np
import torch


def sweep_step(counts: torch.Tensor, flags: torch.Tensor):
    if counts.device.type == "cpu":
        if bool(counts.any()):       # the plain version: host memory
            counts = counts - 1
        return counts
    counts = torch.where(counts > 0, counts - 1, counts)
    host = np.zeros(4, dtype=bool)
    if host.any():                   # a numpy array
        pass
    return counts
