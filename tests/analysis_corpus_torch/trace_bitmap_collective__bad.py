"""LAF201 bad twin: packed words all-gathered across ranks."""
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

WORLD = 2


def step(words):
    parts = [torch.empty_like(words) for _ in range(WORLD)]
    dist.all_gather(parts, words)
    return torch.cat(parts, dim=1)


def build():
    with FakeTensorMode(allow_non_fake_inputs=True):
        return {"fn": step, "args": (torch.empty((256, 16), dtype=torch.int32, device="cuda"),)}
