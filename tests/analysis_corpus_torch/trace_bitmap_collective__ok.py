"""LAF201 ok twin: the words are counted on their rank; the counts cross."""
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

WORLD = 2


def step(words):
    counts = words.sum(dim=1, dtype=torch.int32)
    dist.all_reduce(counts)
    return counts


def build():
    with FakeTensorMode(allow_non_fake_inputs=True):
        return {"fn": step, "args": (torch.empty((256, 16), dtype=torch.int32, device="cuda"),)}
