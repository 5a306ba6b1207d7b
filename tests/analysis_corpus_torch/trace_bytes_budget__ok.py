"""LAF203 ok twin: counts in chunks, no fp32 hit matrix."""
import torch
from torch._subclasses.fake_tensor import FakeTensorMode


def step(q, db):
    return torch.cat([((c @ db.T) > 0.45).sum(dim=1, dtype=torch.int32) for c in q.split(128)])


def build():
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = (torch.empty((1024, 64), device="cuda"), torch.empty((4096, 64), device="cuda"))
    return {"fn": step, "args": args, "byte_budget": 100_000_000}
