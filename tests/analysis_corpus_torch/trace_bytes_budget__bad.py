"""LAF203 bad twin: the products broadcast to (nq, n, d) before the sum."""
import torch
from torch._subclasses.fake_tensor import FakeTensorMode


def step(q, db):
    dots = (q[:, None, :] * db[None, :, :]).sum(dim=-1)   # (nq, n, d) fp32 first
    return (dots > 0.45).sum(dim=1, dtype=torch.int32)


def build():
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = (torch.empty((1024, 64), device="cuda"), torch.empty((4096, 64), device="cuda"))
    return {"fn": step, "args": args, "byte_budget": 100_000_000}
