"""LAF101 ok twin: the slab is read in place."""
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

META = {"kind": "one_launch_cluster", "cap": 4096, "frontier": 1024, "w_local": 128}


def step(bitmap, rows):
    counts = bitmap.sum(dim=1, dtype=torch.int32)
    return torch.minimum(rows, counts)


def build():
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = (torch.empty((1024, 128), dtype=torch.int32, device="cuda"),
                torch.empty((1024,), dtype=torch.int32, device="cuda"))
    return {"fn": step, "args": args, "meta": META}
