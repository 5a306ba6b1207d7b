"""LAF106 ok twin: the slab is only read in the loop."""
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.obs import loop_scope

META = {"kind": "one_launch_cluster", "cap": 2048, "frontier": 256, "w_local": 16, "max_iters": 4}


def step(bitmap, labels):
    with loop_scope("label_prop.rounds"):
        for _ in range(4):
            labels = torch.minimum(labels, bitmap.sum(dim=1, dtype=torch.int32))
    return labels


def build():
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = (torch.empty((256, 16), dtype=torch.int32, device="cuda"),
                torch.empty((256,), dtype=torch.int32, device="cuda"))
    return {"fn": step, "args": args, "meta": META}
