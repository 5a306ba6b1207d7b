"""LAF107 ok twin: int32 label vectors, flags and the telemetry block."""
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.obs import loop_scope

META = {"kind": "one_launch_cluster", "cap": 2048, "frontier": 256, "w_local": 16, "max_iters": 4}


def step(labels, flags, tele):
    with loop_scope("label_prop.rounds"):
        for it in range(4):
            labels.sub_(1)
            flags[it + 1] = flags[it]
            tele[:, it] += 1
    return labels


def build():
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = (torch.empty((2048,), dtype=torch.int32, device="cuda"),
                torch.empty((5,), dtype=torch.int32, device="cuda"),
                torch.empty((4, 4), dtype=torch.int32, device="cuda"))
    return {"fn": step, "args": args, "meta": META}
