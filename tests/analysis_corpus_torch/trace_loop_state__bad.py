"""LAF107 bad twin: the round loop carries fp32 and 2-D state."""
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.obs import loop_scope

META = {"kind": "one_launch_cluster", "cap": 2048, "frontier": 256, "w_local": 16, "max_iters": 4}


def step(labels, score, hist):
    with loop_scope("label_prop.rounds"):
        for it in range(4):
            score.mul_(0.5)                       # fp32 state
            hist[it].copy_(labels[:8].float())    # a (4, 8) float history
            labels.sub_(1)
    return labels


def build():
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = (torch.empty((2048,), dtype=torch.int32, device="cuda"),
                torch.empty((2048,), dtype=torch.float32, device="cuda"),
                torch.empty((4, 8), dtype=torch.float32, device="cuda"))
    return {"fn": step, "args": args, "meta": META}
