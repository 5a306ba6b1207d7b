"""LAF202 ok twin: one int32 MIN a round; the float reduce after the loop."""
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.obs import loop_scope

WORLD = 2


def step(m, score):
    with loop_scope("label_prop.rounds"):
        for _ in range(3):
            dist.all_reduce(m, op=dist.ReduceOp.MIN)
    dist.all_reduce(score)
    return m


def build():
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = (torch.empty((256,), dtype=torch.int32, device="cuda"),
                torch.empty((256,), dtype=torch.float32, device="cuda"))
    return {"fn": step, "args": args}
