"""LAF202 bad twin: a float all-reduce and a gather inside the rounds."""
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.obs import loop_scope

WORLD = 2


def step(m, score):
    with loop_scope("label_prop.rounds"):
        for _ in range(3):
            dist.all_reduce(m, op=dist.ReduceOp.MIN)
            dist.all_reduce(score)                       # fp32 SUM in a round
            parts = [torch.empty_like(m) for _ in range(WORLD)]
            dist.all_gather(parts, m)                    # a gather in a round
    return m


def build():
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = (torch.empty((256,), dtype=torch.int32, device="cuda"),
                torch.empty((256,), dtype=torch.float32, device="cuda"))
    return {"fn": step, "args": args}
