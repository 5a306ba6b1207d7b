"""LAF103 ok twin: the rounds are gated on the device."""
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.obs import loop_scope


def step(labels):
    with loop_scope("label_prop.rounds"):
        for _ in range(4):
            nxt = torch.minimum(labels, labels.roll(1))
            labels = torch.where(nxt != labels, nxt, labels)
    return labels


def build():
    with FakeTensorMode(allow_non_fake_inputs=True):
        return {"fn": step, "args": (torch.empty((256,), dtype=torch.int32, device="cuda"),)}
