#!/usr/bin/env python3
"""Which collectives DTensor's redistributions reach, and which of them a
gloo process group takes on the tensors of a device.

    python3 scripts/dtensor_collectives_check.py            # two gloo ranks sharing cuda:0
    python3 scripts/dtensor_collectives_check.py --device cpu

Spawns two gloo ranks (``repro_torch.testing.ranks``) that share one
device.  Each rank calls every collective of ``torch.distributed`` that
a DTensor redistribution or its backward can issue (all-reduce,
all-gather into a tensor, reduce-scatter, all-to-all, broadcast; the
c10d calls and their functional forms) on tensors of that device, and
every redistribution the sharded LM steps make (Shard to Replicate,
Partial to Replicate, Partial to Shard, Shard to Shard, Replicate to
Shard, and the backward of a Shard to Replicate), each under
``CommDebugMode`` (the collectives it issued, by kind) and held to the
value the same data gives on one rank.  Prints one JSON line a rank:
``{"op": {"ok", "error", "right", "comms"}}``.  A refused call is
recorded, not raised: the script's answer is the list of refusals.  A
case that kills the ranks (a signal) is recorded under its name and the
cases after it run in two new ranks.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _try(fn):
    from torch.distributed.tensor.debug import CommDebugMode

    comm = CommDebugMode()
    try:
        with comm:
            right = fn()
        return {"ok": True, "right": bool(right),
                "comms": {str(k).split(".")[-1]: int(v) for k, v in comm.get_comm_counts().items()}}
    except Exception as e:  # noqa: BLE001 - the refusal is the answer
        return {"ok": False, "error": f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"}


def probe_rank(rank, world, device, start, progress, staged):
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    from repro_torch.distributed.sharding import stage_gloo_collectives
    from repro_torch.obs import metrics

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if staged:
        stage_gloo_collectives(dev.type)
        metrics.enable()
    mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("model",))
    g = torch.Generator().manual_seed(0)
    full = torch.randn(4 * world, 6 * world, generator=g).to(dev)
    mine = full * (rank + 1)                      # each rank's own addend
    total = full * sum(range(1, world + 1))       # their sum
    rows = full.shape[0] // world
    out = {"rank": rank, "device": str(dev), "torch": torch.__version__, "cuda": torch.version.cuda}

    def all_reduce():
        t = mine.clone()
        dist.all_reduce(t)
        return torch.allclose(t, total)

    def all_gather_list():
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine)
        return torch.allclose(parts[0], full)

    def all_gather_into_tensor():
        o = torch.empty((world * mine.shape[0], mine.shape[1]), device=dev)
        dist.all_gather_into_tensor(o, mine)
        return torch.allclose(o[: mine.shape[0]], full)

    def reduce_scatter_tensor():
        o = torch.empty((rows, full.shape[1]), device=dev)
        dist.reduce_scatter_tensor(o, mine)
        return torch.allclose(o, total[rank * rows:(rank + 1) * rows])

    def all_to_all_single():
        o = torch.empty_like(mine)
        dist.all_to_all_single(o, mine)
        return o.shape == mine.shape

    def broadcast():
        t = mine.clone()
        dist.broadcast(t, 0)
        return torch.allclose(t, full)

    def funcol_all_gather():
        return torch.allclose(funcol.all_gather_tensor(mine, 0, mesh).wait()[: mine.shape[0]], full)

    def funcol_reduce_scatter():
        return torch.allclose(funcol.reduce_scatter_tensor(mine, "sum", 0, mesh).wait(),
                              total[rank * rows:(rank + 1) * rows])

    def funcol_all_reduce():
        return torch.allclose(funcol.all_reduce(mine, "sum", mesh).wait(), total)

    def funcol_all_to_all():
        return funcol.all_to_all_single(mine, None, None, mesh).wait().shape == mine.shape

    def local(value, placement):
        """This rank's shard of ``value`` under ``placement``."""
        return value.chunk(world, placement.dim)[rank] if isinstance(placement, Shard) else value

    def redistribute(src, dst):
        def run():
            if isinstance(src, Partial):
                d, want = DTensor.from_local(mine, mesh, [Partial()], run_check=False), total
            else:  # every rank holds the value: its shard is cut locally, no collective
                d, want = distribute_tensor(full, mesh, [src], src_data_rank=None), full
            return torch.allclose(d.redistribute(mesh, [dst]).to_local(), local(want, dst))
        return run

    def shard_to_replicate_backward():
        w = distribute_tensor(full, mesh, [Shard(0)], src_data_rank=None).requires_grad_(True)
        y = w.redistribute(mesh, [Replicate()]).to_local(grad_placements=[Partial()])
        (y * (rank + 1)).sum().backward()  # each rank's addend: the gradient is their sum
        return torch.allclose(w.grad.to_local(), torch.full_like(local(full, Shard(0)),
                                                                  float(sum(range(1, world + 1)))))

    cases = {
        "all_reduce": all_reduce, "all_gather": all_gather_list, "all_gather_into_tensor": all_gather_into_tensor,
        "reduce_scatter_tensor": reduce_scatter_tensor, "all_to_all_single": all_to_all_single,
        "broadcast": broadcast, "funcol.all_gather_tensor": funcol_all_gather,
        "funcol.reduce_scatter_tensor": funcol_reduce_scatter, "funcol.all_reduce": funcol_all_reduce,
        "funcol.all_to_all_single": funcol_all_to_all,
        "dtensor S0->R": redistribute(Shard(0), Replicate()), "dtensor S1->R": redistribute(Shard(1), Replicate()),
        "dtensor P->R": redistribute(Partial(), Replicate()), "dtensor P->S0": redistribute(Partial(), Shard(0)),
        "dtensor S0->S1": redistribute(Shard(0), Shard(1)), "dtensor R->S1": redistribute(Replicate(), Shard(1)),
        "dtensor S0->R backward": shard_to_replicate_backward,
    }
    assert tuple(cases) == CASES
    for i, (name, fn) in enumerate(list(cases.items())[start:], start):
        if staged and not name.startswith("dtensor"):
            continue
        if rank == 0:
            Path(progress).write_text(str(i))
        metrics.reset()
        res = _try(fn)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if staged:
            res["staged_calls"] = metrics.snapshot("sharded.staged").get("sharded.staged.all_gather.calls", 0)
        with open(f"{progress}.{rank}", "a") as f:  # kept if a later case kills the rank
            f.write(json.dumps({name: res}) + "\n")
        dist.barrier()
    return out


CASES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
         "broadcast", "funcol.all_gather_tensor", "funcol.reduce_scatter_tensor", "funcol.all_reduce",
         "funcol.all_to_all_single", "dtensor S0->R", "dtensor S1->R", "dtensor P->R", "dtensor P->S0",
         "dtensor S0->S1", "dtensor R->S1", "dtensor S0->R backward")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (both ranks on cuda:0) or cpu")
    ap.add_argument("--staged", action="store_true",
                    help="the DTensor cases with stage_gloo_collectives installed")
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("dtensor_collectives_check: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch.testing.ranks import run_ranks

    from repro_torch.testing.ranks import RanksFailed

    device = "cuda:0" if args.device == "cuda" else "cpu"
    rows, start = [{}, {}], 0
    with tempfile.TemporaryDirectory() as tmp:
        progress = Path(tmp) / "progress"
        while start < len(CASES):  # a case that kills the ranks is recorded, then the rest run in new ranks
            try:
                got = run_ranks(probe_rank, 2, device, start, str(progress), args.staged, backend="gloo",
                                timeout=300)
            except RanksFailed as e:
                i = int(progress.read_text())
                for r in rows:
                    r[CASES[i]] = {"ok": False, "error": f"the ranks died: {str(e).splitlines()[0][:200]}"}
                start = i + 1
                continue
            for r, g in zip(rows, got):
                r.update(g)
            break
        for r, row in enumerate(rows):
            done = Path(f"{progress}.{r}")
            for line in (done.read_text().splitlines() if done.exists() else []):
                row.update(json.loads(line))
    for row in rows:
        print(json.dumps({"staged": args.staged, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
