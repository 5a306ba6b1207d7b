#!/usr/bin/env python3
"""The card's rate for random 128-byte row reads at bst's user-tower ids:
the practical floor under the ``embedding_bag`` kernel.

    python3 scripts/random_read_probe.py        # one CUDA card

A gather-only probe (built here with ``nvcc`` into ``build/probes/``, not
a kernel of the port) reads the rows that ``embedding_bag`` reads, with
its mapping (8 lanes a 128-byte row, 16 bytes a lane, a bag's 20 loads
issued before the first add), and writes nothing (a guarded store keeps
the loads).  It runs over bst's bulk ids (262,144 bags of 20 from a
5,000,000 x 32 fp32 table, drawn as ``chip_smoke.py``'s ``recsys`` phase
draws them) and over the distinct rows of those ids in a random order,
with the kernel's cache hints (``ld.global.nc.L1::no_allocate``, L2
evict-first) and without them (``ld.global.nc``).  Beside it, in the same
process, the port's ``embedding_bag`` and ``F.embedding_bag`` on the same
ids.  Prints one JSON line: the card's name and power limit, each time
(CUDA events, the mean of 20 calls after 3) and its rate over the bytes
read (rows read, duplicates counted, plus the ids).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <bool HINT>
__device__ __forceinline__ uint4 row_load(const uint4* p, uint64_t pol) {
  uint4 v;
  if (HINT)
    asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  else
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// a bag of L = 20 ids a group of 8 lanes; rows of 32 floats
template <bool HINT>
__global__ void __launch_bounds__(256) probe(const uint4* __restrict__ table, const int* __restrict__ ids,
                                             int B, float* out) {
  constexpr int L = 20;
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  const long long bag = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  const int c = threadIdx.x % 8;
  if (bag >= B) return;
  int id[L];
#pragma unroll
  for (int k = 0; k < L; ++k) id[k] = __ldg(ids + bag * L + k);
  uint4 v[L];
#pragma unroll
  for (int k = 0; k < L; ++k) v[k] = row_load<HINT>(table + (long long)id[k] * 8 + c, pol);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < L; ++k) s += __uint_as_float(v[k].x ^ v[k].y ^ v[k].z ^ v[k].w);
  if (s == 1234.5f) out[0] = s;  // never true for these tables: keeps the loads, writes nothing
}

extern "C" int probe_launch(const void* table, const void* ids, int B, void* out, int hint, void* stream) {
  const unsigned blocks = (unsigned)((B + 31) / 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hint)
    probe<true><<<blocks, 256, 0, s>>>(static_cast<const uint4*>(table), static_cast<const int*>(ids), B,
                                        static_cast<float*>(out));
  else
    probe<false><<<blocks, 256, 0, s>>>(static_cast<const uint4*>(table), static_cast<const int*>(ids), B,
                                         static_cast<float*>(out));
  return (int)cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "probes"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "random_read_probe.cu", out / "random_read_probe.so"
    src.write_text(SOURCE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    dll.probe_launch.restype = ctypes.c_int
    return dll


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("random_read_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import ctr_batch
    from repro_torch.kernels.embedding_bag import embedding_bag

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dll = build()
    dev = torch.device("cuda")
    cfg = get_arch("bst").make_config()
    rng = np.random.default_rng(0)  # chip_smoke.py's recsys draws: serve_p99's batch, then serve_bulk's
    ctr_batch(rng, 512, 1, np.asarray([cfg.item_vocab]), seq_len=cfg.seq_len)
    hist = ctr_batch(rng, 262144, 1, np.asarray([cfg.item_vocab]), seq_len=cfg.seq_len)["hist"]
    ids = torch.from_numpy(np.ascontiguousarray(hist, dtype=np.int32)).to(dev)
    assert ids.shape[1] == 20 and cfg.embed_dim == 32 and bool((ids >= 0).all())
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((cfg.item_vocab, cfg.embed_dim), generator=g, device=dev)
    distinct = torch.unique(ids)
    perm = distinct[torch.randperm(distinct.numel(), generator=g, device=dev)]
    d_ids = perm[: perm.numel() // 20 * 20].view(-1, 20).contiguous()
    sink = torch.zeros(1, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def probe(which, hint):
        err = dll.probe_launch(table.data_ptr(), which.data_ptr(), which.shape[0], sink.data_ptr(), hint, stream)
        if err:
            raise RuntimeError(f"probe launch failed: cudaError {err}")

    row_bytes = cfg.embed_dim * 4
    result = {"nvidia_smi": smi, "kind": torch.cuda.get_device_name(0), "bags": ids.shape[0], "L": 20,
              "table": list(table.shape), "distinct_rows": distinct.numel()}
    for name, which in (("bst_ids", ids), ("distinct_rows_shuffled", d_ids)):
        n_bytes = which.numel() * (row_bytes + 4)
        for hint in (1, 0):
            ms = time_ms(lambda: probe(which, hint))
            key = f"probe_{name}_{'hinted' if hint else 'plain_nc'}"
            result[key] = {"ms": ms, "bytes": n_bytes, "gb_per_s": n_bytes / ms / 1e6}
    result["embedding_bag_ms"] = time_ms(lambda: embedding_bag(table, ids, combiner="mean"))
    result["F_embedding_bag_ms"] = time_ms(lambda: F.embedding_bag(ids, table, mode="mean"))
    out = embedding_bag(table, ids[:4096], combiner="mean")
    want = table[ids[:4096].long()].mean(dim=1)
    result["embedding_bag_max_abs_err_vs_mean"] = float((out - want).abs().max())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
