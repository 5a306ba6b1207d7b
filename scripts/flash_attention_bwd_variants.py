#!/usr/bin/env python3
"""What the adds into dQ's accumulator cost B11's bf16 kernel: the
committed ``csrc/flash_attention_bwd.cu`` beside two copies of it built
side by side, at llama3-8b's row (B 4, Hq 32, Hkv 8, S 4096, D 128,
causal, bf16).

    python3 scripts/flash_attention_bwd_variants.py     # one CUDA card, ~1 min with the builds

* ``kernel``: the source as committed (16-byte adds, a lane pair's four
  columns after one shuffle);
* ``scalar_adds``: the same dQ_part added one fp32 value at a time
  (``atomicAdd``);
* ``no_adds``: no add at all (a diagnostic: its dQ is wrong, dK and dV
  are not).

Each copy is compiled with the build's flags into ``build/variants/``
(ptxas's registers and spills printed), held to ``attention_bwd_ref``
(``BWD_TOL``; ``no_adds`` on dK and dV only) and timed queued, in turns
(kernel, scalar, none, none, scalar, kernel).  Prints one JSON line a
copy and one with the times; exits nonzero if a build or a check fails.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ADDS = """    if (q0 + r < p.Sq) red_add4(acc + 8 * j, odd ? r0 : a0, odd ? r1 : a1, odd ? b0 : r0, odd ? b1 : r1);"""
SCALAR = """    if (q0 + row < p.Sq) {
      float* at = acc + 8 * j + 2 * odd - 8 * odd * D;  // row row, this lane's own two columns
      atomicAdd(at, a0);
      atomicAdd(at + 1, a1);
    }
    if (q0 + row + 8 < p.Sq) {
      float* at = acc + 8 * j + 2 * odd + 8 * (1 - odd) * D;  // row row + 8
      atomicAdd(at, b0);
      atomicAdd(at + 1, b1);
    }"""
NONE = """    if (a0 == 12345.f) acc[8 * j] = r0 + r1 + b1;  // no add"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_attention_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    if src.count(ADDS) != 1:
        print("flash_attention_bwd_variants: the adds are not where this script expects them", file=sys.stderr)
        return 1
    variants = {"kernel": src, "scalar_adds": src.replace(ADDS, SCALAR), "no_adds": src.replace(ADDS, NONE)}
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in variants.items():
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ok, fns = True, {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        _build.BUILD_LOG[name] = log
        if job.returncode != 0:
            print(json.dumps({"variant": name, "build": "failed", "log": log[-2000:]}), flush=True)
            ok = False
            continue
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).flash_attention_bwd_launch
        fn.argtypes = _build._SIGNATURES["flash_attention_bwd"]["flash_attention_bwd_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn

    b, hq, hkv, s, d = chip_smoke.BWD_ROW
    g = torch.Generator(device="cuda").manual_seed(11)

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(torch.bfloat16)

    q, k, v, dout = draw(b, hq, s, d), draw(b, hkv, s, d), draw(b, hkv, s, d), draw(b, hq, s, d)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device="cuda")
    out = ops._launch(q, k, v, True, None, d ** -0.5, 0, lse)
    want = attention_bwd_ref(q, k, v, out, lse, dout, causal=True)
    sq_pad = -(-s // ops.BWD_PAD) * ops.BWD_PAD

    def call(fn):  # the wrapper's allocations, as ops.flash_attention_bwd makes them
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        scratch = torch.empty((b, hq, sq_pad, 2), dtype=torch.float32, device="cuda")
        acc = torch.zeros((b, hq, sq_pad, d), dtype=torch.float32, device="cuda")
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 scratch.data_ptr(), acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1,
                 b, hq, hkv, s, s, d, d, 1, -1, 0, d ** -0.5, torch.cuda.current_stream().cuda_stream)
        _build.check(err, "flash_attention_bwd variant")
        return dq, dk, dv

    for name, fn in fns.items():
        gaps = [chip_smoke.bwd_grad_gap(a, w, torch.bfloat16) for a, w in zip(call(fn), want)]
        held = [x[0] for x in gaps]
        ok &= all(held[1:]) and (held[0] or name == "no_adds")
        print(json.dumps({"variant": name, "ptxas": chip_smoke.ptxas_entries(name, "attn_bwd_tc_kernel"),
                          "held_dq_dk_dv": held, "max_abs_err": [x[1] for x in gaps]}), flush=True)
    del want
    times = {n: [] for n in fns}
    for name in [*fns, *reversed(fns)]:
        times[name].append(chip_smoke.queued_ms(lambda: call(fns[name]), reps=5))
    print(json.dumps({"queued_ms_in_turns": times, "shape": dict(zip(("B", "Hq", "Hkv", "S", "D"), chip_smoke.BWD_ROW)),
                      "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
