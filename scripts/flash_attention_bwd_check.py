#!/usr/bin/env python3
"""A short first call after a change to ``csrc/flash_attention_bwd.cu``
(B11, the gradient of attention): build it and the forward, print what
ptxas says of every instantiation, and hold the kernel to its plain
version on the card, as ``chip_smoke.py``'s phase 14 does.  Both of its
mappings run: bf16 the tensor-core launch (``attn_bwd_stats_kernel``,
``attn_bwd_tc_kernel``, ``attn_bwd_dq_kernel``), fp32 the CUDA-core FMA
kernels (``delta_kernel``, ``dkdv_kernel``, ``dq_kernel``).

    python3 scripts/flash_attention_bwd_check.py     # one CUDA card, ~1 min with the build

Cases (``chip_smoke.BWD_CASES``): every head width the backward takes
(16, 32, 64, 128, 192) and MLA's (192, 128) pair, fp32 and bf16, causal,
windowed and unmasked, Hq / Hkv of 1, 4 and 8, ragged S, a query offset
(rows with no key among them).
Each case runs the forward with the log-sum-exp written (against
``attention_ref``'s, ``LSE_TOL``), ``flash_attention_bwd`` against
``attention_bwd_ref`` on the same inputs, output and log-sum-exp
(``BWD_TOL``), and the autograd path against the same; Sq = 1 must
raise.  Then the ``flash_attention_bwd`` row at llama3-8b's prefill
shape (B 4, Hq 32, Hkv 8, S 4096, D 128, causal, bf16: back to back and
queued, a second call against the first, the plain version, SDPA's
backward, the bound and the two-term floor), the ``flash_attention_lse``
row (the forward with the log-sum-exp written and not) and the
``flash_attention_bwd_mla`` row (deepseek-v2's training shape: B 2, Hq =
Hkv = 128, S 4096, the (192, 128) pair), then the bf16 row's kernels under the profiler (the
stats, the tensor-core launch, the cast, the accumulator's zero fill).
Prints one JSON line a case and a row, and exits nonzero if any check
fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_attention_bwd_check: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch import obs
    from repro_torch.kernels import _build

    obs.enable(trace=False, metrics_on=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.build_all(["flash_attention", "flash_attention_bwd"])
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas": chip_smoke.bwd_ptxas()}), flush=True)
    ok, rows, raised = chip_smoke.check_attention_bwd()
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps({"decode_mapping_raises": raised}), flush=True)
    r_ok, rows = chip_smoke.attention_bwd_rows()
    for row in rows:
        print(json.dumps(row), flush=True)
    ok &= r_ok
    print(json.dumps({"flash_attention_bwd_split_ms": bwd_split(chip_smoke)}), flush=True)
    print(json.dumps({"ok": ok, "tolerances": {"lse": chip_smoke.LSE_TOL, "grad": chip_smoke.BWD_TOL}}), flush=True)
    return 0 if ok else 1


def bwd_split(chip_smoke):
    """One bf16 call at the row's shape under the profiler: [name, ms,
    count] for each of its kernels (the stats, the tensor-core launch, the
    cast) and the accumulator's zero fill."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    b, hq, hkv, s, d = chip_smoke.BWD_ROW
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, dout = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                     for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d)))
    lse = torch.empty((b, hq, s), dtype=torch.float32, device="cuda")
    out = ops._launch(q, k, v, True, None, d ** -0.5, 0, lse)
    ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    return chip_smoke.device_busy(lambda: ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True), top=6)[3]


if __name__ == "__main__":
    sys.exit(main())
