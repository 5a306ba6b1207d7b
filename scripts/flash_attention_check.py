#!/usr/bin/env python3
"""A short first call after a change to ``csrc/flash_attention.cu``: build
it, print what ptxas says of every instantiation, and hold each mapping
against the plain version on the card.

    python3 scripts/flash_attention_check.py     # one CUDA card, ~25 s with the build

Cases: every head width the kernel takes (16, 32, 64, 128, 192) in bf16 and
fp32, the prefill (causal, non-causal, windowed, ragged S, GQA) and the
decode mapping (split over Sk, MQA at Hkv 1, a 1,024-slot ring read
unmasked), MLA's (192, 128) pair (v at 128; causal and not, ragged S,
GQA, a query offset; also through ``blockwise_attention``, and the
reduced 24 with 16, run at 32), and widths the kernel does not take,
which must raise.  bf16 is held to one bf16 step of the plain value
(2^-7 |plain| + 1e-5), fp32 to 2e-5 (1 + |plain|).  Then the time of
the kernel and of ``scaled_dot_product_attention`` at deepseek-v2's MLA
prefill (B 2, H 128, S 4096, q/k 192, causal: the kernel with v at 128,
SDPA with v padded to 192 and with v at 128) and at llama3-8b's (B 4,
Hq 32, Hkv 8, D 128).  Prints one JSON line a case and exits nonzero if
any case fails.
"""

from __future__ import annotations

import json
import math
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (B, Hq, Hkv, Sq, Sk, D, causal, window)
CASES = [
    (1, 4, 4, 300, 300, 192, True, None), (2, 4, 2, 128, 128, 192, True, None),
    (1, 4, 4, 70, 200, 192, False, None), (1, 4, 4, 513, 513, 192, True, 100),
    (2, 8, 8, 1, 1000, 192, True, None), (2, 128, 128, 1, 77, 192, True, None),
    (2, 8, 2, 1000, 1000, 128, True, None), (2, 32, 8, 1, 1088, 128, True, None),
    (2, 48, 1, 1, 288, 128, True, None), (2, 32, 16, 1, 1024, 128, False, None),
    (2, 4, 2, 70, 70, 16, True, None), (2, 4, 2, 200, 200, 32, True, None),
    # D 64: the LM examples' width (train_lm: Hq 10, Hkv 2, S 256)
    (2, 10, 2, 256, 256, 64, True, None), (1, 4, 4, 300, 300, 64, True, None),
    (1, 4, 4, 70, 200, 64, False, None), (1, 4, 2, 513, 513, 64, True, 100),
    (2, 10, 2, 1, 1000, 64, True, None), (8, 10, 2, 1, 256, 64, True, None),
]
# MLA's pair, (B, Hq, Hkv, Sq, Sk, causal, window, q_offset) at q/k 192, v 128
PAIR_CASES = [
    (1, 4, 4, 300, 300, True, None, None), (1, 4, 4, 300, 300, False, None, None),
    (2, 8, 2, 129, 129, True, None, None), (1, 4, 4, 70, 300, True, None, 100),
    (1, 4, 2, 513, 513, True, 100, None), (2, 128, 128, 512, 512, True, None, None),
    (2, 16, 16, 1, 300, True, None, None),
]


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_attention_check: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.layers import blockwise_attention

    t0 = time.perf_counter()
    _build.build_all(["flash_attention"])
    ptxas = {}
    for chunk in _build.BUILD_LOG.get("flash_attention", "").split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        ptxas[chunk.split("'", 1)[0]] = [int(regs.group(1)) if regs else None, int(spill.group(1)) if spill else None]
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas_registers_spill_bytes": ptxas}), flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def gap(out, ref):
        err = (out.float() - ref.float()).abs()
        if out.dtype == torch.bfloat16:
            ok = bool((err <= 2.0 ** -7 * ref.float().abs() + 1e-5).all())
        else:
            ok = bool((err <= 2e-5 * (1 + ref.abs())).all())
        return ok and bool(out.isfinite().all()), float(err.max())

    ok_all = True
    for dtype in (torch.bfloat16, torch.float32):
        for b, hq, hkv, sq, sk, d, causal, window in CASES:
            q = draw(b, hq, sq, d, dtype=dtype)
            k, v = draw(b, hkv, sk, d, dtype=dtype), draw(b, hkv, sk, d, dtype=dtype)
            out = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            ok, err = gap(out, attention_ref(q, k, v, causal=causal, window=window))
            ok_all &= ok
            print(json.dumps({"case": [b, hq, hkv, sq, sk, d, causal, window], "dtype": str(dtype), "ok": ok,
                              "max_abs_err": err}), flush=True)
        for b, hq, hkv, sq, sk, causal, window, q_offset in PAIR_CASES:
            q, k, v = draw(b, hq, sq, 192, dtype=dtype), draw(b, hkv, sk, 192, dtype=dtype), draw(b, hkv, sk, 128,
                                                                                                dtype=dtype)
            out = flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
            torch.cuda.synchronize()
            ok, err = gap(out, attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset))
            ok &= out.shape[-1] == 128
            ok_all &= ok
            print(json.dumps({"pair_case": [b, hq, hkv, sq, sk, causal, window, q_offset], "dtype": str(dtype),
                              "ok": ok, "max_abs_err": err}), flush=True)
        for d, dv, s in ((192, 128, 300), (24, 16, 100)):
            q, k, v = draw(2, 4, s, d, dtype=dtype), draw(2, 4, s, d, dtype=dtype), draw(2, 4, s, dv, dtype=dtype)
            out = blockwise_attention(q, k, v, causal=True)
            ok, err = gap(out, attention_ref(q, k, v, causal=True, scale=1 / math.sqrt(d)))
            ok_all &= ok
            print(json.dumps({"mla_widths": [d, dv], "dtype": str(dtype), "ok": ok, "max_abs_err": err}), flush=True)
    for d, dv in ((96, 96), (128, 64), (192, 64)):
        x, y = draw(1, 2, 8, d), draw(1, 2, 8, dv)
        try:
            flash_attention(x, x, y)
            ok_all = False
            print(json.dumps({"raises": [d, dv], "ok": False}))
        except ValueError:
            print(json.dumps({"raises": [d, dv], "ok": True}))

    def ms(fn, reps=5):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    for name, (b, hq, hkv, d, dv) in {"mla_prefill": (2, 128, 128, 192, 128),
                                      "llama_prefill": (4, 32, 8, 128, 128)}.items():
        q, k, v = draw(b, hq, 4096, d), draw(b, hkv, 4096, d), draw(b, hkv, 4096, dv)
        vp = F.pad(v, (0, d - dv))
        row = {"shape": name, "B": b, "Hq": hq, "Hkv": hkv, "S": 4096, "D": d, "Dv": dv,
               "kernel_ms": ms(lambda: flash_attention(q, k, v, causal=True)), "sdpa_ms": ms(lambda: sdpa(q, k, v))}
        if dv != d:
            row.update({"sdpa_v_padded_ms": ms(lambda: sdpa(q, k, vp)),
                        "kernel_v_padded_ms": ms(lambda: flash_attention(q, k, vp, causal=True)),
                        "kernel_ms_again": ms(lambda: flash_attention(q, k, v, causal=True))})
        print(json.dumps(row), flush=True)
        del q, k, v, vp
    print(json.dumps({"ok": ok_all}))
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
