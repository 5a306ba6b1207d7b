#!/usr/bin/env python3
"""What the adds into dQ's accumulator cost B11's bf16 kernel: a source
of ``flash_attention_bwd.cu`` beside two copies of it built side by
side, at llama3-8b's row (B 4, Hq 32, Hkv 8, S 4096, D 128, causal,
bf16) or, with ``--pair``, at deepseek-v2's training shape
(``chip_smoke.BWD_MLA_ROW``: B 2, Hq = Hkv = 128, S 4096, MLA's (192,
128) pair, causal, bf16).

    python3 scripts/flash_attention_bwd_variants.py            # one CUDA card, ~1 min with the builds
    python3 scripts/flash_attention_bwd_variants.py --pair     # the pair, ~2 min
    python3 scripts/flash_attention_bwd_variants.py --pair --spec scripts/flash_attention_bwd_pair_variants.json

and, for another commit's kernel (here the parent's two walks at the pair)::

    mkdir -p build/parent && git archive 789f4ef src/repro_torch/csrc/flash_attention_bwd.cu | tar -x -C build/parent
    python3 scripts/flash_attention_bwd_variants.py --pair \
        --source build/parent/src/repro_torch/csrc/flash_attention_bwd.cu

* ``kernel``: the source as given (``--source``, by default the
  committed ``csrc/flash_attention_bwd.cu``);
* ``scalar_adds``: the 16-byte adds from registers (``add_dq``: B11c's
  mapping, and the pair's second walk before its redesign) made one fp32
  value at a time (``atomicAdd``); the pair's staged bulk adds, where the
  source has them, made from registers as ``add_dq``'s 16-byte adds;
* ``no_adds``: no add at all, neither from registers nor staged (a
  diagnostic: its dQ is wrong, dK and dV are not).

With ``--spec spec.json`` the copies are instead those a JSON spec names,
each the source with text replacements (``{"variants": {"kernel": [],
"no_adds": [["old text", "new text"]]}}``), at the spec's ``row`` (B, Hq,
Hkv, S, D, Dv) where it gives one.  Their checks are printed, not held (a
copy may drop work on purpose).  ``flash_attention_bwd_pair_variants.json``
holds the pair's: where its time goes (the staging, the bytes, the adds)
and the variants of the kept kernel tried and not kept.

Each copy is compiled with the build's flags into ``build/variants/``
(ptxas's registers and spills printed), held to ``attention_bwd_ref``
(``BWD_TOL``; ``no_adds`` on dK and dV only) and timed queued, in turns
(kernel, scalar, none, none, scalar, kernel).  Prints one JSON line a
copy and one with the times; exits nonzero if a build, a replacement or
(without ``--spec``) a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# add_dq's 16-byte add from registers
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
# the pair's staged dQ_part: written to shared memory and added by bulk tensor reduce-adds
STAGED = """    stage_dq<GK::NQ>(boxes, dq, &dmap, GK::NQ * w, q0 + 16 * (warp % 4), h, b, lane);"""
STAGED_AS_RED = """    {
      const int odd = lane & 1;
      float* at = p.dq_acc + ((long long)(b * p.Hq + h) * p.Sq_pad + q0 + row + 8 * odd) * DK + GK::NQ * w +
                  2 * (lane % 4) - 2 * odd;
      add_dq<DK, GK::NQ>(at, dq, q0, row, odd, p);
    }"""
STAGED_NONE = """    if (dq[0] == 12345.f) boxes[tid % 128] = 1;  // no add"""


def variants(src: str) -> dict:
    """The three copies of ``src``; raises where a marker is missing."""
    if src.count(ADDS) != 1:
        raise ValueError("the adds from registers are not where this script expects them")
    staged = src.count(STAGED)
    if staged > 1:
        raise ValueError("the staged adds are not where this script expects them")
    scalar, none = src.replace(ADDS, SCALAR), src.replace(ADDS, NONE)
    if staged:
        scalar, none = scalar.replace(STAGED, STAGED_AS_RED), none.replace(STAGED, STAGED_NONE)
    return {"kernel": src, "scalar_adds": scalar, "no_adds": none}


def spec_variants(spec: dict, src: str) -> dict:
    """The copies a ``--spec`` names: each a list of (old, new) replacements
    in ``src``; raises where a replacement's text is missing."""
    texts = {}
    for name, reps in spec["variants"].items():
        text = src
        for old, new in reps:
            if old not in text:
                raise ValueError(f"{name}: {old[:300]!r} is not in its source")
            text = text.replace(old, new)
        texts[name] = text
    return texts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", action="store_true", help="deepseek-v2's training shape at MLA's (192, 128) pair")
    ap.add_argument("--source", type=Path, default=None, help="the .cu to vary (default: the committed one)")
    ap.add_argument("--spec", type=Path, default=None, help="a JSON spec of the copies to build instead")
    args = ap.parse_args()
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
    source = args.source or _build.CSRC / "flash_attention_bwd.cu"
    spec = json.loads(args.spec.read_text()) if args.spec else None
    try:
        texts = spec_variants(spec, source.read_text()) if spec else variants(source.read_text())
    except ValueError as e:
        print(f"flash_attention_bwd_variants: {e} ({source})", file=sys.stderr)
        return 1
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in texts.items():
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

    b, hq, hkv, s, d, dv = (spec or {}).get(
        "row", chip_smoke.BWD_MLA_ROW if args.pair else (*chip_smoke.BWD_ROW, chip_smoke.BWD_ROW[4]))
    g = torch.Generator(device="cuda").manual_seed(12 if args.pair else 11)

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(torch.bfloat16)

    q, k, v, dout = draw(b, hq, s, d), draw(b, hkv, s, d), draw(b, hkv, s, dv), draw(b, hq, s, dv)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device="cuda")
    out = ops._launch(q, k, v, True, None, d ** -0.5, 0, lse)
    want = attention_bwd_ref(q, k, v, out, lse, dout, causal=True)
    sq_pad = -(-s // ops.BWD_PAD) * ops.BWD_PAD

    def call(fn):  # the wrapper's allocations, as ops.flash_attention_bwd makes them
        dq, dk, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        scratch = torch.empty((b, hq, sq_pad, 2), dtype=torch.float32, device="cuda")
        acc = torch.zeros((b, hq, sq_pad, d), dtype=torch.float32, device="cuda")
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 scratch.data_ptr(), acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv_.data_ptr(), 1,
                 b, hq, hkv, s, s, d, dv, 1, -1, 0, d ** -0.5, torch.cuda.current_stream().cuda_stream)
        _build.check(err, "flash_attention_bwd variant")
        return dq, dk, dv_

    for name, fn in fns.items():
        gaps = [chip_smoke.bwd_grad_gap(a, w, torch.bfloat16) for a, w in zip(call(fn), want)]
        held = [x[0] for x in gaps]
        ok &= spec is not None or (all(held[1:]) and (held[0] or name == "no_adds"))
        ptxas = {key: val for kernel in ("attn_bwd_tc_kernel", "attn_bwd_wide_kernel")
                 for key, val in chip_smoke.ptxas_entries(name, kernel).items()}
        print(json.dumps({"variant": name, "ptxas": ptxas,
                          "held_dq_dk_dv": held, "max_abs_err": [x[1] for x in gaps]}), flush=True)
    del want
    times = {n: [] for n in fns}
    for name in [*fns, *reversed(fns)]:
        times[name].append(chip_smoke.queued_ms(lambda: call(fns[name]), reps=3 if args.pair else 5))
    print(json.dumps({"queued_ms_in_turns": times, "source": str(source),
                      "shape": dict(zip(("B", "Hq", "Hkv", "S", "D", "Dv"), (b, hq, hkv, s, d, dv))),
                      "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
