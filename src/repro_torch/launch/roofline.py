"""Roofline over the port's dry-run records (port of
``repro.launch.roofline``).

Per (arch × shape × mesh) cell, from the record's trace analysis
(``launch.trace_analysis``, one rank's work):

    compute term    = aten FLOPs / peak of the cell's dtype
                      + each kernel operator's operations / its own peak
    memory term     = bytes accessed / HBM rate
    collective term = collective bytes / NVLink rate (one direction)

Constants: NVIDIA H100 SXM 80GB, 700 W, from its data sheet (the ones
``kernels.cost`` holds and ``PERF.md`` §6 uses): 989e12 bf16, 494.7e12
tf32 and 67e12 fp32 operations a second, 3.35e12 bytes a second of HBM3,
450e9 bytes a second a direction of NVLink.  The reference takes one
bf16 peak for every cell; here the products of an fp32 cell run at the
fp32 rate (``exact_fp32`` keeps TF32 off where a product decides a
hit), so a single bf16 peak would understate an fp32 cell's compute
term fifteen-fold (989 / 67).  The kernel operators' operations are
charged at the rate their cost function names (the Hamming filter's
distances at the int8 tensor-core rate, the RMI forward at fp32).

``model_flops`` is the reference's analytic useful work per rank (6ND
for training, 2ND for serving, 2·n·d·frontier for a cluster round);
``roofline_fraction`` = compute / max(terms), as in the reference.  The
compute term's aten peak is the record's ``meta["dtype"]``'s: bf16 for
the bf16 LM configs, fp32 for the recsys, GNN and cluster cells.
``improvement_hint`` speaks of clustering for the cluster cells and
gives the reference's hints for the model families' rows.

Biases: eager PyTorch makes every op a fusion boundary, so the memory
term is an upper bound; a loop that ends early on the card (the
fixpoint's rounds, gated by their flags) is charged every round it may
run; collective bytes are each operand's bytes, the reference's
output-size proxy.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from ..kernels.cost import BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S, NVLINK_BYTES_PER_S, TF32_FLOPS
from ..obs import configure_logging, get_logger, log_event

__all__ = ["PEAKS", "HBM_BW", "LINK_BW", "model_flops", "Row", "roofline_row", "improvement_hint", "build_table",
           "to_markdown", "main"]

PEAKS = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS, "tfloat32": TF32_FLOPS, "float32": FP32_FLOPS}
HBM_BW = HBM_BYTES_PER_S
LINK_BW = NVLINK_BYTES_PER_S

logger = get_logger("launch.roofline")


def model_flops(meta: dict, kind: str, n_devices: int) -> Optional[float]:
    """Analytic useful FLOPs per rank (the reference's formulas)."""
    if kind == "train" and "tokens_per_step" in meta:
        return 6.0 * meta["active_param_count"] * meta["tokens_per_step"] / n_devices
    if kind in ("prefill", "decode"):
        return 2.0 * meta["active_param_count"] * meta["tokens_per_step"] / n_devices
    if kind == "train" and "n_edges" in meta:
        return None  # no community-standard 6ND analogue for a GNN
    if kind == "cluster":
        n, d, f = meta["n_points"], meta["dim"], meta["frontier"]
        return 2.0 * n * d * f / n_devices  # the range-count product
    return None


@dataclass
class Row:
    arch: str
    shape: str
    mesh: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bound: str = ""
    mem_gib: float = 0.0
    coll_gib: float = 0.0
    trace_flops: float = 0.0
    model_flops: Optional[float] = None
    flops_ratio: Optional[float] = None
    roofline_fraction: float = 0.0
    note: str = ""
    kind: str = ""

    def as_dict(self):
        return self.__dict__.copy()


def roofline_row(rec: dict) -> Row:
    shape = rec["shape"] + (f" ({rec['variant']})" if rec.get("variant", "baseline") != "baseline" else "")
    if rec.get("status") == "skip":
        return Row(rec["arch"], shape, rec["mesh"], "skip", note=rec.get("reason", ""))
    if rec.get("status") != "ok":
        return Row(rec["arch"], shape, rec["mesh"], "error", note=rec.get("error", "")[:120])
    t = rec["trace_analysis"]
    meta = rec.get("meta", {})
    peak = PEAKS.get(meta.get("dtype", "float32"), FP32_FLOPS)
    ct = t["flops"] / peak + t["kernel_compute_s"]
    mt = t["bytes_accessed"] / HBM_BW
    lt = t["collectives"].get("total", {}).get("bytes", 0.0) / LINK_BW
    terms = {"compute": ct, "memory": mt, "collective": lt}
    bound = max(terms, key=terms.get)
    mf = model_flops(meta, meta.get("kind", ""), rec["n_devices"])
    work = t["flops"] + sum(t["kernel_ops"].values())
    return Row(
        rec["arch"], shape, rec["mesh"], "ok",
        compute_s=ct, memory_s=mt, collective_s=lt, bound=bound,
        mem_gib=rec["memory"]["bytes_per_rank"]["peak"] / 2**30, coll_gib=lt * LINK_BW / 2**30,
        trace_flops=work, model_flops=mf,
        flops_ratio=(mf / work) if (mf and work) else None,
        roofline_fraction=(ct / max(terms.values())) if max(terms.values()) > 0 else 0.0,
        kind=meta.get("kind", ""),
    )


def improvement_hint(row: Row) -> str:
    if not row.kind.endswith("cluster"):  # the LM, recsys and GNN rows: the reference's hints
        if row.bound == "collective":
            return ("reduce re-gather traffic: bf16 collectives, fewer remat-induced all-gathers, overlap with "
                    "compute")
        if row.bound == "memory":
            return "fuse the softmax/score chain (the flash kernel) / cut fp32 intermediates"
        return "increase arithmetic intensity (larger tiles/batch) or cut remat recompute"
    formation = "one_launch" in row.shape
    if row.bound == "collective":
        return "fewer or smaller all-reduces a round; overlap them with the next launch"
    if row.bound == "memory":
        return ("fewer rounds (pointer jumping), or one cooperative launch where the slab fits one rank"
                if formation else "read each database block once a step, not once a chunk; fuse the eager glue")
    return "raise arithmetic intensity (larger chunks) or move the products to the tensor cores"


def build_table(art_dir: Path) -> Dict[str, List[Row]]:
    out: Dict[str, List[Row]] = {}
    for mesh_dir in sorted(Path(art_dir).iterdir()):
        if not mesh_dir.is_dir():
            continue
        out[mesh_dir.name] = [roofline_row(json.loads(f.read_text())) for f in sorted(mesh_dir.glob("*.json"))]
    return out


def to_markdown(rows: List[Row], mesh: str) -> str:
    lines = [
        f"### Mesh {mesh}",
        "",
        "| arch | shape | compute s | memory s | collective s | bound | roofline frac | mem GiB/rank | "
        "coll GiB/rank | MODEL/trace ops | note |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.status in ("skip", "error"):
            lines.append(f"| {r.arch} | {r.shape} | — | — | — | {r.status.upper() if r.status == 'error' else 'skip'}"
                         f" | — | — | — | — | {r.note[:60]} |")
            continue
        ratio = f"{r.flops_ratio:.2f}" if r.flops_ratio else "n/a"
        lines.append(
            f"| {r.arch} | {r.shape} | {r.compute_s:.3g} | {r.memory_s:.3g} | {r.collective_s:.3g} | {r.bound} | "
            f"{r.roofline_fraction:.2f} | {r.mem_gib:.2f} | {r.coll_gib:.3g} | {ratio} | {improvement_hint(r)[:60]} |"
        )
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--artifacts", default="artifacts/dryrun_torch")
    ap.add_argument("--out", default="artifacts/roofline_torch")
    ap.add_argument("--quiet", action="store_true", help="write artifacts only; no table on the console")
    args = ap.parse_args(argv)
    configure_logging(quiet=args.quiet)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    tables = build_table(Path(args.artifacts))
    md, js = [], {}
    for mesh, rows in tables.items():
        md.append(to_markdown(rows, mesh))
        js[mesh] = [r.as_dict() for r in rows]
        ok = [r for r in rows if r.status == "ok"]
        if ok:
            worst = min(ok, key=lambda r: r.roofline_fraction)
            log_event(logger, "roofline_mesh", mesh=mesh, cells=len(rows),
                      worst_cell=f"{worst.arch}:{worst.shape}", worst_fraction=round(worst.roofline_fraction, 3))
    (out_dir / "roofline.md").write_text("\n\n".join(md))
    (out_dir / "roofline.json").write_text(json.dumps(js, indent=2))
    if not args.quiet:
        print("\n\n".join(md))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
