"""Corpus runner: one bad and one ok twin per check (port of
``repro.analysis.corpus``).

The corpus (``tests/analysis_corpus_torch/``) is the detection proof
every check is held to: a bad entry must produce at least one finding
of its check, its ok twin none.  Entries are named ``<check id, dashes
as underscores>__bad`` / ``...__ok``, with the shape the check's
evaluator expects:

* ``ast-traced-branch``, ``ast-wallclock-sync``, ``ast-raw-kernel-launch``:
  a ``.py`` file, linted (never imported);
* ``ast-kernel-tile-contract``: a directory holding
  ``kernels/<name>/ops.py`` and ``csrc/<name>.cu``, walked like the
  package;
* the trace checks (``trace-*``): a ``.py`` module, **imported and
  executed**: ``build()`` returns ``{"fn": ..., "args": (...)}`` with the
  args fake tensors, plus ``"meta"`` (the cell meta the check reads)
  and ``"byte_budget"`` where the check needs them; a module-level
  ``WORLD = n`` runs it on a fake process group of n ranks;
* ``probe-plane-replication``: ``build()`` returns ``{"per_rank": [...],
  "replicated": [...]}``, the ranks' outputs and the names declared
  replicated;
* ``probe-recompile-lattice``: ``signatures(n)`` (the launch signature at
  input size n), ``bound(n_max)`` and optionally ``N_MAX``;
* ``probe-restore-replica``: ``build()`` returns ``{"pre_signatures":
  [...], "post_signatures": [...]}``.
"""

from __future__ import annotations

import contextlib
import importlib.util
from pathlib import Path
from typing import List, Optional, Tuple

from . import ast_lint
from .registry import CHECKS, Finding, load_all_checks

__all__ = ["CorpusResult", "discover", "run_corpus", "eval_entry"]


class CorpusResult:
    def __init__(self):
        self.passed: List[str] = []
        self.failed: List[Tuple[str, str]] = []

    @property
    def ok(self) -> bool:
        return not self.failed

    def record(self, entry: str, why: Optional[str]) -> None:
        if why is None:
            self.passed.append(entry)
        else:
            self.failed.append((entry, why))


def discover(corpus_dir: Path) -> List[Tuple[str, bool, Path]]:
    """(check id, is bad, path) per entry, sorted."""
    out = []
    for p in sorted(Path(corpus_dir).iterdir()):
        stem = p.stem if p.is_file() else p.name
        if "__" not in stem or p.name == "__pycache__":
            continue
        check_us, _, kind = stem.rpartition("__")
        check_id = check_us.replace("_", "-")
        if kind in ("bad", "ok") and check_id in CHECKS:
            out.append((check_id, kind == "bad", p))
    return out


def _load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"analysis_corpus_torch_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_AST_FILE = {
    "ast-traced-branch": ast_lint.check_file_traced_branch,
    "ast-wallclock-sync": ast_lint.check_file_wallclock_sync,
    "ast-raw-kernel-launch": ast_lint.check_file_raw_kernel_launch,
}


def _trace_findings(check_id: str, mod, label: str) -> List[Finding]:
    from ..launch.dryrun import fake_group
    from ..launch.trace_analysis import analyze_trace
    from . import trace_checks as tc

    world = getattr(mod, "WORLD", None)
    with (fake_group(world) if world else contextlib.nullcontext()):
        built = mod.build()
        tr = analyze_trace(built["fn"], *built["args"])
    meta = built.get("meta", {})
    return {
        "trace-live-slab": lambda: tc.check_live_slab(tr, meta, label),
        "trace-host-read-in-loop": lambda: tc.check_host_reads(tr, label),
        "trace-packed-loop-write": lambda: tc.check_packed_loop_write(tr, meta, label),
        "trace-loop-state": lambda: tc.check_loop_state(tr, meta, label),
        "trace-bitmap-collective": lambda: tc.check_bitmap_collective(tr, label),
        "trace-loop-collective-allowlist": lambda: tc.check_loop_allowlist(tr, label),
        "trace-bytes-budget": lambda: tc.check_bytes_budget(tr, built.get("byte_budget"), label),
    }[check_id]()


def eval_entry(check_id: str, path: Path) -> List[Finding]:
    """The findings of one corpus entry under its own check."""
    from . import probe_checks

    label = f"<corpus:{path.name}>"
    if check_id in _AST_FILE:
        tree, lines = ast_lint.parse_file(path)
        if tree is None:
            return [Finding(check_id, str(path), 0, "corpus entry failed to parse")]
        return ast_lint.filter_inline_suppressed(_AST_FILE[check_id](path, tree, str(path)), lines)
    if check_id == "ast-kernel-tile-contract":
        return ast_lint.check_tree_kernel_tile_contract(path, path)
    mod = _load_module(path)
    if check_id.startswith("trace-"):
        return _trace_findings(check_id, mod, label)
    if check_id == "probe-plane-replication":
        built = mod.build()
        return probe_checks.check_replicated(built["per_rank"], built["replicated"], label)
    if check_id == "probe-recompile-lattice":
        n_max = getattr(mod, "N_MAX", 4096)
        sigs = {mod.signatures(n) for n in range(1, n_max + 1)}
        if len(sigs) > mod.bound(n_max):
            return [Finding(check_id, label, 0, f"{len(sigs)} distinct launch signatures over n in [1, {n_max}] "
                                                f"(bound {mod.bound(n_max)})")]
        return []
    if check_id == "probe-restore-replica":
        built = mod.build()
        return probe_checks.check_restore_signatures(built["pre_signatures"], built["post_signatures"], label)
    raise ValueError(f"no corpus evaluator for {check_id!r}")


def run_corpus(corpus_dir: Path) -> CorpusResult:
    """Run every entry; a bad entry must yield >= 1 finding of its check,
    an ok twin none; every registered check needs a bad entry."""
    load_all_checks()
    result = CorpusResult()
    covered = set()
    for check_id, is_bad, path in discover(Path(corpus_dir)):
        try:
            findings = [f for f in eval_entry(check_id, path) if f.check == check_id]
        except Exception as exc:  # noqa: BLE001 - an evaluator crash is a corpus failure
            result.record(path.name, f"evaluator raised {type(exc).__name__}: {exc}")
            continue
        if is_bad:
            covered.add(check_id)
            result.record(path.name, None if findings else "bad entry produced no finding")
        else:
            result.record(path.name, None if not findings else "ok twin produced finding(s): "
                          + "; ".join(f.message[:80] for f in findings[:3]))
    missing = sorted(set(CHECKS) - covered)
    if missing:
        result.record("<coverage>", f"checks with no bad corpus entry: {', '.join(missing)}")
    return result
