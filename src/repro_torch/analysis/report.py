"""Finding rendering and the checked-in suppression baseline (port of
``repro.analysis.report``).

The baseline (``analysis/baseline.toml``) is a list of ``[[suppress]]``
tables; a finding is suppressed when a rule's ``check`` matches exactly
and its optional ``path`` / ``contains`` substrings match the finding's
path / message.  The file is read with a minimal TOML-subset parser
(``[[suppress]]`` + ``key = "string" | int`` + ``#`` comments) because
it stays dependency-free; the writer emits the same subset, so
``--write-baseline`` round-trips.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

from .registry import CHECKS, Finding

__all__ = [
    "load_baseline",
    "save_baseline",
    "split_suppressed",
    "render_console",
    "to_json",
]

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.toml"


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
        return raw[1:-1]
    try:
        return int(raw)
    except ValueError:
        return raw


def load_baseline(path=DEFAULT_BASELINE) -> List[Dict]:
    """Parse ``[[suppress]]`` rules; a missing file is an empty baseline."""
    path = Path(path)
    if not path.exists():
        return []
    rules: List[Dict] = []
    current = None
    for ln, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line == "[[suppress]]":
            current = {}
            rules.append(current)
            continue
        if line.startswith("["):
            current = None  # unknown table: ignore its keys
            continue
        if "=" in line and current is not None:
            key, val = line.split("=", 1)
            current[key.strip()] = _parse_value(val)
        elif "=" in line:
            continue
        else:
            raise ValueError(f"{path}:{ln}: unparseable baseline line {raw!r}")
    bad = [r for r in rules if "check" not in r]
    if bad:
        raise ValueError(f"{path}: every [[suppress]] rule needs a check = \"...\"")
    return rules


def save_baseline(findings: List[Finding], path=DEFAULT_BASELINE) -> None:
    """Write one ``[[suppress]]`` rule per (check, path) pair — coarse on
    purpose so rules survive line drift."""
    seen = set()
    lines = [
        "# repro_torch.analysis suppression baseline — each [[suppress]] rule",
        "# hides findings whose check matches exactly and whose path/",
        "# message contain the optional path=/contains= substrings.",
        "# Regenerate with: python -m repro_torch.analysis --write-baseline",
        "",
    ]
    for f in sorted(findings, key=lambda f: (f.check, f.path)):
        key = (f.check, f.path)
        if key in seen:
            continue
        seen.add(key)
        lines += [
            "[[suppress]]",
            f'check = "{f.check}"',
            f'path = "{f.path}"',
            f'reason = "baselined {f.message[:60]}"',
            "",
        ]
    Path(path).write_text("\n".join(lines))


def split_suppressed(
    findings: List[Finding], rules: List[Dict]
) -> Tuple[List[Finding], List[Finding]]:
    """(open, suppressed) partition of ``findings`` under the baseline."""
    open_, suppressed = [], []
    for f in findings:
        hit = any(
            r.get("check") == f.check
            and str(r.get("path", "")) in f.path
            and str(r.get("contains", "")) in f.message
            for r in rules
        )
        (suppressed if hit else open_).append(f)
    return open_, suppressed


def render_console(
    open_findings: List[Finding],
    suppressed: List[Finding],
    checks_run: List[str],
) -> str:
    out = []
    for f in open_findings:
        spec = CHECKS.get(f.check)
        code = f" [{spec.code}]" if spec else ""
        out.append(f"{f.location()}: {f.check}{code}: {f.message}")
        if f.hint:
            out.append(f"    hint: {f.hint}")
    out.append(
        f"laf-lint: {len(checks_run)} checks, "
        f"{len(open_findings)} finding(s), {len(suppressed)} suppressed"
    )
    return "\n".join(out)


def to_json(
    open_findings: List[Finding],
    suppressed: List[Finding],
    checks_run: List[str],
) -> str:
    return json.dumps(
        {
            "version": 1,
            "ok": not open_findings,
            "checks": checks_run,
            "findings": [f.to_dict() for f in open_findings],
            "suppressed": [f.to_dict() for f in suppressed],
        },
        indent=2,
    )
