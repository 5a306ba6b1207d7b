"""Check registry: stable ids, LAF codes, findings (port of
``repro.analysis.registry``).

A check is ``fn(ctx) -> list[Finding]`` registered under a stable id
and the reference's LAF code; the three pass modules register on import
(``load_all_checks``) and defer their torch imports to call time, which
keeps ``--list-checks`` torch-free.  ``NOT_PORTED`` lists the reference's
checks that have no counterpart in the port, with the reason.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

__all__ = ["Finding", "CheckSpec", "CHECKS", "NOT_PORTED", "register", "load_all_checks", "run_checks"]


@dataclass
class Finding:
    """One invariant violation, anchored to a file:line (AST passes) or a
    target or probe label (``<target:name>``, ``<probe:name>``)."""

    check: str
    path: str
    line: int
    message: str
    hint: str = ""
    severity: str = "error"

    def location(self) -> str:
        return f"{self.path}:{self.line}" if self.line else self.path

    def to_dict(self) -> dict:
        return {"check": self.check, "path": self.path, "line": self.line, "message": self.message,
                "hint": self.hint, "severity": self.severity}


@dataclass(frozen=True)
class CheckSpec:
    id: str
    family: str          # "trace" | "probe" | "ast"
    code: str            # the reference's LAF code
    description: str
    reference: str       # the reference's check id
    fn: Callable = field(compare=False)


CHECKS: Dict[str, CheckSpec] = {}

# reference check id -> (LAF code, why the port has no counterpart)
NOT_PORTED: Dict[str, tuple] = {
    "jaxpr-donation-reuse": (
        "LAF102",
        "no counterpart: PyTorch has no buffer donation, so a tensor passed to an op stays valid after it",
    ),
}


def register(check_id: str, *, family: str, code: str, reference: str, description: str):
    """Decorator registering a pass under its stable id."""

    def deco(fn):
        if check_id in CHECKS:
            raise ValueError(f"duplicate check id {check_id!r}")
        CHECKS[check_id] = CheckSpec(check_id, family, code, description, reference, fn)
        return fn

    return deco


_loaded = False


def load_all_checks() -> Dict[str, CheckSpec]:
    """Import the pass modules (idempotent) and return the registry."""
    global _loaded
    if not _loaded:
        from . import ast_lint, probe_checks, trace_checks  # noqa: F401

        _loaded = True
    return CHECKS


def run_checks(ctx, only: Optional[set] = None, skip: Optional[set] = None,
               families: Optional[set] = None) -> List[Finding]:
    """Run every selected check over ``ctx``; findings ordered (check,
    path, line) so reports and baselines are stable."""
    load_all_checks()
    findings: List[Finding] = []
    for spec in CHECKS.values():
        if only is not None and spec.id not in only:
            continue
        if skip is not None and spec.id in skip:
            continue
        if families is not None and spec.family not in families:
            continue
        findings.extend(spec.fn(ctx))
    findings.sort(key=lambda f: (f.check, f.path, f.line))
    return findings
