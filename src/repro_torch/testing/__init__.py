"""``repro_torch.testing`` — deterministic fault injection for the
launch surface (``repro_torch.testing.faults``) plus checkpoint/WAL
corruption helpers (port of ``repro.testing``).  Everything here is a
no-op unless a fault plan is explicitly installed (or ``REPRO_FAULTS``
is set)."""

from .faults import (
    FaultPlan,
    FaultRule,
    InjectedFault,
    active,
    clear,
    corrupt_file,
    inject,
    install,
    install_from_env,
    maybe_fail,
    truncate_file,
)

__all__ = [
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "active",
    "clear",
    "corrupt_file",
    "inject",
    "install",
    "install_from_env",
    "maybe_fail",
    "truncate_file",
]
