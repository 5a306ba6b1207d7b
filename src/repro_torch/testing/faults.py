"""Seeded fault injection for the launch surface (port of
``repro.testing.faults``, host-only).

Every device-dispatch site in the sweep engine / one-launch cluster
calls :func:`maybe_fail` with a stable **site name**
before launching.  With no plan installed (the production default) that
is one ``None`` check; with a plan installed it draws from a per-site
seeded RNG and raises :class:`InjectedFault` — an ``RuntimeError``
subclass, so it reaches the caller exactly as a real launch failure
(a refused launch raises ``RuntimeError``) would.

Sites (stable names — tests and ``REPRO_FAULTS`` plans reference them):

* ``sweep.launch``   — the device sweep (hits, counts, subset)
* ``plane.launch``   — the same sweeps of a backend sharded over a mesh
  (``RandomProjectionBackend(mesh=)``; ops ``hits``, ``counts``,
  ``subset``).  Each rank installs the same seeded plan and makes the
  same calls, so every rank raises at the same call, before any
  collective of that call: no rank is left waiting in one
* ``cluster.launch`` — the one-launch device-resident clustering

(the reference's ``chunk.launch`` belongs to its per-chunk dispatch,
which the port does not have; ``dryrun.cell`` to its dry-run, ROADMAP
A12)

Plans are **seeded and deterministic**: site ``s``'s k-th eligible call
fails iff the k-th draw of ``default_rng([seed, crc32(s)])`` falls
under the site's probability (and the rule's ``max_count`` is not
exhausted), independent of every other site — so a failing CI run
replays bit-identically from its ``REPRO_FAULTS`` string.

``REPRO_FAULTS`` grammar (comma-separated)::

    REPRO_FAULTS="seed=7,sweep.launch=0.5,cluster.launch=1.0:2"

``site=prob`` injects with probability ``prob``; an optional ``:N``
caps total injections at that site (``prob=1.0`` with no cap simulates
a dead device).  In this package a fired site raises to the caller: no
path retries it or falls back to the host.  The plan installs at import
of this module (streaming/index modules import it), so a plain
``REPRO_FAULTS=... pytest`` run shows which paths a device fault stops.

Checkpoint-shard corruption is *file* tampering, not call-site
injection — :func:`corrupt_file` / :func:`truncate_file` are the seeded
helpers the durability tests (and any chaos harness) use.
"""

from __future__ import annotations

import contextlib
import os
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np

__all__ = [
    "InjectedFault",
    "FaultRule",
    "FaultPlan",
    "install",
    "install_from_env",
    "clear",
    "active",
    "inject",
    "maybe_fail",
    "corrupt_file",
    "truncate_file",
]


class InjectedFault(RuntimeError):
    """A deterministic, injected launch failure (retryable)."""


@dataclass
class FaultRule:
    """Injection rule for one site: fire with ``prob`` per eligible
    call, at most ``max_count`` times total (None = unbounded)."""

    prob: float = 1.0
    max_count: Optional[int] = None


class FaultPlan:
    """A seeded set of per-site fault rules.

    Determinism contract: each site draws from its own
    ``default_rng([seed, crc32(site)])`` stream advanced once per
    eligible call, so whether call k at site s fails depends only on
    (seed, s, k) — never on interleaving with other sites.
    """

    def __init__(self, seed: int = 0, rules: Optional[Dict[str, FaultRule]] = None):
        self.seed = int(seed)
        self.rules: Dict[str, FaultRule] = dict(rules or {})
        self._rngs: Dict[str, np.random.Generator] = {}
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse a ``REPRO_FAULTS``-style plan string (see module doc)."""
        seed = 0
        rules: Dict[str, FaultRule] = {}
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            key, val = key.strip(), val.strip()
            if not val:
                raise ValueError(f"fault plan entry {part!r} is not site=prob[:max]")
            if key == "seed":
                seed = int(val)
                continue
            prob_s, _, max_s = val.partition(":")
            rules[key] = FaultRule(
                prob=float(prob_s), max_count=int(max_s) if max_s else None
            )
        return cls(seed, rules)

    def should_fail(self, site: str) -> bool:
        rule = self.rules.get(site)
        if rule is None:
            return False
        self.calls[site] = self.calls.get(site, 0) + 1
        if rule.max_count is not None and self.fired.get(site, 0) >= rule.max_count:
            return False
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = np.random.default_rng(
                [self.seed, zlib.crc32(site.encode())]
            )
        # always advance the stream (determinism is per eligible call)
        hit = bool(rng.random() < rule.prob)
        if hit:
            self.fired[site] = self.fired.get(site, 0) + 1
        return hit

    def summary(self) -> dict:
        """JSON-able description (dry-run records, bench payloads)."""
        return {
            "seed": self.seed,
            "rules": {
                s: {"prob": r.prob, "max_count": r.max_count}
                for s, r in sorted(self.rules.items())
            },
            "fired": dict(sorted(self.fired.items())),
            "calls": dict(sorted(self.calls.items())),
        }


_active: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-wide active plan."""
    global _active
    _active = plan
    return plan


def clear() -> None:
    global _active
    _active = None


def active() -> Optional[FaultPlan]:
    return _active


@contextlib.contextmanager
def inject(plan_or_spec):
    """Scoped install: ``with faults.inject("seed=3,sweep.launch=1:1"):``."""
    plan = (
        plan_or_spec
        if isinstance(plan_or_spec, FaultPlan)
        else FaultPlan.parse(plan_or_spec)
    )
    global _active
    prev = _active
    install(plan)
    try:
        yield plan
    finally:
        _active = prev


def maybe_fail(site: str, **ctx) -> None:
    """Raise :class:`InjectedFault` iff the active plan says so.

    The hot-path cost with no plan installed is a single global read;
    instrumented sites can therefore call this unconditionally.
    """
    plan = _active
    if plan is None:
        return
    if plan.should_fail(site):
        from ..obs import metrics as _metrics

        _metrics.counter("faults.injected").inc()
        _metrics.counter(f"faults.injected.{site}").inc()
        extra = f" ({ctx})" if ctx else ""
        raise InjectedFault(f"injected fault at {site}{extra}")


def install_from_env(environ=None) -> bool:
    """Apply the ``REPRO_FAULTS`` knob; returns whether a plan installed."""
    spec = (environ if environ is not None else os.environ).get("REPRO_FAULTS", "")
    spec = spec.strip()
    if not spec or spec in ("0", "off", "none"):
        return False
    install(FaultPlan.parse(spec))
    return True


# -- file tampering (checkpoint shards, WAL tails) --------------------------


def corrupt_file(path, *, seed: int = 0, nbytes: int = 8) -> int:
    """Flip ``nbytes`` seeded-random bytes of ``path`` in place; returns
    how many were flipped (0 on an empty file)."""
    p = Path(path)
    raw = bytearray(p.read_bytes())
    if not raw:
        return 0
    rng = np.random.default_rng([seed, zlib.crc32(p.name.encode())])
    idx = rng.integers(0, len(raw), size=min(nbytes, len(raw)))
    for i in idx:
        raw[int(i)] ^= 0xFF
    p.write_bytes(bytes(raw))
    return len(idx)


def truncate_file(path, *, drop_bytes: Optional[int] = None, keep_frac: float = 0.5) -> int:
    """Cut the tail off ``path`` (the un-fsynced-tail simulation);
    returns the new size.  ``drop_bytes`` wins over ``keep_frac``."""
    p = Path(path)
    size = p.stat().st_size
    keep = size - int(drop_bytes) if drop_bytes is not None else int(size * keep_frac)
    keep = max(keep, 0)
    with open(p, "r+b") as f:
        f.truncate(keep)
    return keep


# a plain `REPRO_FAULTS=... pytest` run injects with zero test changes:
# the plan installs when the first instrumented module imports this one
install_from_env()
