"""Structured stdlib-logging wrapper for the ``repro_torch.*`` namespace
(port of ``repro.obs.log``).

* one switch (``configure(quiet=True)``) silences every human-readable
  line without touching stdout users;
* events carry machine-readable ``key=value`` fields appended to the
  message, so a grep of a log reconstructs the numbers;
* ``rate_limited_warn`` keeps per-item warnings from flooding a log —
  at most one line per key per ``interval_s``.

Handlers are only attached to the ``repro_torch`` root logger, only
once, and propagation to the global root is disabled, so embedding
apps keep full control through standard ``logging`` configuration.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from typing import Dict

__all__ = ["get_logger", "configure", "log_event", "rate_limited_warn"]

_ROOT = "repro_torch"
_lock = threading.Lock()
_configured = False
_last_warn: Dict[str, float] = {}


def configure(
    level: int = logging.INFO, quiet: bool = False, stream=None, force: bool = False
) -> logging.Logger:
    """Attach one stderr handler to the ``repro_torch`` root logger.

    Idempotent (re-calls adjust the level only, unless ``force``);
    ``quiet=True`` is shorthand for WARNING level.
    """
    global _configured
    root = logging.getLogger(_ROOT)
    with _lock:
        if quiet:
            level = logging.WARNING
        if not _configured or force:
            if force:
                for h in list(root.handlers):
                    root.removeHandler(h)
            h = logging.StreamHandler(stream or sys.stderr)
            h.setFormatter(
                logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s",
                                  datefmt="%H:%M:%S")
            )
            root.addHandler(h)
            root.propagate = False
            _configured = True
        root.setLevel(level)
    return root


def get_logger(name: str = "") -> logging.Logger:
    """Logger under the ``repro_torch.`` namespace (``get_logger("index")``
    -> ``repro_torch.index``).  Attaches no handler."""
    if name.startswith(_ROOT):
        return logging.getLogger(name)
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def _fmt_fields(fields: dict) -> str:
    parts = []
    for k, v in fields.items():
        if isinstance(v, float):
            v = f"{v:.6g}"
        parts.append(f"{k}={v}")
    return " ".join(parts)


def log_event(logger: logging.Logger, event: str, _level: int = logging.INFO, **fields):
    """``event key=value ...`` — grep-stable structured line."""
    if logger.isEnabledFor(_level):
        msg = f"{event} {_fmt_fields(fields)}" if fields else event
        logger.log(_level, msg)


def rate_limited_warn(
    logger: logging.Logger, key: str, msg: str, *, interval_s: float = 60.0, **fields
) -> bool:
    """Warn at most once per ``key`` per ``interval_s``; returns whether
    the line was emitted (suppressed repeats are counted in the
    ``suppressed=`` field of the next emitted line)."""
    now = time.monotonic()
    with _lock:
        last = _last_warn.get(key)
        suppressed = _last_warn.get(key + "#n", 0)
        if last is not None and now - last < interval_s:
            _last_warn[key + "#n"] = suppressed + 1
            return False
        _last_warn[key] = now
        _last_warn[key + "#n"] = 0
    if suppressed:
        fields = dict(fields, suppressed=suppressed)
    log_event(logger, msg, logging.WARNING, **fields)
    return True
