"""Fault tolerance: retry/heartbeat step guard and straggler detection
(port of ``repro.train.fault_tolerance``, host-only).

* ``GuardedStep`` — wraps a step fn: heartbeat timestamps, bounded
  retries on transient failure (``RuntimeError`` / ``OSError``, which a
  refused CUDA launch raises), checkpoint-restore escalation after
  ``max_retries``.
* ``StragglerPolicy`` — per-step deadline from a running latency EWMA;
  slow steps are logged, and after ``k`` consecutive violations the
  policy recommends ejecting the slow host.

* ``plan_elastic_remesh`` — given a device loss, picks the largest
  (data, model) mesh that fits the survivors and returns the checkpoint
  resharding plan (a pure function of the survivor count).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["GuardedStep", "StragglerPolicy", "plan_elastic_remesh", "StepResult"]


@dataclass
class StepResult:
    value: Any
    attempts: int
    elapsed_s: float
    recovered: bool


class GuardedStep:
    """Retry wrapper with heartbeat + restore escalation."""

    def __init__(
        self,
        step_fn: Callable,
        *,
        max_retries: int = 2,
        on_restore: Optional[Callable[[], Any]] = None,
        retryable: Tuple[type, ...] = (RuntimeError, OSError),
        backoff_s: float = 0.0,
        backoff_mult: float = 2.0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.step_fn = step_fn
        self.max_retries = max_retries
        self.on_restore = on_restore
        self.retryable = retryable
        self.backoff_s = backoff_s
        self.backoff_mult = backoff_mult
        self._sleep = sleep
        self.last_heartbeat = time.time()
        self.failures: List[str] = []

    def __call__(self, *args, **kwargs) -> StepResult:
        t0 = time.time()
        attempts = 0
        recovered = False
        delay = self.backoff_s
        while True:
            attempts += 1
            self.last_heartbeat = time.time()
            try:
                out = self.step_fn(*args, **kwargs)
                return StepResult(out, attempts, time.time() - t0, recovered)
            except self.retryable as e:
                self.failures.append(f"{type(e).__name__}: {e}")
                if attempts > self.max_retries:
                    if self.on_restore is not None:
                        self.on_restore()
                        recovered = True
                        attempts = 0
                        delay = self.backoff_s
                        continue
                    raise
                if delay > 0:
                    self._sleep(delay)
                    delay *= self.backoff_mult


@dataclass
class StragglerPolicy:
    """EWMA-deadline straggler detection."""

    tolerance: float = 2.0        # deadline = tolerance * ewma
    ewma_alpha: float = 0.2
    eject_after: int = 3          # consecutive violations
    ewma_s: Optional[float] = None
    consecutive_slow: int = 0
    slow_steps: List[int] = field(default_factory=list)
    step_idx: int = 0

    def observe(self, elapsed_s: float) -> dict:
        self.step_idx += 1
        first = self.ewma_s is None
        if first:
            self.ewma_s = elapsed_s
        deadline = self.tolerance * self.ewma_s
        slow = (not first) and elapsed_s > deadline
        if slow:
            self.consecutive_slow += 1
            self.slow_steps.append(self.step_idx)
        else:
            self.consecutive_slow = 0
            self.ewma_s = (1 - self.ewma_alpha) * self.ewma_s + self.ewma_alpha * elapsed_s
        return {
            "slow": slow,
            "deadline_s": deadline,
            "recommend_eject": self.consecutive_slow >= self.eject_after,
            "ewma_s": self.ewma_s,
        }


def plan_elastic_remesh(
    n_devices_alive: int,
    *,
    prefer_model: int = 16,
    min_model: int = 4,
) -> Tuple[Tuple[int, int], dict]:
    """Largest (data, model) mesh fitting the survivors.

    Keeps the model axis at ``prefer_model`` when possible (TP degree is
    architecture-matched), shrinking data parallelism first; only if even
    one data replica does not fit does the model axis shrink.
    Returns ((data, model), plan) where plan documents the restore path.
    """
    model = prefer_model
    while model >= min_model:
        data = n_devices_alive // model
        if data >= 1:
            used = data * model
            plan = {
                "devices_used": used,
                "devices_idle": n_devices_alive - used,
                "action": "restore latest checkpoint with new mesh shardings "
                          "(restore_checkpoint(..., shardings=new)); global "
                          "batch preserved via gradient accumulation "
                          f"x{max(1, 16 // max(data, 1))}",
            }
            return (data, model), plan
        model //= 2
    raise ValueError(f"cannot build a mesh from {n_devices_alive} devices")
