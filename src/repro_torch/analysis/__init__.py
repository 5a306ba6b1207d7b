"""``repro_torch.analysis`` — laf-lint for the port: trace, probe and
AST invariant checks over the port's launch surface, with a CI gate
(port of ``repro.analysis``)::

    python -m repro_torch.analysis                  # run everything
    python -m repro_torch.analysis --list-checks    # the inventory, no torch
    python -m repro_torch.analysis --only=trace-bitmap-collective
    python -m repro_torch.analysis --corpus tests/analysis_corpus_torch

Every check keeps the reference's LAF code:

* **trace** (LAF101, 103, 106, 107, 201-203): the six standard targets
  (:mod:`.targets`) run once on fake tensors under
  ``launch.trace_analysis``; a check reads the dispatch trace (the
  collectives, the writes and host reads inside ``obs.loop_scope``
  loops, the bytes and the peak live bytes);
* **probe** (LAF104, 105, 108, and LAF103 on a card): small real
  workloads (:mod:`.probe_checks`): two gloo ranks on the CPU, the
  recompile lattice and its paired counters, a restored replica;
* **ast** (LAF301-304): source lint (:mod:`.ast_lint`).

LAF102 (``jaxpr-donation-reuse``) has no counterpart: a tensor passed to
a PyTorch op stays valid.  The registry lists it with that reason.

Findings exit nonzero unless suppressed by ``analysis/baseline.toml``
or an inline ``# laf-lint: disable=<check-id>``.  This package root and
``--list-checks`` import no torch.
"""

from .registry import CHECKS, NOT_PORTED, CheckSpec, Finding, load_all_checks, run_checks
from .report import DEFAULT_BASELINE, load_baseline, render_console, save_baseline, split_suppressed, to_json

__all__ = [
    "CHECKS",
    "NOT_PORTED",
    "CheckSpec",
    "Finding",
    "load_all_checks",
    "run_checks",
    "DEFAULT_BASELINE",
    "load_baseline",
    "save_baseline",
    "split_suppressed",
    "render_console",
    "to_json",
]
