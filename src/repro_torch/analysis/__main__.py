"""laf-lint CLI: ``python -m repro_torch.analysis``.

Exit status: 0 when every selected check is clean (modulo the baseline)
and, with ``--corpus``, every corpus entry behaves; 1 otherwise: the CI
gate.  ``--list-checks`` imports no torch.
"""

import argparse
import sys
from pathlib import Path

from .registry import CHECKS, NOT_PORTED, load_all_checks, run_checks
from .report import DEFAULT_BASELINE, load_baseline, render_console, save_baseline, split_suppressed, to_json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description="laf-lint: trace, probe and AST checks over the port's launch surface")
    ap.add_argument("--list-checks", action="store_true", help="print the check inventory (no torch) and exit")
    ap.add_argument("--only", default="", help="comma-separated check ids to run (default: all)")
    ap.add_argument("--skip", default="", help="comma-separated check ids to skip")
    ap.add_argument("--family", default="", help="comma-separated families to run (trace,probe,ast)")
    ap.add_argument("--format", choices=("console", "json"), default="console")
    ap.add_argument("--out", default="", help="also write the report (always JSON) to this path")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="suppression baseline TOML (default: the checked-in one)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="suppress every current finding into the baseline and exit 0")
    ap.add_argument("--corpus", default="", help="also run the corpus of bad and ok twins at this directory")
    ap.add_argument("--repo-root", default="", help="repository root (default: derived from this package)")
    ap.add_argument("--no-dynamic", action="store_true", help="skip the probes' dynamic workloads")
    args = ap.parse_args(argv)

    load_all_checks()
    if args.list_checks:
        rows = [(s.code, s.id, s.family, s.description) for s in CHECKS.values()]
        rows += [(code, ref, "none", why) for ref, (code, why) in NOT_PORTED.items()]
        for code, cid, fam, desc in sorted(rows):
            print(f"{code}  {cid:34s} [{fam}] {desc}")
        return 0

    def id_set(csv):
        ids = {s.strip() for s in csv.split(",") if s.strip()}
        unknown = ids - set(CHECKS)
        if unknown:
            ap.error(f"unknown check id(s): {', '.join(sorted(unknown))} (see --list-checks)")
        return ids or None

    only, skip = id_set(args.only), id_set(args.skip)
    families = {s.strip() for s in args.family.split(",") if s.strip()} or None

    from .targets import Context

    ctx = Context.for_repo(args.repo_root or None, dynamic=not args.no_dynamic)
    findings = run_checks(ctx, only=only, skip=skip, families=families)
    if args.write_baseline:
        save_baseline(findings, args.baseline)
        print(f"baselined {len(findings)} finding(s) -> {args.baseline}")
        return 0
    open_findings, suppressed = split_suppressed(findings, load_baseline(args.baseline))
    checks_run = [s.id for s in CHECKS.values()
                  if (only is None or s.id in only) and (skip is None or s.id not in skip)
                  and (families is None or s.family in families)]
    corpus_failures = []
    if args.corpus:
        from .corpus import run_corpus

        res = run_corpus(Path(args.corpus))
        corpus_failures = res.failed
        print(f"corpus: {len(res.passed)} entries behaved, {len(res.failed)} failed")
        for entry, why in res.failed:
            print(f"  CORPUS FAIL {entry}: {why}")
    print(to_json(open_findings, suppressed, checks_run) if args.format == "json"
          else render_console(open_findings, suppressed, checks_run))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(to_json(open_findings, suppressed, checks_run))
    return 1 if open_findings or corpus_failures else 0


if __name__ == "__main__":
    sys.exit(main())
