"""laf-lint for the port (``repro_torch.analysis``): its registry against
the reference's LAF codes, the torch-free inventory, every corpus twin
(``tests/analysis_corpus_torch/``), the live tree, the baseline's round
trip and the dynamic probes on the CPU; the card's probes are
gpu-marked and skip inside the test without one.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import CHECKS, NOT_PORTED, load_all_checks
from repro_torch.analysis.corpus import discover, eval_entry, run_corpus

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "analysis_corpus_torch"
REFERENCE_CODES = {f"LAF10{i}" for i in range(1, 9)} | {"LAF201", "LAF202", "LAF203"} | {
    f"LAF30{i}" for i in range(1, 5)}

load_all_checks()
ENTRIES = discover(CORPUS)


def test_registry_keeps_every_reference_code():
    codes = {s.code for s in CHECKS.values()}
    assert codes | {code for code, _ in NOT_PORTED.values()} == REFERENCE_CODES
    assert not codes & {code for code, _ in NOT_PORTED.values()}
    assert NOT_PORTED["jaxpr-donation-reuse"][0] == "LAF102" and "no counterpart" in NOT_PORTED[
        "jaxpr-donation-reuse"][1]


def test_registry_names_the_reference_checks():
    pytest.importorskip("jax")
    from repro.analysis.registry import CHECKS as REF
    from repro.analysis.registry import load_all_checks as load_ref

    load_ref()
    by_code = {s.code: s.id for s in REF.values()}
    for spec in CHECKS.values():
        assert by_code[spec.code] == spec.reference, spec.id
    assert by_code["LAF102"] in NOT_PORTED


def test_list_checks_imports_no_torch():
    code = ("import sys; from repro_torch.analysis.__main__ import main; rc = main(['--list-checks']); "
            "assert rc == 0; assert 'torch' not in sys.modules, 'torch imported'")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("LAF") == len(REFERENCE_CODES)


@pytest.mark.parametrize("check_id,is_bad,path", ENTRIES, ids=[p.name for _, _, p in ENTRIES])
def test_corpus_entry(check_id, is_bad, path):
    findings = [f for f in eval_entry(check_id, path) if f.check == check_id]
    if is_bad:
        assert findings, f"{path.name}: the bad twin produced no {check_id} finding"
    else:
        assert not findings, [f.message for f in findings]


def test_corpus_covers_every_check():
    covered = {c for c, bad, _ in ENTRIES if bad}
    assert covered == set(CHECKS)
    assert {c for c, bad, _ in ENTRIES if not bad} == set(CHECKS)


@pytest.fixture(scope="module")
def ctx():
    from repro_torch.analysis.targets import Context

    return Context.for_repo(ROOT, dynamic=False, device="cpu")


@pytest.mark.parametrize("check_id", sorted(c for c, s in CHECKS.items() if s.family != "probe"))
def test_live_tree_is_clean(ctx, check_id):
    from repro_torch.analysis import load_baseline, run_checks, split_suppressed

    open_findings, _ = split_suppressed(run_checks(ctx, only={check_id}), load_baseline())
    assert not open_findings, [f"{f.location()}: {f.message}" for f in open_findings]


def test_targets_hold_their_shapes(ctx):
    one = ctx.targets.get("one_launch_cluster").analysis
    assert one.launches == {"kernel.row_popcount.launches": 1, "kernel.label_prop_rect.launches": 64,
                            "kernel.label_prop_update.launches": 64, "kernel.col_reduce.launches": 1}
    rounds = [c for c in one.collectives if c.loop == "label_prop.rounds"]
    assert len(rounds) == 64 and all((c.op, c.reduce, c.dtype) == ("all_reduce", "min", "int32") for c in rounds)
    plane = ctx.targets.get("sharded_plane").analysis
    assert {c.loop for c in plane.collectives} == {"sweep.launches"} and len(plane.collectives) == 16
    for t in ctx.targets.all():
        assert t.analysis.error is None and t.analysis.bytes_accessed * 4 < t.byte_budget, t.name


def test_lint_finds_a_bad_tree(tmp_path):
    """A copy of the port with a host read in a hot wrapper fails LAF301."""
    import shutil

    from repro_torch.analysis import run_checks
    from repro_torch.analysis.targets import Context

    src = tmp_path / "src" / "repro_torch"
    shutil.copytree(ROOT / "src" / "repro_torch", src, ignore=shutil.ignore_patterns("__pycache__"))
    ops = src / "kernels" / "popcount" / "ops.py"
    ops.write_text(ops.read_text().replace("    return _row_popcount_op(words, lo, hi)",
                                           "    if bool(words.any()):\n        pass\n"
                                           "    return _row_popcount_op(words, lo, hi)"))
    found = run_checks(Context.for_repo(tmp_path, dynamic=False, device="cpu"), only={"ast-traced-branch"})
    assert [f.path for f in found] == ["src/repro_torch/kernels/popcount/ops.py"]


def test_baseline_round_trip(tmp_path):
    from repro_torch.analysis import Finding, load_baseline, save_baseline, split_suppressed

    findings = [Finding("trace-live-slab", "<target:one_launch_cluster>", 0, "peak too high"),
                Finding("ast-traced-branch", "src/repro_torch/index/sweep.py", 12, "if on a reduction"),
                Finding("ast-traced-branch", "src/repro_torch/index/sweep.py", 40, "another")]
    path = tmp_path / "baseline.toml"
    save_baseline(findings, path)
    rules = load_baseline(path)
    assert len(rules) == 2
    open_, suppressed = split_suppressed(findings, rules)
    assert not open_ and len(suppressed) == 3
    fresh = Finding("ast-wallclock-sync", "src/repro_torch/stream/serve.py", 3, "x")
    assert split_suppressed([fresh], rules) == ([fresh], [])
    assert load_baseline() == []  # the checked-in baseline suppresses nothing


def test_whole_corpus_passes():
    res = run_corpus(CORPUS)
    assert res.ok, res.failed


@pytest.mark.parametrize("check_id", ["probe-plane-replication", "probe-recompile-lattice", "probe-restore-replica"])
def test_dynamic_probes_pass_on_the_cpu(check_id):
    from repro_torch.analysis import run_checks
    from repro_torch.analysis.targets import Context

    found = run_checks(Context.for_repo(ROOT, dynamic=True, device="cpu"), only={check_id})
    assert not found, [f.message for f in found]


@pytest.mark.gpu
@pytest.mark.parametrize("check_id", ["trace-host-read-in-loop", "probe-recompile-lattice", "probe-restore-replica"])
def test_gpu_probes_pass_on_the_card(check_id):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.analysis import run_checks
    from repro_torch.analysis.targets import Context

    found = run_checks(Context.for_repo(ROOT, dynamic=True, device="cuda"), only={check_id})
    assert not found, [f.message for f in found]
