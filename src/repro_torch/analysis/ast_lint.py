"""AST passes (stdlib ``ast``): the port's idioms (LAF301-304; port of
``repro.analysis.ast_lint``).

* ``ast-traced-branch`` (LAF301): no Python ``if`` / ``while`` /
  ``assert`` on a device value, and no ``bool()`` or ``.item()`` of one,
  in the hot modules (``index/sweep.py``, ``distributed/index_plane.py``,
  ``kernels/*/ops.py``, ``core/laf_dbscan.py``): each is a host read
  that waits for the card.  A value is a device value when the
  expression reduces a tensor (``.any()``, ``.all()``, ``.sum()``,
  ``.max()``, ``.min()``, ``torch.equal``, ``torch.any``, ...) that is
  not a host value (a name the function binds to numpy arrays or Python
  containers, followed through its assignments and loops).  Exempt:
  the plain-version branch of a wrapper (code under ``if
  <x>.device.type == "cpu":``, whose reads are host memory), and a
  function that counts its host reads on a ``*.host_syncs`` counter;
* ``ast-wallclock-sync`` (LAF302): no ``time.perf_counter()`` /
  ``time.time()`` pair bracketing a launch (``DISPATCH_CALLS``) without a
  sync between them (``torch.cuda.synchronize``, an event's
  ``synchronize`` / ``elapsed_time``, a host copy, a span with
  ``sync=``): an unsynced pair measures the enqueue;
* ``ast-raw-kernel-launch`` (LAF303): ``_build.load(...)`` and the
  ``*_launch`` symbols of the CUDA libraries appear only in
  ``kernels/*/ops.py`` and ``kernels/_build.py``;
* ``ast-kernel-tile-contract`` (LAF304): a module constant of
  ``kernels/<name>/ops.py`` whose comment names a constant of a CUDA
  source (``(kRows)``, ``(csrc/flash_attention.cu DBK)``) equals its
  value there (``constexpr int`` or ``#define``), and every
  divisibility check ``NAME % m`` the module states on such a constant
  holds for its value.

Suppress one site with ``# laf-lint: disable=<check-id>`` on the line
(or the line above); whole paths belong in ``baseline.toml``.

:class:`LafLintPlugin` runs the per-file checks as a flake8 plugin.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from .registry import Finding, register

__all__ = [
    "iter_py_files", "parse_file", "filter_inline_suppressed", "check_file_traced_branch",
    "check_file_wallclock_sync", "check_file_raw_kernel_launch", "check_tree_kernel_tile_contract",
    "hot_files", "DISPATCH_CALLS", "launcher_symbols", "LafLintPlugin",
]


def iter_py_files(roots: Iterable[Path]) -> List[Path]:
    out = []
    for root in roots:
        root = Path(root)
        if root.is_file() and root.suffix == ".py":
            out.append(root)
        elif root.is_dir():
            out.extend(p for p in sorted(root.rglob("*.py")) if "__pycache__" not in p.parts)
    return out


def parse_file(path: Path) -> Tuple[Optional[ast.AST], List[str]]:
    src = Path(path).read_text()
    lines = src.splitlines()
    try:
        return ast.parse(src), lines
    except SyntaxError:
        return None, lines


def filter_inline_suppressed(findings: List[Finding], lines: List[str]) -> List[Finding]:
    """Drop findings whose line (or the one above) carries
    ``# laf-lint: disable=<check-id>``."""
    out = []
    for f in findings:
        tag = f"laf-lint: disable={f.check}"
        near = [lines[i] for i in (f.line - 1, f.line - 2) if 0 <= i < len(lines)]
        if not any(tag in ln for ln in near):
            out.append(f)
    return out


def _call_name(node: ast.AST) -> str:
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


# ---------------------------------------------------------------------------
# ast-traced-branch
# ---------------------------------------------------------------------------

_REDUCTIONS = {"any", "all", "sum", "max", "min", "amax", "amin", "count_nonzero", "nonzero", "item", "equal",
               "allclose", "prod", "mean"}
_TORCH_READS = {"torch.equal", "torch.any", "torch.all", "torch.allclose", "torch.count_nonzero", "torch.nonzero"}


_HOST_MODULES = ("np", "numpy", "math", "builtins")
# calls whose results live on the host (numpy arrays, Python values)
_HOST_CALLS = {"unpack_bitmap", "pack_bitmap", "numpy", "tolist", "len", "range", "list", "tuple", "dict", "set",
               "int", "float", "bool", "sorted", "enumerate", "zip"}


def _value_names(expr: ast.AST) -> set:
    """Names an expression reads as values (not the functions it calls)."""
    funcs = {id(n.func) for n in ast.walk(expr) if isinstance(n, ast.Call)}
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name) and id(n) not in funcs
            and n.id not in _HOST_MODULES}


def _is_host(expr: ast.AST, host: set) -> bool:
    """A host value: made by numpy or a host call, a literal, or built
    only from host names."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            root = _dotted(node.func).split(".")[0]
            if root in _HOST_MODULES or _call_name(node) in _HOST_CALLS:
                return True
    names = _value_names(expr)
    if not names:
        return isinstance(expr, (ast.Constant, ast.List, ast.Tuple, ast.Dict, ast.Set))
    return names <= host


def _host_names(fn: ast.AST) -> set:
    """Names a function binds to host values (numpy arrays, Python
    containers), to a fixpoint over its assignments and loops."""
    host: set = set()
    binds = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            binds.append((node.targets, node.value))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and node.value is not None:
            binds.append(([node.target], node.value))
        elif isinstance(node, (ast.For, ast.comprehension)):
            binds.append(([node.target], node.iter))
    changed = True
    while changed:
        changed = False
        for targets, value in binds:
            if not _is_host(value, host):
                continue
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and n.id not in host:
                        host.add(n.id)
                        changed = True
    return host


def _device_value(expr: ast.AST, host: frozenset = frozenset()) -> Optional[ast.AST]:
    """The first sub-expression that reduces a tensor (a device value), or
    None: a reduction of a host value does not count."""
    for node in ast.walk(expr):
        if not isinstance(node, ast.Call):
            continue
        if _dotted(node.func) in _TORCH_READS:
            return node
        if isinstance(node.func, ast.Attribute) and node.func.attr in _REDUCTIONS:
            if _is_host(node.func.value, host):
                continue
            return node
    return None


def _is_cpu_branch(test: ast.AST) -> bool:
    """``<x>.device.type == "cpu"`` (the wrappers' plain-version branch)."""
    return (isinstance(test, ast.Compare) and len(test.ops) == 1 and isinstance(test.ops[0], ast.Eq)
            and isinstance(test.left, ast.Attribute) and test.left.attr == "type"
            and isinstance(test.left.value, ast.Attribute) and test.left.value.attr == "device"
            and isinstance(test.comparators[0], ast.Constant) and test.comparators[0].value == "cpu")


def _counts_host_syncs(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and node.value.endswith("host_syncs"):
            return True
    return False


def _own_exprs(stmt: ast.stmt) -> List[ast.AST]:
    """The expressions a statement evaluates itself (not its blocks')."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in stmt.items]
    if isinstance(stmt, (ast.Try, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return []
    return [stmt]


def _scan_branches(body: List[ast.stmt], rel: str) -> List[Finding]:
    out: List[Finding] = []

    def report(node, what):
        out.append(Finding(
            "ast-traced-branch", rel, node.lineno,
            f"{what} reads a device value on the host: the enqueue waits for the card",
            hint="keep the decision on the device (torch.where, a flag the kernel reads), or count the read "
            "on a *.host_syncs counter where it is the path's one sync",
        ))

    def visit(stmts, host=frozenset()):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not _counts_host_syncs(stmt):
                    visit(stmt.body, frozenset(host | _host_names(stmt)))
                continue
            if isinstance(stmt, ast.If) and _is_cpu_branch(stmt.test):
                visit(stmt.orelse, host)
                continue
            if isinstance(stmt, (ast.If, ast.While, ast.Assert)):
                hit = _device_value(stmt.test, host)
                if hit is not None:
                    report(stmt, f"`{type(stmt).__name__.lower()}` on `{ast.unparse(hit)[:60]}`")
            for expr in _own_exprs(stmt):
                for sub in ast.walk(expr):
                    if not isinstance(sub, ast.Call):
                        continue
                    if isinstance(sub.func, ast.Attribute) and sub.func.attr == "item":
                        report(sub, f"`{ast.unparse(sub)[:60]}`")
                    elif (isinstance(sub.func, ast.Name) and sub.func.id == "bool" and sub.args
                          and _device_value(sub.args[0], host) is not None):
                        report(sub, f"`{ast.unparse(sub)[:60]}`")
            for block in ("body", "orelse", "finalbody"):
                visit(getattr(stmt, block, None) or [], host)
            for h in getattr(stmt, "handlers", []):
                visit(h.body, host)

    visit(body)
    seen, uniq = set(), []
    for f in out:  # one finding a line
        if f.line not in seen:
            seen.add(f.line)
            uniq.append(f)
    return uniq


def check_file_traced_branch(path: Path, tree: ast.AST, rel: str) -> List[Finding]:
    return _scan_branches(list(getattr(tree, "body", [])), rel)


def hot_files(src_root: Path) -> List[Path]:
    """The modules LAF301 holds: the sweep engine, the plane, the kernel
    wrappers and the LAF-DBSCAN engine."""
    src_root = Path(src_root)
    files = [src_root / "index" / "sweep.py", src_root / "distributed" / "index_plane.py",
             src_root / "core" / "laf_dbscan.py"]
    files += sorted((src_root / "kernels").glob("*/ops.py"))
    return [f for f in files if f.exists()]


# ---------------------------------------------------------------------------
# ast-wallclock-sync
# ---------------------------------------------------------------------------

_TIME_FNS = {"time", "perf_counter", "monotonic", "perf_counter_ns"}
# calls that enqueue device work and return before it ran
DISPATCH_CALLS = {
    "sweep_bitmap_device", "sharded_sweep_launch", "sharded_sweep_marginals", "sweep_marginals_local",
    "sharded_band_marginals", "hamming_filter_count", "hamming_filter_bitmap", "hamming_filter_into",
    "packed_cluster_labels", "packed_cluster_fixpoint", "sharded_cluster_labels", "label_prop_fixpoint",
    "label_prop_rect", "label_prop_update", "label_prop_round", "col_reduce", "row_popcount", "rmi_stage_forward",
    "rmi_predict", "rmi_predict_counts", "stage_launch", "range_count", "range_bitmap", "flash_attention",
    "embedding_bag", "query_bitmap_device", "query_packed_device", "packed_connectivity", "cluster_step",
    "cluster_one_launch",
}
_SYNC_CALLS = {"synchronize", "elapsed_time", "cpu", "item", "tolist", "numpy", "sync_on", "wait"}
_SPAN_NAMES = {"span", "_span"}


def _is_time_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _call_name(node) in _TIME_FNS and (
        (isinstance(node.func, ast.Attribute) and isinstance(node.func.value, ast.Name)
         and node.func.value.id == "time") or isinstance(node.func, ast.Name))


def _region_status(stmts: List[ast.stmt]):
    dispatch = None
    for stmt in stmts:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name in _SYNC_CALLS:
                return None
            if name in _SPAN_NAMES and any(kw.arg == "sync" for kw in node.keywords):
                return None
            if name in DISPATCH_CALLS and dispatch is None:
                dispatch = (name, node.lineno)
    return dispatch


def _flat(stmts) -> List[ast.stmt]:
    out = []
    for s in stmts:
        out.append(s)
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        for block in ("body", "orelse", "finalbody"):
            sub = getattr(s, block, None)
            if sub:
                out.extend(_flat(sub))
        for h in getattr(s, "handlers", []):
            out.extend(_flat(h.body))
    return out


def _scan_wallclock(fn_body: List[ast.stmt], rel: str) -> List[Finding]:
    findings: List[Finding] = []
    stmts = _flat(fn_body)
    for i, stmt in enumerate(stmts):
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and isinstance(stmt.targets[0], ast.Name)
                and _is_time_call(stmt.value)):
            continue
        timer = stmt.targets[0].id
        for j in range(i + 1, len(stmts)):
            reads = any(isinstance(n, ast.Name) and n.id == timer and isinstance(n.ctx, ast.Load)
                        for n in ast.walk(stmts[j]))
            if not reads:
                continue
            hit = _region_status(stmts[i + 1 : j + 1])
            if hit is not None:
                findings.append(Finding(
                    "ast-wallclock-sync", rel, stmt.lineno,
                    f"wall-clock pair `{timer}` brackets the launch `{hit[0]}(...)` (line {hit[1]}) with no sync "
                    f"between: it measures the enqueue, not the work",
                    hint="torch.cuda.synchronize() before reading the clock, or time with CUDA events",
                ))
            break
    return findings


def check_file_wallclock_sync(path: Path, tree: ast.AST, rel: str) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            findings.extend(_scan_wallclock(node.body, rel))
    return findings


# ---------------------------------------------------------------------------
# ast-raw-kernel-launch
# ---------------------------------------------------------------------------

_LAUNCH_RE = re.compile(r'"(\w+_launch)"\s*:')


def launcher_symbols(build_py: Optional[Path]) -> set:
    """The ``*_launch`` symbols ``kernels/_build.py`` binds (its
    ``_SIGNATURES`` keys); any ``<name>_launch`` attribute when unknown."""
    if build_py is None or not Path(build_py).exists():
        return set()
    return set(_LAUNCH_RE.findall(Path(build_py).read_text()))


def _allowed_launch_site(rel: str) -> bool:
    parts = Path(rel).parts
    return (len(parts) >= 3 and parts[-1] == "ops.py" and parts[-3] == "kernels") or (
        len(parts) >= 2 and parts[-1] == "_build.py" and parts[-2] == "kernels")


def _is_raw_launch(node: ast.Call, symbols: set) -> bool:
    name = _dotted(node.func)
    if name == "_build.load" or name.endswith("._build.load"):
        return True
    if not isinstance(node.func, ast.Attribute):
        return False
    if symbols:
        return node.func.attr in symbols
    return node.func.attr.endswith("_launch") and not name.startswith(("self.", "cls."))


def check_file_raw_kernel_launch(path: Path, tree: ast.AST, rel: str, symbols: Optional[set] = None
                                 ) -> List[Finding]:
    if _allowed_launch_site(rel):
        return []
    return [Finding(
        "ast-raw-kernel-launch", rel, node.lineno,
        f"raw kernel launch `{_dotted(node.func)}(...)` outside kernels/*/ops.py: launches go through the "
        f"wrappers (their operators, counters and fake implementations)",
        hint="call the kernel package's wrapper instead",
    ) for node in ast.walk(tree) if isinstance(node, ast.Call) and _is_raw_launch(node, symbols or set())]


# ---------------------------------------------------------------------------
# ast-kernel-tile-contract
# ---------------------------------------------------------------------------

_CONSTEXPR_RE = re.compile(r"constexpr\s+int\s+(\w+)\s*=\s*(\d+)\s*;")
_DEFINE_RE = re.compile(r"^\s*#define\s+(\w+)\s+\(?(\d+)\)?\s*$", re.M)
_MIRROR_RE = re.compile(r"\((?:csrc/(\w+)\.cu\s+)?(k[A-Z]\w*|[A-Z][A-Z0-9_]*)\)")


def _cuda_constants(cu: Path) -> Dict[str, int]:
    text = cu.read_text()
    out = {k: int(v) for k, v in _CONSTEXPR_RE.findall(text)}
    out.update({k: int(v) for k, v in _DEFINE_RE.findall(text)})
    return out


def _mirrors(ops_py: Path, tree: ast.AST, lines: List[str]):
    """(name, value, line, source stem or None, cuda constant) for each
    module int constant whose comment names a CUDA constant."""
    out = []
    for stmt in getattr(tree, "body", []):
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and isinstance(stmt.targets[0], ast.Name)):
            continue
        try:
            val = ast.literal_eval(stmt.value)
        except (ValueError, SyntaxError):
            continue
        if not isinstance(val, int) or isinstance(val, bool):
            continue
        line = lines[stmt.lineno - 1]
        if "#" not in line:
            continue
        m = _MIRROR_RE.search(line.split("#", 1)[1])
        if m:
            out.append((stmt.targets[0].id, val, stmt.lineno, m.group(1), m.group(2)))
    return out


def _divisibility_checks(tree: ast.AST):
    """(name, modulus, line) for every ``NAME % m`` with a literal m."""
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod) and isinstance(node.left, ast.Name)
                and isinstance(node.right, ast.Constant) and isinstance(node.right.value, int)):
            out.append((node.left.id, node.right.value, node.lineno))
    return out


def check_tree_kernel_tile_contract(root: Path, rel_to: Path) -> List[Finding]:
    """``root`` holds ``kernels/<name>/ops.py`` and ``csrc/<name>.cu``
    (the package directory, or a corpus entry laid out the same)."""
    root = Path(root)
    findings: List[Finding] = []
    for ops_py in sorted((root / "kernels").glob("*/ops.py")):
        tree, lines = parse_file(ops_py)
        if tree is None:
            continue
        rel = _rel(ops_py, rel_to)
        mirrors = _mirrors(ops_py, tree, lines)
        for name, val, line, stem, cname in mirrors:
            cu = root / "csrc" / f"{stem or ops_py.parent.name}.cu"
            if not cu.exists():
                continue
            consts = _cuda_constants(cu)
            if cname in consts and consts[cname] != val:
                findings.append(Finding(
                    "ast-kernel-tile-contract", rel, line,
                    f"{name} = {val} mirrors {cu.name}'s {cname} = {consts[cname]}: the wrapper's grid and "
                    f"padding math and the kernel disagree",
                    hint=f"set {name} to {consts[cname]} (or change both together)",
                ))
        values = {name: val for name, val, *_ in mirrors}
        for name, mod, line in _divisibility_checks(tree):
            if name in values and values[name] % mod:
                findings.append(Finding(
                    "ast-kernel-tile-contract", rel, line,
                    f"the wrapper checks `{name} % {mod}` but its own {name} = {values[name]} is not a multiple",
                    hint=f"make {name} a multiple of {mod}",
                ))
    return findings


def _rel(path: Path, rel_to: Path) -> str:
    try:
        return str(Path(path).resolve().relative_to(Path(rel_to).resolve()))
    except ValueError:
        return str(path)


# ---------------------------------------------------------------------------
# registered checks
# ---------------------------------------------------------------------------


def _run_file_check(ctx, files, per_file) -> List[Finding]:
    findings: List[Finding] = []
    for path in files:
        tree, lines = parse_file(path)
        if tree is None:
            continue
        findings.extend(filter_inline_suppressed(per_file(path, tree, _rel(path, ctx.repo_root)), lines))
    return findings


@register("ast-traced-branch", family="ast", code="LAF301", reference="ast-traced-branch",
          description="no python if/while/assert, bool() or .item() on a device value in the hot modules")
def _check_traced_branch(ctx) -> List[Finding]:
    return _run_file_check(ctx, hot_files(ctx.src_root), check_file_traced_branch)


@register("ast-wallclock-sync", family="ast", code="LAF302", reference="ast-wallclock-sync",
          description="no wall-clock pair around a launch without a sync")
def _check_wallclock(ctx) -> List[Finding]:
    return _run_file_check(ctx, iter_py_files([ctx.src_root]), check_file_wallclock_sync)


@register("ast-raw-kernel-launch", family="ast", code="LAF303", reference="ast-raw-pallas-call",
          description="_build.load and the *_launch symbols only in kernels/*/ops.py and kernels/_build.py")
def _check_raw_launch(ctx) -> List[Finding]:
    symbols = launcher_symbols(ctx.src_root / "kernels" / "_build.py")
    return _run_file_check(ctx, iter_py_files([ctx.src_root]),
                           lambda p, t, rel: check_file_raw_kernel_launch(p, t, rel, symbols))


@register("ast-kernel-tile-contract", family="ast", code="LAF304", reference="ast-kernel-tile-contract",
          description="ops.py's mirrors of CUDA tile constants and its divisibility checks agree with the source")
def _check_tiles(ctx) -> List[Finding]:
    return check_tree_kernel_tile_contract(ctx.src_root, ctx.repo_root)


# ---------------------------------------------------------------------------
# flake8 plugin
# ---------------------------------------------------------------------------


class LafLintPlugin:
    """flake8 entry point (the AST family's per-file checks, LAF301-303;
    the tree-wide tile contract and the trace and probe passes need the
    whole repository and stay in ``python -m repro_torch.analysis``).

    Register under ``flake8.extension`` as
    ``LAF = repro_torch.analysis.ast_lint:LafLintPlugin``; ``run()``
    yields ``(line, column, "LAFnnn message", type)`` as flake8 reads
    it, with the inline suppressions applied."""

    name = "laf-lint"
    version = "1.0.0"

    def __init__(self, tree: ast.AST, filename: str = "<unknown>"):
        self._tree = tree
        self._filename = filename

    def run(self):
        from .registry import CHECKS, load_all_checks

        load_all_checks()
        path = Path(self._filename)
        symbols = launcher_symbols(Path(__file__).resolve().parents[1] / "kernels" / "_build.py")
        findings: List[Finding] = []
        for per_file in (check_file_traced_branch, check_file_wallclock_sync,
                         lambda p, t, rel: check_file_raw_kernel_launch(p, t, rel, symbols)):
            findings.extend(per_file(path, self._tree, str(path)))
        try:
            findings = filter_inline_suppressed(findings, path.read_text().splitlines())
        except OSError:
            pass
        for f in findings:
            code = CHECKS[f.check].code if f.check in CHECKS else "LAF300"
            yield f.line, 0, f"{code} {f.message}", type(self)
