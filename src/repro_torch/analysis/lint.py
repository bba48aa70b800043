"""AST lint: source rules the step recorder and the collective audit cannot
see. Port of ``repro/analysis/lint.py``; the three rules are the
reference's, and for the same source ``lint_source`` gives the same
findings. Rules over every Python file under the root (default
``src/repro_torch``):

* ``no_float64_literals`` — no ``float64`` dtype literal anywhere
  (``np.float64``, ``torch.float64``, ``"float64"`` strings): host-side f64
  arrays silently double checkpoint and bandwidth budgets. Waive a
  deliberate use with ``# lint: allow-float64`` on the line.
* ``no_numpy_in_scan_body`` — no ``np.`` / ``numpy.`` calls inside a
  function passed to ``lax.scan``: numpy executes at trace time, silently
  constant-folding what looks like per-tick work.
* ``no_python_if_on_traced_in_scan_body`` — no Python ``if`` whose test
  reads a scan-body parameter (the carry / per-tick operands are tracers).
  Waive host-side config branching with ``# lint: allow-traced-if``.

Scan bodies are resolved statically: for every ``*.scan(body, ...)`` call
the first argument's function name is collected (unwrapping
``jax.checkpoint(body)`` / ``functools.partial(body, ...)``), and every
``def`` of that name in the module is linted. ``src/repro_torch`` runs its
tick loops eagerly and has no ``*.scan(`` call, so rules 2 and 3 find
nothing there; they stay for any source handed to ``lint_source``.
"""
from __future__ import annotations

import ast
import os
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Set

from repro_torch.analysis.dtype import CheckResult

RULE_F64 = "no_float64_literals"
RULE_SCAN_NP = "no_numpy_in_scan_body"
RULE_SCAN_IF = "no_python_if_on_traced_in_scan_body"

# spelled split so the linter does not flag its own needle
_F64 = "float" + "64"


@dataclass
class LintFinding:
    path: str
    line: int
    rule: str
    message: str

    def to_json(self) -> Dict[str, Any]:
        return asdict(self)


def _waived(src_lines: List[str], lineno: int, tag: str) -> bool:
    if 1 <= lineno <= len(src_lines):
        return f"lint: allow-{tag}" in src_lines[lineno - 1]
    return False


def _first_name(node: ast.AST) -> Optional[str]:
    """Function name referenced by a scan-body argument, unwrapping
    ``jax.checkpoint(body)`` / ``partial(body, ...)`` style wrappers."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Call):
        for arg in node.args:
            name = _first_name(arg)
            if name:
                return name
    return None


def _scan_body_names(tree: ast.AST) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "scan" and node.args:
            name = _first_name(node.args[0])
            if name:
                names.add(name)
    return names


def _numpy_root(node: ast.AST) -> bool:
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name) and node.id in ("np", "numpy")


def _lint_scan_body(
    fn: ast.FunctionDef, path: str, src_lines: List[str]
) -> List[LintFinding]:
    out: List[LintFinding] = []
    params = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if _numpy_root(node.func):
                out.append(LintFinding(
                    path, node.lineno, RULE_SCAN_NP,
                    f"numpy call `{ast.unparse(node.func)}` inside scan body "
                    f"`{fn.name}` runs at trace time, not per tick",
                ))
        elif isinstance(node, ast.If):
            used = {
                n.id for n in ast.walk(node.test) if isinstance(n, ast.Name)
            }
            traced = sorted(used & params)
            if traced and not _waived(src_lines, node.lineno, "traced-if"):
                out.append(LintFinding(
                    path, node.lineno, RULE_SCAN_IF,
                    f"Python `if` on scan-body parameter(s) {traced} in "
                    f"`{fn.name}`: use jnp.where / lax.cond",
                ))
    return out


def lint_source(src: str, path: str = "<string>") -> List[LintFinding]:
    tree = ast.parse(src)
    src_lines = src.splitlines()
    out: List[LintFinding] = []

    # rule 1: float64 literals anywhere in the file
    for node in ast.walk(tree):
        hit = None
        if isinstance(node, ast.Attribute) and node.attr == _F64:
            hit = ast.unparse(node)
        elif isinstance(node, ast.Name) and node.id == _F64:
            hit = node.id
        elif isinstance(node, ast.Constant) and node.value == _F64:
            hit = repr(node.value)
        if hit is not None and not _waived(src_lines, node.lineno, _F64):
            out.append(LintFinding(
                path, node.lineno, RULE_F64, f"float64 literal `{hit}`"
            ))

    # rules 2+3: inside every function passed to lax.scan
    bodies = _scan_body_names(tree)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node.name in bodies:
            out.extend(_lint_scan_body(node, path, src_lines))
    return out


def lint_file(path: str) -> List[LintFinding]:
    with open(path, "r") as f:
        return lint_source(f.read(), path)


def repo_root() -> str:
    """src/repro_torch — the package this file lives in."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_tree(root: Optional[str] = None) -> List[LintFinding]:
    root = root or repo_root()
    findings: List[LintFinding] = []
    for dirpath, _dirs, files in os.walk(root):
        for fname in sorted(files):
            if fname.endswith(".py"):
                findings.extend(lint_file(os.path.join(dirpath, fname)))
    return findings


def check_repo_lint(root: Optional[str] = None) -> CheckResult:
    findings = lint_tree(root)
    detail = "; ".join(
        f"{f.path}:{f.line} [{f.rule}] {f.message}" for f in findings[:6]
    )
    return CheckResult(
        "ast_lint", not findings, detail,
        {"findings": [f.to_json() for f in findings]},
    )
