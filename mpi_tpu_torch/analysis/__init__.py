"""``mpi_tpu_torch.analysis``: AST invariant checkers over the port.

The port's own copy of ``mpi_tpu.analysis`` (it imports nothing of the
JAX package, that one included).  The bug classes the reference's
checkers guard are the port's too, because its serve layer, its engine
contract and its observability registry are the reference's: a session
field read outside ``session.lock`` tears, a grid read after an engine
step consumed it reads a buffer the next step overwrites, and a request
id dropped on a thread hop detaches a span from its request.  The rules
read the stdlib ``ast`` of ``mpi_tpu_torch/`` and ``chip_smoke.py``; no
code under analysis is imported.

Rules (see each module's docstring for the precise contract):

* ``donation-safety``   (:mod:`.donation`): a grid handed to a consuming
  engine call (``<engine>.step``, ``.step_units``, ``.step_batched``,
  ``.step_batched_units``, a ``batched_stepper``) must not be read
  afterwards; rebinding is the safe idiom.
* ``lock-discipline``   (:mod:`.locks`): attributes declared shared in
  the per-class manifest may only be touched under their declared lock;
  multi-lock acquisition loops must sort by ``.id`` first.
* ``traced-purity``     (:mod:`.purity`): no ``time.*`` / ``random.*``
  / ``np.random`` / file I/O / mutable defaults in the rule code whose
  output is hashed into a cached kernel library's key (the port's analog
  of the reference's traced code).
* ``ctxvar-hop``        (:mod:`.ctxvar`): thread/executor hops into
  code that reads the rid contextvar must ``copy_context`` (or stash
  the rid explicitly with ``set_request_id``).
* ``obs-drift``         (:mod:`.obsreg`): the statically-extracted
  metric/span registry of ``mpi_tpu_torch/`` must agree with the README
  tables and ``tools/obs_smoke.py`` in both directions.

Suppressions are inline with a mandatory reason (``<rule>`` stands for
a real rule name; the literal form is ``lint: disable=`` + the name)::

    self.grid = g  # lint: disable=<rule> -- caller holds lock

A suppression on a ``def`` line scopes to the whole function.  A
suppression missing its ``-- reason`` is itself a finding, and so is a
*stale* one: a suppression naming a rule that produces no finding in
its scope is reported as unused (suppressions rot silently otherwise).
Findings that cannot carry a comment (e.g. in README.md) go in the
checked-in ``baseline.json`` next to this file, each with a written
reason.

Runner: ``python -m mpi_tpu_torch.analysis [--rule R] [--write-baseline]``;
exit 0 clean, 1 findings, 2 internal error.  ``tests/test_torch_lint.py``
runs the same suite inside the tests.  The launch-level verifier of the
engines is the subpackage :mod:`.ir`.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding", "Rule", "SourceFile", "Report", "Suppression",
    "all_rules", "default_files", "load_baseline", "repo_root", "run",
    "write_baseline", "BASELINE_PATH",
]

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")

# `# lint: disable=<rule-a>,<rule-b> -- why this is safe` (with real
# rule names in place of the angle-bracket placeholders)
_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*disable=([A-Za-z0-9_\-, ]+?)\s*(?:--\s*(.*\S))?\s*$")


def repo_root() -> str:
    """The checkout root (the directory holding the ``mpi_tpu_torch``
    package)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


@dataclass
class Suppression:
    """One parsed ``# lint: disable=`` comment: the line it sits on, the
    [start, end] line range it applies to, the rules it names, and —
    filled in during :func:`run` — which of those rules it actually
    suppressed a finding for.  Rules never hit are stale and reported."""

    line: int                 # where the comment lives (for diagnostics)
    start: int                # first line it covers
    end: int                  # last line it covers (== start for one line)
    rules: Set[str]
    used: Set[str] = field(default_factory=set)

    def covers(self, rule: str, line: int) -> bool:
        return rule in self.rules and self.start <= line <= self.end


@dataclass(frozen=True)
class Finding:
    """One diagnostic: ``rel:line:col: [rule] message``.

    ``scope`` is the enclosing def's qualname (or ``<module>``) — the
    baseline fingerprint hashes rule/rel/scope/message but NOT the line
    number, so unrelated edits above a baselined finding don't churn it.
    """

    rule: str
    rel: str          # repo-relative path, '/'-separated
    line: int
    col: int
    message: str
    scope: str = "<module>"

    def format(self) -> str:
        return f"{self.rel}:{self.line}:{self.col}: [{self.rule}] {self.message}"

    def fingerprint(self) -> str:
        raw = f"{self.rule}:{self.rel}:{self.scope}:{self.message}"
        return hashlib.sha1(raw.encode("utf-8")).hexdigest()[:16]


class SourceFile:
    """A parsed file plus the lint metadata every rule needs: the AST,
    enclosing-def spans for scope attribution, and parsed suppressions."""

    def __init__(self, path: str, root: str):
        self.path = os.path.abspath(path)
        self.rel = os.path.relpath(self.path, root).replace(os.sep, "/")
        with open(self.path, "r", encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=self.path)
        # (start, end, qualname) per def, in source order (innermost =
        # smallest containing span)
        self._defs: List[Tuple[int, int, str]] = []
        self._collect_defs(self.tree, "")
        self.suppressions: List[Suppression] = []
        self.bad_suppress_lines: List[int] = []
        self._parse_suppressions()

    # -- structure -------------------------------------------------------

    def _collect_defs(self, node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = f"{prefix}{child.name}"
                if not isinstance(child, ast.ClassDef):
                    self._defs.append(
                        (child.lineno, child.end_lineno or child.lineno, qual))
                self._collect_defs(child, qual + ".")
            else:
                self._collect_defs(child, prefix)

    def enclosing_scope(self, line: int) -> str:
        best: Optional[Tuple[int, int, str]] = None
        for start, end, qual in self._defs:
            if start <= line <= end:
                if best is None or (end - start) < (best[1] - best[0]):
                    best = (start, end, qual)
        return best[2] if best else "<module>"

    # -- suppressions ----------------------------------------------------

    def _def_span_at(self, line: int) -> Optional[Tuple[int, int]]:
        for start, end, _qual in self._defs:
            if start == line:
                return (start, end)
        return None

    def _parse_suppressions(self) -> None:
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            reason = m.group(2)
            if not reason:
                # an unjustified suppression neither suppresses nor
                # passes: it is a finding in its own right
                self.bad_suppress_lines.append(i)
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            span = self._def_span_at(i)
            if span is not None:
                self.suppressions.append(
                    Suppression(i, span[0], span[1], rules))
            elif text.lstrip().startswith("#"):
                # standalone comment: applies to the next non-blank line
                j = i + 1
                while j <= len(self.lines) and not self.lines[j - 1].strip():
                    j += 1
                span2 = self._def_span_at(j)
                if span2 is not None:
                    self.suppressions.append(
                        Suppression(i, span2[0], span2[1], rules))
                else:
                    self.suppressions.append(Suppression(i, j, j, rules))
            else:
                self.suppressions.append(Suppression(i, i, i, rules))

    def is_suppressed(self, rule: str, line: int) -> bool:
        """Whether (rule, line) is covered — and mark every covering
        suppression as *used* for that rule (the unused-suppression
        check reads the leftovers)."""
        hit = False
        for sup in self.suppressions:
            if sup.covers(rule, line):
                sup.used.add(rule)
                hit = True
        return hit

    # -- diagnostics -----------------------------------------------------

    def finding(self, rule: str, node, message: str) -> Finding:
        if isinstance(node, int):
            line, col = node, 0
        else:
            line, col = node.lineno, node.col_offset
        return Finding(rule, self.rel, line, col, message,
                       self.enclosing_scope(line))


@dataclass(frozen=True)
class Rule:
    """A named analyzer.  ``file_check(sf)`` runs once per SourceFile;
    ``project_check(root, files)`` runs once over the whole tree (for
    cross-file invariants like registry drift)."""

    name: str
    doc: str
    file_check: Optional[Callable[[SourceFile], List[Finding]]] = None
    project_check: Optional[
        Callable[[str, Sequence[SourceFile]], List[Finding]]] = None


def all_rules() -> List[Rule]:
    from mpi_tpu_torch.analysis import (
        ctxvar, donation, locks, obsreg, purity,
    )
    return [donation.RULE, locks.RULE, purity.RULE, ctxvar.RULE, obsreg.RULE]


# -- file walker ----------------------------------------------------------

# tests/ are deliberately out of the default scope: fixtures there are
# known-bad on purpose and tests poke internals lock-free by design.
DEFAULT_SCOPE = ("mpi_tpu_torch", "chip_smoke.py")


def default_files(root: str) -> List[str]:
    out: List[str] = []
    for entry in DEFAULT_SCOPE:
        p = os.path.join(root, entry)
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__" and
                                 not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(out)


# -- baseline -------------------------------------------------------------

def load_baseline(path: Optional[str] = None) -> Dict[str, dict]:
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return data.get("fingerprints", {})


def write_baseline(findings: Iterable[Finding],
                   path: Optional[str] = None) -> str:
    path = path or BASELINE_PATH
    fps = {
        f.fingerprint(): {
            "rule": f.rule, "path": f.rel, "scope": f.scope,
            "message": f.message,
            "reason": "TODO: justify this baseline entry",
        }
        for f in sorted(findings, key=lambda f: (f.rel, f.line, f.rule))
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"fingerprints": fps}, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


# -- runner ---------------------------------------------------------------

@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)   # actionable
    suppressed: List[Finding] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings and not self.errors


def run(root: Optional[str] = None,
        rules: Optional[Sequence[Rule]] = None,
        paths: Optional[Sequence[str]] = None,
        baseline_path: Optional[str] = None,
        use_baseline: bool = True) -> Report:
    """Run ``rules`` (default: all) over ``paths`` (default: the repo
    scope) and fold in suppressions and the baseline."""
    root = os.path.abspath(root or repo_root())
    rules = list(rules) if rules is not None else all_rules()
    paths = list(paths) if paths is not None else default_files(root)

    report = Report()
    files: List[SourceFile] = []
    by_rel: Dict[str, SourceFile] = {}
    for p in paths:
        try:
            sf = SourceFile(p, root)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            report.errors.append(f"{p}: {type(e).__name__}: {e}")
            continue
        files.append(sf)
        by_rel[sf.rel] = sf

    raw: List[Finding] = []
    for sf in files:
        for line in sf.bad_suppress_lines:
            raw.append(sf.finding(
                "suppression", line,
                "lint suppression is missing its '-- reason'"))
    for rule in rules:
        try:
            if rule.file_check is not None:
                for sf in files:
                    raw.extend(rule.file_check(sf))
            if rule.project_check is not None:
                raw.extend(rule.project_check(root, files))
        except Exception as e:  # a crashing rule must fail loudly, not pass
            report.errors.append(f"rule {rule.name}: {type(e).__name__}: {e}")

    baseline = load_baseline(baseline_path) if use_baseline else {}
    for f in sorted(raw, key=lambda f: (f.rel, f.line, f.col, f.rule)):
        sf = by_rel.get(f.rel)
        if sf is not None and sf.is_suppressed(f.rule, f.line):
            report.suppressed.append(f)
        elif f.fingerprint() in baseline:
            report.baselined.append(f)
        else:
            report.findings.append(f)

    # stale suppressions: every parsed suppression has now seen every
    # finding of this run; a named rule it never suppressed is rot (or a
    # typo — an unknown rule name can never match).  Only rules that
    # actually ran are judged: `--rule lock-discipline` must not flag
    # the tree's justified traced-purity suppressions as unused.
    active = {r.name for r in rules}
    known = {r.name for r in all_rules()}
    for sf in files:
        for sup in sf.suppressions:
            for rule_name in sorted((sup.rules & active) - sup.used):
                f = sf.finding(
                    "unused-suppression", sup.line,
                    f"suppression for '{rule_name}' matches no finding "
                    f"— remove it (stale suppressions hide future "
                    f"regressions)")
                (report.findings if f.fingerprint() not in baseline
                 else report.baselined).append(f)
            for rule_name in sorted(sup.rules - known):
                f = sf.finding(
                    "unused-suppression", sup.line,
                    f"suppression names unknown rule '{rule_name}' "
                    f"(typo? see --list-rules)")
                (report.findings if f.fingerprint() not in baseline
                 else report.baselined).append(f)
    return report
