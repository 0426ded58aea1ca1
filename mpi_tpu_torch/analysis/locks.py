"""``lock-discipline`` — shared attributes only under their lock.

The torn-read bug class: session fields read outside ``session.lock`` tear
(generation from one step, grid from another).  The port's serve layer
(``mpi_tpu_torch/serve``) keeps the reference's classes and their
sharing contract, which lives in ``MANIFEST`` below — a per-class map of
*guarded attribute -> lock attribute* plus the alias names other
modules use for instances.  The rule flags:

* ``self.<attr>`` inside the owning class (``__init__`` exempt — the
  object is not yet shared) outside a guard region for the declared
  lock;
* ``<alias>.<attr>`` / ``<x>.<alias>.<attr>`` chains in the serve
  modules outside a guard on the *same base* (``with e.session.lock:``
  guards ``e.session.grid``, not ``other.grid``);
* a loop that acquires ``.lock`` on its elements without first sorting
  the iterable by ``.id`` (the deadlock-freedom pattern:
  ``ordered.sort(key=lambda e: e.session.id)`` before the acquire
  loop);
* taking a session lock while already holding the dispatcher ``_cv``
  (the documented order is ``session.lock -> _cv``, never reversed).

Guard regions are ``with <base>.<lockattr>:`` blocks plus lexical
``<base>.<lockattr>.acquire()`` ... ``.release()`` intervals.  A
``Condition`` guards like a lock (``with self._cv:``).

New serve-layer shared attributes MUST be added here (see
MIGRATION.md); the fixture corpus pins the detection behavior.  The
manifest lists the reference's classes only, as the reference's does:
``cluster/node.py``'s and ``admission/``'s own locks are not in it.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from mpi_tpu_torch.analysis import Finding, Rule, SourceFile

RULE_NAME = "lock-discipline"


@dataclass(frozen=True)
class ClassSpec:
    """Sharing contract for one class: ``guarded`` maps attribute name
    to the lock attribute that must be held; ``aliases`` are the
    variable names other modules use for instances; ``any_base`` means
    the lock lives on another object (e.g. Ticket fields are guarded by
    the *dispatcher's* ``_cv``), so any held guard with that lock name
    counts."""

    guarded: Dict[str, str]
    aliases: Set[str] = field(default_factory=set)
    any_base: bool = False


MANIFEST: Dict[str, ClassSpec] = {
    # the torn-read quartet minus scrape-only fields: grid+generation
    # must move together, closed gates every mutation
    "Session": ClassSpec(
        guarded={"grid": "lock", "generation": "lock", "closed": "lock"},
        aliases={"session", "sess", "s"},
    ),
    "SessionManager": ClassSpec(
        guarded={"_sessions": "_lock", "_next": "_lock",
                 "_step_listeners": "_listeners_lock"},
    ),
    "MicroBatcher": ClassSpec(
        guarded={"_queues": "_lock"},
    ),
    "AsyncDispatcher": ClassSpec(
        guarded={"_inbox": "_cv", "_per_session": "_cv", "_tickets": "_cv",
                 "_done_order": "_cv", "_completed_by_sid": "_cv"},
    ),
    # Ticket state flips under the owning dispatcher's _cv — the lock
    # is on another object, so any held _cv guard satisfies the rule
    "Ticket": ClassSpec(
        guarded={"status": "_cv", "result": "_cv", "error": "_cv",
                 "callbacks": "_cv"},
        aliases={"ticket", "t"},
        any_base=True,
    ),
    "EngineCache": ClassSpec(
        guarded={"_entries": "_lock", "_batched": "_lock",
                 "_breakers": "_lock"},
    ),
    "AioServer": ClassSpec(
        guarded={"_actions": "_actions_lock"},
    ),
}

# alias-based checks only fire where the serve objects actually travel;
# elsewhere a stray `s.grid` is some other s
ALIAS_MODULES = (
    "mpi_tpu_torch/serve/session.py", "mpi_tpu_torch/serve/ticket.py",
    "mpi_tpu_torch/serve/batch.py", "mpi_tpu_torch/serve/cache.py",
    "mpi_tpu_torch/serve/aio.py", "mpi_tpu_torch/serve/transport.py",
)

_LOCK_ATTRS = {ln for spec in MANIFEST.values() for ln in spec.guarded.values()}


def _dump(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return ast.dump(node)


@dataclass
class _Guard:
    start: int
    end: int
    base: str       # unparsed base expr: "self", "e.session", ...
    lock: str       # lock attribute name: "lock", "_cv", ...


def _guards_in(fn: ast.AST, nodes: Optional[List[ast.AST]] = None) \
        -> List[_Guard]:
    guards: List[_Guard] = []
    acquires: List[Tuple[int, str, str]] = []   # (line, base, lock)
    for node in (ast.walk(fn) if nodes is None else nodes):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ce = item.context_expr
                if isinstance(ce, ast.Attribute) and ce.attr in _LOCK_ATTRS:
                    guards.append(_Guard(node.lineno,
                                         node.end_lineno or node.lineno,
                                         _dump(ce.value), ce.attr))
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            meth = node.func.attr
            tgt = node.func.value
            if meth in ("acquire", "release") \
                    and isinstance(tgt, ast.Attribute) \
                    and tgt.attr in _LOCK_ATTRS:
                base, lock = _dump(tgt.value), tgt.attr
                if meth == "acquire":
                    acquires.append((node.lineno, base, lock))
                else:
                    for i, (ln, b, l) in enumerate(acquires):
                        if b == base and l == lock:
                            guards.append(_Guard(ln, node.lineno, base, lock))
                            acquires.pop(i)
                            break
    # unmatched acquire (released elsewhere / in a helper): guard to
    # end of function — conservative toward fewer false positives
    end = fn.end_lineno or fn.lineno
    for ln, base, lock in acquires:
        guards.append(_Guard(ln, end, base, lock))
    return guards


def _held(guards: Sequence[_Guard], line: int, base: str, lock: str,
          any_base: bool) -> bool:
    for g in guards:
        if g.start <= line <= g.end and g.lock == lock \
                and (any_base or g.base == base):
            return True
    return False


def _iter_method_scopes(sf: SourceFile):
    """(class_name_or_None, function_node) for every def in the file."""
    def rec(node: ast.AST, cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from rec(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield cls, child
                yield from rec(child, cls)
            else:
                yield from rec(child, cls)
    yield from rec(sf.tree, None)


def _check_attr_accesses(sf: SourceFile, scopes: List[tuple]) -> List[Finding]:
    findings: List[Finding] = []
    defined_here = {n.name for n in ast.walk(sf.tree)
                    if isinstance(n, ast.ClassDef)}
    alias_ok = sf.rel in ALIAS_MODULES or "lint_fixtures" in sf.rel

    for cls, fn, nodes, guards in scopes:
        if fn.name == "__init__":
            continue
        for node in nodes:
            if not isinstance(node, ast.Attribute):
                continue
            attr = node.attr
            base = node.value
            # self.<attr> inside the owning class
            if isinstance(base, ast.Name) and base.id == "self" \
                    and cls in MANIFEST and cls in defined_here \
                    and attr in MANIFEST[cls].guarded:
                spec = MANIFEST[cls]
                lock = spec.guarded[attr]
                if not _held(guards, node.lineno, "self", lock, spec.any_base):
                    findings.append(sf.finding(
                        RULE_NAME, node,
                        f"{cls}.{attr} touched without holding "
                        f"self.{lock} (declared shared in the lock "
                        f"manifest)"))
                continue
            # <...>.<alias>.<attr> chains in serve modules (the unparse
            # is deferred here — most files and most attributes never
            # reach the alias path, and it dominates the lint budget)
            if not alias_ok:
                continue
            base_d = _dump(base)
            tail = base_d.rsplit(".", 1)[-1]
            for cname, spec in MANIFEST.items():
                if tail in spec.aliases and attr in spec.guarded:
                    lock = spec.guarded[attr]
                    if not _held(guards, node.lineno, base_d, lock,
                                 spec.any_base):
                        findings.append(sf.finding(
                            RULE_NAME, node,
                            f"{base_d}.{attr} ({cname}.{attr}) touched "
                            f"without holding {base_d}.{lock}" if not
                            spec.any_base else
                            f"{base_d}.{attr} ({cname}.{attr}) touched "
                            f"without holding the dispatcher {lock}"))
                    break
    return findings


def _check_multi_lock(sf: SourceFile, scopes: List[tuple]) -> List[Finding]:
    """Acquire loops must sort by .id first; no session lock under _cv."""
    findings: List[Finding] = []
    for _cls, fn, nodes, fn_guards in scopes:
        # (a) for-loop acquiring .lock on elements of an iterable
        sorted_names: Set[str] = set()
        for node in nodes:
            # name.sort(key=...".id"...) or name = sorted(..., key=...".id"...)
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "sort" \
                        and isinstance(node.func.value, ast.Name) \
                        and any(kw.arg == "key" and ".id" in _dump(kw.value)
                                for kw in node.keywords):
                    sorted_names.add(node.func.value.id)
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                c = node.value
                if isinstance(c.func, ast.Name) and c.func.id == "sorted" \
                        and any(kw.arg == "key" and ".id" in _dump(kw.value)
                                for kw in c.keywords):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            sorted_names.add(t.id)
        for node in nodes:
            if not isinstance(node, ast.For):
                continue
            acquires_locks = any(
                isinstance(c, ast.Call)
                and isinstance(c.func, ast.Attribute)
                and c.func.attr == "acquire"
                and isinstance(c.func.value, ast.Attribute)
                and c.func.value.attr == "lock"
                for c in ast.walk(node))
            if not acquires_locks:
                continue
            it = node.iter
            if isinstance(it, ast.Name) and it.id in sorted_names:
                continue
            if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                    and it.func.id == "sorted" \
                    and any(kw.arg == "key" and ".id" in _dump(kw.value)
                            for kw in it.keywords):
                continue
            findings.append(sf.finding(
                RULE_NAME, node,
                "loop acquires per-element .lock without an id-ordered "
                "sort of the iterable first (deadlock hazard; sort by "
                ".id as in MicroBatcher._run_chunk)"))
        # (b) session lock taken while holding _cv: lock order is
        # session.lock -> _cv, never reversed
        cv_guards = [g for g in fn_guards if g.lock == "_cv"]
        for node in nodes:
            grabbing = None
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    ce = item.context_expr
                    if isinstance(ce, ast.Attribute) and ce.attr == "lock":
                        grabbing = node
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "acquire" \
                    and isinstance(node.func.value, ast.Attribute) \
                    and node.func.value.attr == "lock":
                grabbing = node
            if grabbing is None:
                continue
            for g in cv_guards:
                # strictly inside the _cv region (not the same statement)
                if g.start < grabbing.lineno <= g.end:
                    findings.append(sf.finding(
                        RULE_NAME, grabbing,
                        "session lock acquired while holding _cv — the "
                        "documented order is session.lock -> _cv, never "
                        "reversed"))
                    break
    return findings


def check(sf: SourceFile) -> List[Finding]:
    # one walk + one guard scan per scope, shared by both checkers —
    # re-walking every def for every sub-check dominated the lint budget
    scopes = []
    for cls, fn in _iter_method_scopes(sf):
        nodes = list(ast.walk(fn))
        scopes.append((cls, fn, nodes, _guards_in(fn, nodes)))
    return _check_attr_accesses(sf, scopes) + _check_multi_lock(sf, scopes)


RULE = Rule(
    name=RULE_NAME,
    doc="manifest-declared shared attributes only under their lock; "
        "multi-lock loops id-ordered; never session.lock under _cv",
    file_check=check,
)
