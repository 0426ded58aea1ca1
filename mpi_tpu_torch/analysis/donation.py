"""``donation-safety`` — no reads of a grid after an engine step consumed it.

The reference guards jitted programs built with ``donate_argnums``; the
port has no jit, but its engines keep the same contract by hand.
``Engine.step``, ``step_units``, ``step_batched``, ``step_batched_units``
and the callable ``batched_stepper(B)`` returns all consume their input:
the engine keeps the input's buffer as the spare of its ping-pong pair,
and the next step of that shape writes into it
(``backends/cuda.py:Engine``: "Callers must replace their reference with
the returned grid and never read the old one").  The safe idiom is
rebinding (``g = eng.step(g, n)``); the bug idiom keeps a second
reference alive::

    out = engine.step(grid, n)
    band = grid[0:2, :]      # reads a buffer the next step overwrites

The rule is purely lexical within one function scope:

1. A *consuming call* is ``<engine>.step(...)``, ``.step_units``,
   ``.step_batched`` or ``.step_batched_units`` on a receiver whose last
   name is in :data:`ENGINE_ALIASES` (``engine``, ``eng``,
   ``self.engine``, ``entry.engine``, ``e.session.engine``: the names the
   serve layer gives an engine), or a call of a name bound in the module
   to ``<engine>.batched_stepper(...)``, directly or through a builder
   lambda (``stepper, _ = cache.get_or_build_batched(sig, B, lambda:
   engine.batched_stepper(B))``).

2. Walking statements in source order, a consuming call marks its
   argument 0 dead when it is a plain name or an attribute chain of
   names (``session.grid``); any later load of it is a finding.
   Assigning to it, or to a prefix of it (``session = ...``), including
   the rebind in the same statement, resurrects it.  The two branches of
   an ``if`` start alike, and one that ends in ``return``, ``raise``,
   ``break`` or ``continue`` passes no dead chain on; a comprehension's
   own targets are not the dead names.

Out of scope: receivers outside the alias set (``SessionManager.step(sid,
n)`` takes a session id and consumes nothing; ``self.step`` inside the
engine is the engine's own chain), subscripted arguments (``grids[i]``),
and steppers that travel through containers.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from mpi_tpu_torch.analysis import Finding, Rule, SourceFile

RULE_NAME = "donation-safety"

# the names an engine travels under in the port's serve code
ENGINE_ALIASES = frozenset({"engine", "eng"})
# the Engine methods that consume their argument 0
CONSUMING_METHODS = frozenset({
    "step", "step_units", "step_batched", "step_batched_units"})
STEPPER_FACTORY = "batched_stepper"
# statements after which a branch's dead set does not flow on
_EXITS = (ast.Return, ast.Raise, ast.Break, ast.Continue)


def _chain(node: ast.AST) -> Optional[str]:
    """``a.b.c`` of a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _is_engine(receiver: ast.AST) -> bool:
    chain = _chain(receiver)
    return chain is not None and chain.rsplit(".", 1)[-1] in ENGINE_ALIASES


def _builds_stepper(expr: ast.AST) -> bool:
    """Whether ``expr`` calls ``<engine>.batched_stepper(...)`` anywhere,
    a builder lambda's body included."""
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == STEPPER_FACTORY and _is_engine(n.func.value)
               for n in ast.walk(expr))


def _collect_steppers(tree: ast.Module) -> Set[str]:
    """Names bound to a batched stepper: the target of an assignment whose
    value builds one (a tuple target's first name)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and _builds_stepper(node.value)):
            continue
        t = node.targets[0]
        if isinstance(t, (ast.Tuple, ast.List)) and t.elts:
            t = t.elts[0]
        if isinstance(t, ast.Name):
            out.add(t.id)
    return out


class _ScopeWalker:
    """Statement-order walk of one function body tracking dead chains."""

    def __init__(self, sf: SourceFile, steppers: Set[str]):
        self.sf = sf
        self.steppers = steppers
        self.findings: List[Finding] = []

    def walk(self, fn: ast.AST) -> None:
        self._block(list(fn.body), {})

    def _block(self, stmts: Sequence[ast.stmt], dead: Dict[str, int]) -> None:
        for st in stmts:
            self._stmt(st, dead)

    def _expr(self, expr: ast.expr, dead: Dict[str, int]) -> None:
        self._check_expr(expr, dead)
        dead.update(self._consumed_in(expr))

    def _stmt(self, st: ast.stmt, dead: Dict[str, int]) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return  # nested defs get their own walk
        if isinstance(st, ast.Assign):
            self._expr(st.value, dead)
            # targets bind after the call: `g = eng.step(g, 1)` is the
            # safe rebind, so clearing comes second
            for t in st.targets:
                self._clear_target(t, dead)
            return
        if isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            if st.value is not None:
                self._expr(st.value, dead)
            self._clear_target(st.target, dead)
            return
        if isinstance(st, ast.If):
            self._expr(st.test, dead)
            # each branch starts from the dead set before the `if`; a
            # chain consumed in either stays dead after it (the
            # conservative direction), unless that branch leaves the
            # block (return, raise, break, continue)
            after = {}
            for branch in (st.body, st.orelse):
                d = dict(dead)
                self._block(branch, d)
                if not (branch and isinstance(branch[-1], _EXITS)):
                    after.update(d)
            dead.clear()
            dead.update(after)
            return
        if isinstance(st, ast.While):
            self._expr(st.test, dead)
            self._block(st.body, dead)
            self._block(st.orelse, dead)
            return
        if isinstance(st, ast.For):
            self._expr(st.iter, dead)
            self._clear_target(st.target, dead)
            self._block(st.body, dead)
            self._block(st.orelse, dead)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._expr(item.context_expr, dead)
                if item.optional_vars is not None:
                    self._clear_target(item.optional_vars, dead)
            self._block(st.body, dead)
            return
        if isinstance(st, ast.Try):
            self._block(st.body, dead)
            for h in st.handlers:
                self._block(h.body, dead)
            self._block(st.orelse, dead)
            self._block(st.finalbody, dead)
            return
        # expression statements, return, raise, assert, ...
        for expr in ast.iter_child_nodes(st):
            if isinstance(expr, ast.expr):
                self._expr(expr, dead)

    def _clear_target(self, target: ast.AST, dead: Dict[str, int]) -> None:
        for node in ast.walk(target):
            chain = _chain(node)
            if chain is None:
                continue
            for d in [d for d in dead
                      if d == chain or d.startswith(chain + ".")]:
                del dead[d]

    def _consumed_in(self, expr: ast.expr) -> Dict[str, int]:
        """Chains this expression hands to a consuming call (argument 0)."""
        out: Dict[str, int] = {}
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            if isinstance(f, ast.Attribute):
                consuming = (f.attr in CONSUMING_METHODS
                             and _is_engine(f.value))
            else:
                consuming = isinstance(f, ast.Name) and f.id in self.steppers
            chain = _chain(node.args[0]) if consuming else None
            if chain is not None:
                out[chain] = node.lineno
        return out

    def _check_expr(self, expr: ast.expr, dead: Dict[str, int]) -> None:
        # a comprehension's targets are names of its own, not the dead ones
        local = {n.id for c in ast.walk(expr)
                 if isinstance(c, ast.comprehension)
                 for n in ast.walk(c.target) if isinstance(n, ast.Name)}
        for node in ast.walk(expr):
            if not isinstance(node, (ast.Name, ast.Attribute)) \
                    or not isinstance(node.ctx, ast.Load):
                continue
            chain = _chain(node)
            if chain in dead and chain.split(".", 1)[0] not in local:
                self.findings.append(self.sf.finding(
                    RULE_NAME, node,
                    f"'{chain}' was consumed by an engine step on line "
                    f"{dead[chain]}: its buffer is the engine's spare, "
                    f"which the next step overwrites; rebind instead of "
                    f"re-reading it"))


def check(sf: SourceFile) -> List[Finding]:
    steppers = _collect_steppers(sf.tree)
    findings: List[Finding] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            w = _ScopeWalker(sf, steppers)
            w.walk(node)
            findings.extend(w.findings)
    return findings


RULE = Rule(
    name=RULE_NAME,
    doc="no reads of a grid after an engine step consumed it "
        "(step / step_units / step_batched / step_batched_units / a "
        "batched_stepper); rebind instead",
    file_check=check,
)
