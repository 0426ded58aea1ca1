"""``ctxvar-hop`` — no rid-reading code launched on a bare thread hop.

The request id travels in a ``ContextVar`` (``obs.trace.REQUEST_ID``);
``Thread(target=...)`` and ``executor.submit(...)`` start the callee in
an EMPTY context, so a callee that reads the rid gets ``None`` and its
spans/metrics silently detach from the request.  The serve layer avoids
this two ways, both of which this rule recognizes as safe:

* wrapping the hop with ``contextvars.copy_context()`` and launching
  ``ctx.run(...)`` (the watchdog pattern in ``serve/session.py``);
* stashing the rid eagerly and re-installing it in the callee with
  ``set_request_id(...)`` (the ``Ticket.rid`` / ``_Entry.rid``
  pattern in ``serve/ticket.py`` / ``serve/batch.py``).

Detection: for every ``X.submit(f, ...)`` / ``Thread(target=f)`` site,
resolve ``f`` to a same-module def/lambda/method by simple name.  If
the callee (transitively, intra-module) reads the contextvar —
``current_request_id()`` or ``REQUEST_ID.get()`` — and neither the
launch site's function mentions ``copy_context`` nor the callee chain
re-installs with ``set_request_id``, that hop drops the rid: finding.
Unresolvable callees (cross-module attributes) are out of scope.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from mpi_tpu_torch.analysis import Finding, Rule, SourceFile

RULE_NAME = "ctxvar-hop"

_READS = ("current_request_id", "REQUEST_ID.get")
_RESTORES = ("set_request_id",)


def _dump(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return ast.dump(node)


def _fn_index(tree: ast.AST) -> Dict[str, ast.AST]:
    """Simple-name index of every def (methods included, unqualified —
    launch sites resolve ``self.f`` and plain ``f`` alike)."""
    out: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
    return out


def _dotted(node: ast.AST) -> Optional[str]:
    """Fold a Name/Attribute chain to "a.b.c" without ast.unparse —
    the hot path (every Call in the tree goes through here); non-chain
    expressions (calls, subscripts) return None and never match."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _mentions(fn: ast.AST, needles) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if d is not None \
                    and any(d == n or d.endswith("." + n) for n in needles):
                return True
        elif isinstance(node, ast.Name) and node.id in needles:
            return True
    return False


def _reads_rid(fn: ast.AST, index: Dict[str, ast.AST],
               seen: Optional[Set[int]] = None) -> bool:
    """True if fn (or a same-module callee) reads the rid contextvar
    WITHOUT re-installing it first (set_request_id in the chain means
    the caller stashed the rid eagerly — the safe explicit pattern)."""
    seen = seen if seen is not None else set()
    if id(fn) in seen:
        return False
    seen.add(id(fn))
    if _mentions(fn, _RESTORES):
        return False
    if _mentions(fn, _READS):
        return True
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            callee = index.get(node.func.id)
            if callee is not None and _reads_rid(callee, index, seen):
                return True
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "self":
            callee = index.get(node.func.attr)
            if callee is not None and _reads_rid(callee, index, seen):
                return True
    return False


def _resolve_callee(arg: ast.AST, index: Dict[str, ast.AST],
                    local_lambdas: Dict[str, ast.Lambda]) -> Optional[ast.AST]:
    if isinstance(arg, ast.Name):
        if arg.id in local_lambdas:
            return local_lambdas[arg.id]
        return index.get(arg.id)
    if isinstance(arg, ast.Attribute) and isinstance(arg.value, ast.Name) \
            and arg.value.id == "self":
        return index.get(arg.attr)
    if isinstance(arg, ast.Lambda):
        return arg
    return None


def _hop_sites(fn: ast.AST):
    """(call_node, callee_expr) for every thread/executor hop in fn."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) and node.func.attr == "submit":
            if node.args:
                yield node, node.args[0]
        elif (isinstance(node.func, ast.Name) and node.func.id == "Thread") \
                or (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "Thread"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "threading"):
            for kw in node.keywords:
                if kw.arg == "target":
                    yield node, kw.value


def check(sf: SourceFile) -> List[Finding]:
    index = _fn_index(sf.tree)
    findings: List[Finding] = []
    for fn in ast.walk(sf.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        sites = list(_hop_sites(fn))
        if not sites:
            continue                    # hop-free fn: skip the scans
        # copy_context anywhere in the launching function blesses its
        # hops: the watchdog builds ctx once and runs everything in it
        launcher_wraps = _mentions(fn, ("copy_context", "ctx.run"))
        local_lambdas: Dict[str, ast.Lambda] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Lambda):
                local_lambdas[node.targets[0].id] = node.value
        for call, callee_expr in sites:
            if launcher_wraps:
                continue
            callee = _resolve_callee(callee_expr, index, local_lambdas)
            if callee is None:
                continue
            if _reads_rid(callee, index):
                findings.append(sf.finding(
                    RULE_NAME, call,
                    f"thread hop launches '{_dump(callee_expr)}', which "
                    f"reads the rid contextvar — wrap with "
                    f"copy_context() or stash the rid and "
                    f"set_request_id() in the callee"))
    return findings


RULE = Rule(
    name=RULE_NAME,
    doc="Thread/submit hops into rid-reading code must copy_context or "
        "stash-and-set_request_id",
    file_check=check,
)
