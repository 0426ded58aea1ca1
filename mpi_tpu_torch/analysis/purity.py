"""``traced-purity`` — no host side effects in code whose result is cached.

The reference's rule roots at ``jax.jit`` / ``shard_map`` /
``pallas_call``: a traced function runs ONCE at trace time, so anything
impure inside it bakes one stale value into the compiled program.  The
port has no tracer, but it has the same trap: a kernel library is built
once per rule and cached on disk under a hash of what went into it
(``ops/_build.py:_rule_parts``), and the rule's code is the header that
``importlib.import_module(kernel.codegen).rule_header(rule)`` emits
(``ops/bit_codegen.py``, ``ops/ltl_codegen.py``).  A wall-clock read or
a host random draw there either bakes one stale value into a cached
``.so`` (when it reaches the code but not the key) or changes the key on
every process, so the cache never hits and every start rebuilds.

Roots are collected per module:

* every def named ``rule_header`` (the codegen modules' contract);
* every def that calls ``rule_header`` (``name(...)`` or
  ``<x>.rule_header(...)``): the function that hashes the header, the
  rule's key and its macros into the library's name;
* local ``def``s nested inside a rooted function.

Reachability is the reference's intra-module call graph on simple names
(calls through attributes/containers are invisible — the fixtures pin
what is and is not caught).  On every reachable function the rule flags:

* calls whose target dumps as ``time.*``, ``random.*``, ``np.random.*``
  / ``numpy.random.*``, or builtin ``open``/``print``/``input``;
* mutable default argument values (list/dict/set displays or
  ``list()``/``dict()``/``set()`` calls).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from mpi_tpu_torch.analysis import Finding, Rule, SourceFile

RULE_NAME = "traced-purity"

ROOT_NAME = "rule_header"
_IMPURE_PREFIXES = ("time.", "random.", "np.random.", "numpy.random.")
_IMPURE_BUILTINS = {"open", "print", "input"}


def _dump(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return ast.dump(node)


def _all_defs(tree: ast.AST) -> Dict[str, List[ast.AST]]:
    out: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    return out


def _calls_root(fn: ast.AST) -> bool:
    """Whether ``fn`` calls ``rule_header`` (by name or as an attribute)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Name) and f.id == ROOT_NAME) or (
                    isinstance(f, ast.Attribute) and f.attr == ROOT_NAME):
                return True
    return False


def _roots(tree: ast.AST) -> Set[str]:
    return {node.name for node in ast.walk(tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and (node.name == ROOT_NAME or _calls_root(node))}


def _calls_in(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            out.add(node.func.id)
    return out


def _reachable(tree: ast.AST) -> Dict[str, ast.AST]:
    defs = _all_defs(tree)
    seen: Set[str] = set()
    frontier = list(_roots(tree) & set(defs))
    reach: Dict[str, ast.AST] = {}
    while frontier:
        name = frontier.pop()
        if name in seen:
            continue
        seen.add(name)
        for fn in defs[name]:
            reach[name] = fn
            # nested defs of a rooted function run with it
            for node in ast.walk(fn):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and node is not fn and node.name not in seen:
                    frontier.append(node.name)
            for callee in _calls_in(fn):
                if callee in defs and callee not in seen:
                    frontier.append(callee)
    return reach


def _mutable_default(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    return isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
        and node.func.id in ("list", "dict", "set")


def check(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    flagged: Set[int] = set()   # dedupe: a def reachable via two paths
    for name, fn in sorted(_reachable(sf.tree).items()):
        if fn.lineno in flagged:
            continue
        flagged.add(fn.lineno)
        args = fn.args
        for default in list(args.defaults) + \
                [d for d in args.kw_defaults if d is not None]:
            if _mutable_default(default):
                findings.append(sf.finding(
                    RULE_NAME, default,
                    f"mutable default argument on '{name}', which is "
                    f"reachable from a cached rule header or its key — "
                    f"state survives across builds"))
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = _dump(node.func)
            if any(d.startswith(p) for p in _IMPURE_PREFIXES) \
                    or d in _IMPURE_BUILTINS:
                findings.append(sf.finding(
                    RULE_NAME, node,
                    f"impure call '{d}' inside '{name}', which is "
                    f"reachable from a cached rule header or its key — "
                    f"its value is baked into a cached kernel library "
                    f"(or defeats the cache on every process)"))
    return findings


RULE = Rule(
    name=RULE_NAME,
    doc="no time/random/np.random/file-I/O calls or mutable defaults in "
        "functions reachable from a rule_header or the code hashing it",
    file_check=check,
)
