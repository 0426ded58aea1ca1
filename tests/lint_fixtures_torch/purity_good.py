"""Clean cached-codegen idioms the traced-purity rule must NOT flag."""

import hashlib
import time


def _ops(rule):
    return [f"t{i} = lop3({rule}, {i})" for i in range(3)]


def rule_header(rule, extra=()):
    """Pure: the same rule gives the same text in every process."""
    return "\n".join([f"// {rule}", *_ops(rule), *extra])


def _rule_parts(kernel, rule, macros=None):
    h = hashlib.sha256(kernel.encode())
    for part in (rule_header(rule), repr(sorted((macros or {}).items()))):
        h.update(part.encode())
    return h.hexdigest()[:16]


def build_rules(kernel, rules):
    """Timing a build is fine: the clock's value reaches no key."""
    t0 = time.perf_counter()
    libs = [_rule_parts(kernel, r) for r in rules]
    return libs, time.perf_counter() - t0
