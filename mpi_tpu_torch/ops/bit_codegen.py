"""Kernel K1's rule, compiled per rule: a radius-1 ``Rule`` as
straight-line code over a word's shifted column sums and its three rows.

K1 (``csrc/bitlife.cu``) sums each column of a word's three rows into two
bits (``f0``, ``f1``), shifts those sums one column left and right with
the carries of the neighbouring words (``L0 L1 R0 R1``), and hands them,
with the rows ``up mid down``, to ``bit_rule``.  That function decomposes
the count as ``count = s0 + 2k``, ``k = L1 + c1 + R1 + ca`` in 0..4, and
applies the rule as ``ops/bitlife.py:compile_rule`` builds it for any
rule, from threshold indicators ``k >= v`` and a minimal function of
``(s0, mid)`` per run of ``k``; for Life, ``(k == 1) & (s0 | mid)``.

:func:`rule_program` traces all of that with the gate emitter of
``ops/gates.py`` (the compiler only uses ``& | ^`` on its operands).
:func:`rule_header` prints it twice: ``bit_rule`` as the fewest LOP3
instructions that cover the gates (``ops/bitlife.py:cover_plan``), each
written out with its truth table, which is what the kernel runs, and
``bit_rule_gates`` as the gates' ``& | ^ ~`` text, which leaves the cover
to the compiler (kept to time the two against each other).  With the two
column sums and four shifts before it, Life costs 15 LOP3 and SHF per
word (``ops/bitlife.py:word_ops``), where evaluating the rule from
run-time birth and survive masks took 52 LOP3.
"""

from __future__ import annotations

from typing import List

from mpi_tpu_torch.models.rules import Rule
from mpi_tpu_torch.ops import gates
from mpi_tpu_torch.ops.bitlife import (
    _Node, compile_rule, cover_plan, lop3_table, low_bits,
)

# the operands of ``bit_rule``, in the order of its arguments
INPUTS = ("L0", "L1", "R0", "R1", "up", "mid", "down")
# LOP3 and SHF the kernel spends on a word before it calls ``bit_rule``:
# the two column sums and their four shifts
SUMS_AND_SHIFTS = 6


def rule_program(rule: Rule) -> gates.Program:
    """The next-state word of the radius-1 ``rule`` as gates over
    :data:`INPUTS`.  A rule that never fires is the constant 0, one that
    always does the all-ones constant."""
    if rule.radius != 1:
        raise ValueError(f"K1's rule is radius 1, got radius {rule.radius}")
    em = gates._Emitter(INPUTS)
    L0, L1, R0, R1, up, mid, down = em.inputs
    s0, ca = low_bits(L0, up ^ down, R0)
    acc = compile_rule(L1, up & down, R1, ca, s0, mid, rule, em.ones,
                       lambda: em.ones)
    return gates.program(em, em.zero if acc is None else acc,
                         gates.rule_key(rule))


def lop3_plan(prog: gates.Program) -> list:
    """The fewest LOP3 that compute ``prog``: ``(out, table, operands)``
    in order, ``operands`` naming inputs or earlier outputs, ``table`` the
    8-bit truth table over them; the last one is the result.  Empty when
    the result is a constant or an input."""
    graph: list = []
    names = {}
    for name in prog.inputs:
        names[_Node(graph)] = name
    root = gates.replay(prog, {name: node for node, name in names.items()})
    plan = []
    for node, cut in cover_plan(root):
        names[node] = f"t{len(plan)}"
        plan.append((names[node], lop3_table(node, cut),
                     [names[x] for x in cut]))
    return plan


def word_cover(rule: Rule) -> int:
    """LOP3 and SHF instructions per word per generation of the code that
    is built for ``rule``: the sums and shifts in ``csrc/bitlife.cu`` and
    the LOP3 of ``bit_rule``."""
    plan = lop3_plan(rule_program(rule))
    return SUMS_AND_SHIFTS + len(plan) if plan else 0


def rule_header(rule: Rule) -> str:
    """The C++ that ``csrc/bitlife.cu`` includes for ``rule``:
    ``bit_rule(L0, L1, R0, R1, up, mid, down)`` in calls of the kernel's
    ``lop3<table>(a, b, c)``, and ``bit_rule_gates`` of the same
    operands in ``& | ^ ~``."""
    prog = rule_program(rule)
    args = ", ".join(f"uint32_t {name}" for name in INPUTS)
    plan = lop3_plan(prog)
    lines: List[str] = [
        f"// {prog.key}: generated by mpi_tpu_torch/ops/bit_codegen.py",
        f"__device__ __forceinline__ uint32_t bit_rule({args}) {{"]
    for out, table, operands in plan:
        a, b, c = (operands + operands[-1:] * 2)[:3]  # unused ones repeat
        lines.append(f"  const uint32_t {out} = "
                     f"lop3<0x{table:02X}>({a}, {b}, {c});")
    result = plan[-1][0] if plan else {
        gates.ZERO: "0u", gates.ONES: "0xFFFFFFFFu"}.get(prog.result,
                                                         prog.result)
    lines += [f"  return {result};", "}",
              *gates.function_source(prog, f"bit_rule_gates({args})"), ""]
    return "\n".join(lines)
