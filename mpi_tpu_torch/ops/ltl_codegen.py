"""Kernel K3's rule, compiled per rule: a ``Rule`` as straight-line code
over the bit planes of the neighbourhood total.

K3 (``csrc/bitltl.cu``) sums each cell's (2r+1)² neighbourhood, centre
included, into P bit planes, P = bit_length((2r+1)²), and the next state
is ``(~mid & born) | (mid & stay)``, where ``born`` is the birth set as a
function of the total and ``stay`` the survive set shifted by one (the
total counts the live centre).  With the rule known, each is a fixed
boolean function of the P planes: :func:`rule_program` splits its truth
table on the planes from the top (a multiplexer, one LOP3, per split),
folding constant halves and sharing equal ones, through the
constant-folding, gate-sharing emitter of ``ops/gates.py`` (which K1's
rule uses too).  Bosco's rule takes 31 gates (9 LOP3) where the
bit-sliced interval tests of ``ops/bitltl.py`` with folded thresholds
take 41 (17 LOP3); the splits of a set are bounded by its table's size
whatever its intervals, where the interval tests grow with each interval
(about 1000 gates for a random radius-7 rule, against at most 245 here,
and the larger ones spilled registers in K3).  :func:`rule_header` prints the
program as the C++ function ``ltl_rule`` that ``bitltl.cu`` includes;
:func:`evaluate` runs it on numpy words, which is how the tests hold it
against the interval tests.
"""

from __future__ import annotations

from typing import List

import numpy as np

from mpi_tpu_torch.models.rules import Rule
from mpi_tpu_torch.ops import gates
from mpi_tpu_torch.ops.gates import (  # noqa: F401  (K3's names for them)
    ONES, ZERO, Program, lop3_count, rule_key,
)


def planes(radius: int) -> int:
    """Bit planes of the neighbourhood total, centre included."""
    return ((2 * radius + 1) ** 2).bit_length()


def rule_program(rule: Rule) -> Program:
    """The next-state word of ``rule`` as gates over the total's planes
    T0..T{P-1} (LSB first) and ``mid``: the birth and survive truth tables over every total, each split on
    the highest plane into the functions of its two halves (equal halves
    shared, constant ones folded), then ``(~mid & born) | (mid & stay)``.
    Totals no cell can have (above (2r+1)², or 0 with a live centre) are
    taken as dead."""
    nplanes = planes(rule.radius)
    em = gates._Emitter([f"T{k}" for k in range(nplanes)] + ["mid"])
    total, mid = em.inputs[:nplanes], em.inputs[nplanes]
    top = (2 * rule.radius + 1) ** 2
    memo: dict = {}

    def split(table: tuple):
        if table not in memo:
            if min(table) == max(table):
                memo[table] = em.ones if table[0] else em.zero
            else:
                half = len(table) // 2
                lo, hi = split(table[:half]), split(table[half:])
                c = total[half.bit_length() - 1]
                memo[table] = hi if hi is lo else (c & hi) | (~c & lo)
        return memo[table]

    totals = range(1 << nplanes)
    born = split(tuple(t <= top and t in rule.birth for t in totals))
    stay = split(tuple(1 <= t <= top and t - 1 in rule.survive
                       for t in totals))
    return gates.program(em, (~mid & born) | (mid & stay), rule_key(rule))


def evaluate(prog: Program, total: List[np.ndarray], mid: np.ndarray):
    """Run ``prog`` on uint32 words: ``total`` its planes, LSB first."""
    return gates.evaluate(prog, {"mid": mid, **{
        f"T{k}": p for k, p in enumerate(total)}})


def rule_header(rule: Rule) -> str:
    """The C++ that ``csrc/bitltl.cu`` includes for ``rule``:
    ``LTL_RULE_PLANES`` and ``ltl_rule(T, mid)``."""
    prog = rule_program(rule)
    body = gates.function_source(
        prog, "ltl_rule(const uint32_t* T, uint32_t mid)",
        lambda x: f"T[{x[1:]}]" if x.startswith("T") else x)
    return "\n".join([
        f"// {prog.key}: generated by mpi_tpu_torch/ops/ltl_codegen.py",
        f"#define LTL_RULE_PLANES {len(prog.inputs) - 1}", *body, ""])
