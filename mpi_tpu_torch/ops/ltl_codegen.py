"""Kernel K3's rule, compiled per rule: a ``Rule`` as straight-line code
over the bit planes of the neighbourhood total.

K3 (``csrc/bitltl.cu``) sums each cell's (2r+1)² neighbourhood, centre
included, into P bit planes, P = bit_length((2r+1)²), and the next state
is ``(~mid & born) | (mid & stay)``, where ``born`` is the birth set as a
function of the total and ``stay`` the survive set shifted by one (the
total counts the live centre).  With the rule known, each is a fixed
boolean function of the P planes: :func:`rule_program` splits its truth
table on the planes from the top (a multiplexer, one LOP3, per split),
folding constant halves and sharing equal ones, through constant-folding,
hash-consed symbols.  Bosco's rule takes 31 gates (9 LOP3) where the
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

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from mpi_tpu_torch.models.rules import Rule
from mpi_tpu_torch.ops.bitlife import _map_cover, _Node

# operand names of the constants; inputs are "T0".."T{P-1}" and "mid"
ZERO, ONES = "0", "~0"


def planes(radius: int) -> int:
    """Bit planes of the neighbourhood total, centre included."""
    return ((2 * radius + 1) ** 2).bit_length()


def rule_key(rule: Rule) -> str:
    """The rule's canonical text: radius, then birth and survive counts as
    inclusive runs, e.g. ``R5,B34-45,S33-57``.  Rules with equal counts
    and radius share it whatever their names."""
    def runs(intervals):
        return "+".join(f"{lo}-{hi}" if hi > lo else f"{lo}"
                        for lo, hi in intervals)

    return (f"R{rule.radius},B{runs(rule.birth_intervals)},"
            f"S{runs(rule.survive_intervals)}")


class _Sym:
    """A traced word: a constant, an input, or a gate of the program."""

    def __init__(self, em: "_Emitter", name: str):
        self.em, self.name = em, name

    def __and__(self, other):
        return self.em.gate("&", self, other)

    def __or__(self, other):
        return self.em.gate("|", self, other)

    def __xor__(self, other):
        return self.em.gate("^", self, other)

    def __invert__(self):
        return self.em.gate("~", self)


class _Emitter:
    """Records gates, folding constants and reusing equal gates."""

    def __init__(self, nplanes: int):
        self.ops: List[Tuple[str, str, str, str]] = []  # (out, op, a, b)
        self.memo: dict = {}
        self.negated: dict = {}  # out of a "~" gate -> its operand
        self.zero, self.ones = _Sym(self, ZERO), _Sym(self, ONES)
        self.inputs = [_Sym(self, f"T{k}") for k in range(nplanes)]
        self.mid = _Sym(self, "mid")

    def gate(self, op: str, a: _Sym, b: _Sym = None) -> _Sym:
        if op == "~":
            if a.name in (ZERO, ONES):
                return self.ones if a.name == ZERO else self.zero
            if a.name in self.negated:
                return self.negated[a.name]
        else:
            names = {a.name, b.name}
            if a.name == b.name:
                return self.zero if op == "^" else a
            if op == "&" and ZERO in names or op == "|" and ONES in names:
                return self.zero if op == "&" else self.ones
            if op in "&|" and (ONES if op == "&" else ZERO) in names:
                return b if a.name in (ZERO, ONES) else a
            if op == "^" and ZERO in names:
                return b if a.name == ZERO else a
            if op == "^" and ONES in names:
                return ~(b if a.name == ONES else a)
            a, b = sorted((a, b), key=lambda s: s.name)  # commutative
        key = (op, a.name, b.name if b is not None else "")
        if key not in self.memo:
            out = f"t{len(self.ops)}"
            self.ops.append((out, *key))
            self.memo[key] = _Sym(self, out)
            if op == "~":
                self.negated[out] = a
        return self.memo[key]


@dataclass(frozen=True)
class Program:
    """Straight-line gates ``(out, op, a, b)`` over the inputs T0..T{P-1}
    (the total's planes, LSB first) and ``mid``; ``result`` names the
    next-state word."""

    key: str
    nplanes: int
    ops: Tuple[Tuple[str, str, str, str], ...]
    result: str


def rule_program(rule: Rule) -> Program:
    """The next-state word of ``rule`` as gates over the total's planes:
    the birth and survive truth tables over every total, each split on
    the highest plane into the functions of its two halves (equal halves
    shared, constant ones folded), then ``(~mid & born) | (mid & stay)``.
    Totals no cell can have (above (2r+1)², or 0 with a live centre) are
    taken as dead."""
    em = _Emitter(planes(rule.radius))
    top = (2 * rule.radius + 1) ** 2
    memo: dict = {}

    def split(table: tuple) -> _Sym:
        if table not in memo:
            if min(table) == max(table):
                memo[table] = em.ones if table[0] else em.zero
            else:
                half = len(table) // 2
                lo, hi = split(table[:half]), split(table[half:])
                c = em.inputs[half.bit_length() - 1]
                memo[table] = hi if hi is lo else (c & hi) | (~c & lo)
        return memo[table]

    totals = range(1 << len(em.inputs))
    born = split(tuple(t <= top and t in rule.birth for t in totals))
    stay = split(tuple(1 <= t <= top and t - 1 in rule.survive
                       for t in totals))
    nxt = (~em.mid & born) | (em.mid & stay)
    by_out = {op[0]: op for op in em.ops}
    live, todo = set(), [nxt.name]
    while todo:
        name = todo.pop()
        if name in by_out and name not in live:
            live.add(name)
            todo += [x for x in by_out[name][2:] if x]
    return Program(rule_key(rule), len(em.inputs),
                   tuple(op for op in em.ops if op[0] in live), nxt.name)


def evaluate(prog: Program, total: List[np.ndarray], mid: np.ndarray):
    """Run ``prog`` on uint32 words: ``total`` its planes, LSB first."""
    ones = np.full_like(mid, 0xFFFFFFFF)
    env = {ZERO: np.zeros_like(mid), ONES: ones, "mid": mid}
    env.update({f"T{k}": p for k, p in enumerate(total)})
    for out, op, a, b in prog.ops:
        x = env[a]
        env[out] = (~x if op == "~" else x & env[b] if op == "&"
                    else x | env[b] if op == "|" else x ^ env[b])
    return env[prog.result]


def lop3_count(prog: Program) -> int:
    """LOP3 instructions that cover the program (``_map_cover``)."""
    graph: list = []
    env = {f"T{k}": _Node(graph) for k in range(prog.nplanes)}
    env["mid"] = _Node(graph)
    for out, op, a, b in prog.ops:
        kids = [env[x] for x in (a, b) if x and x not in (ZERO, ONES)]
        env[out] = _Node(graph, tuple(kids))
    return _map_cover(env.get(prog.result))


def rule_header(rule: Rule) -> str:
    """The C++ that ``csrc/bitltl.cu`` includes for ``rule``:
    ``LTL_RULE_PLANES`` and ``ltl_rule(T, mid)``."""
    prog = rule_program(rule)

    def operand(x: str) -> str:
        return {ZERO: "0u", ONES: "0xFFFFFFFFu"}.get(
            x, f"T[{x[1:]}]" if x.startswith("T") else x)

    lines = [f"// {prog.key}: generated by mpi_tpu_torch/ops/ltl_codegen.py",
             f"#define LTL_RULE_PLANES {prog.nplanes}",
             "__device__ __forceinline__ uint32_t ltl_rule(const uint32_t* T, "
             "uint32_t mid) {"]
    for out, op, a, b in prog.ops:
        expr = (f"~{operand(a)}" if op == "~"
                else f"{operand(a)} {op} {operand(b)}")
        lines.append(f"  const uint32_t {out} = {expr};")
    lines += [f"  return {operand(prog.result)};", "}", ""]
    return "\n".join(lines)
