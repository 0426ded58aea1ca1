"""Rules as straight-line code: the gate emitter that the per-rule kernels
share.

Kernels K1 (``csrc/bitlife.cu``) and K3 (``csrc/bitltl.cu``) are built
once per rule, with the rule's next-state function compiled in as a C++
function of a few 32-bit words.  A rule compiler that only uses ``& | ^ ~``
on its operands is traced by handing it :class:`_Sym` operands of an
:class:`_Emitter`, which records each gate once (equal gates are shared,
constants are folded); :func:`program` keeps the gates the result needs,
:func:`function_source` prints them as C++, :func:`evaluate` runs them on
numpy words (how the tests hold a program against the rule), and
:func:`lop3_count` counts the LOP3 instructions that cover them.
``ops/bit_codegen.py`` traces K1's rule and ``ops/ltl_codegen.py`` K3's;
:func:`rule_key` names the library either is built into.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from mpi_tpu_torch.models.rules import Rule
from mpi_tpu_torch.ops.bitlife import _map_cover, _Node

# operand names of the constants
ZERO, ONES = "0", "~0"


def rule_key(rule: Rule) -> str:
    """The rule's canonical text: radius, then birth and survive counts as
    inclusive runs, e.g. ``R5,B34-45,S33-57`` or, for Life, ``R1,B3,S2-3``.
    Rules with equal counts and radius share it whatever their names."""
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
    """Records gates over the named inputs, folding constants and reusing
    equal gates."""

    def __init__(self, inputs: Sequence[str]):
        self.ops: List[Tuple[str, str, str, str]] = []  # (out, op, a, b)
        self.memo: dict = {}
        self.negated: dict = {}  # out of a "~" gate -> its operand
        self.zero, self.ones = _Sym(self, ZERO), _Sym(self, ONES)
        self.inputs = [_Sym(self, name) for name in inputs]

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
    """Straight-line gates ``(out, op, a, b)`` over the named ``inputs``;
    ``result`` names the next-state word (a gate, an input or a
    constant)."""

    key: str
    inputs: Tuple[str, ...]
    ops: Tuple[Tuple[str, str, str, str], ...]
    result: str


def program(em: _Emitter, result: _Sym, key: str) -> Program:
    """The gates of ``em`` that ``result`` needs, in order."""
    by_out = {op[0]: op for op in em.ops}
    live, todo = set(), [result.name]
    while todo:
        name = todo.pop()
        if name in by_out and name not in live:
            live.add(name)
            todo += [x for x in by_out[name][2:] if x]
    return Program(key, tuple(s.name for s in em.inputs),
                   tuple(op for op in em.ops if op[0] in live), result.name)


def evaluate(prog: Program, env: Dict[str, np.ndarray]) -> np.ndarray:
    """Run ``prog`` on uint32 words: ``env`` maps each input's name to its
    words."""
    like = next(iter(env.values()))
    env = {ZERO: np.zeros_like(like), ONES: np.full_like(like, 0xFFFFFFFF),
           **env}
    for out, op, a, b in prog.ops:
        x = env[a]
        env[out] = (~x if op == "~" else x & env[b] if op == "&"
                    else x | env[b] if op == "|" else x ^ env[b])
    return env[prog.result]


def replay(prog: Program, env: dict):
    """Run ``prog`` on any operands that define ``& | ^ ~`` (traced nodes,
    tensors); a constant operand is the int 0 or -1.  Returns the result,
    or the int when it is a constant."""
    env = {ZERO: 0, ONES: -1, **env}
    for out, op, a, b in prog.ops:
        x = env[a]
        env[out] = (~x if op == "~" else x & env[b] if op == "&"
                    else x | env[b] if op == "|" else x ^ env[b])
    return env[prog.result]


def lop3_count(prog: Program) -> int:
    """LOP3 instructions that cover the program (``_map_cover``)."""
    graph: list = []
    return _map_cover(replay(prog, {name: _Node(graph)
                                    for name in prog.inputs}))


def function_source(prog: Program, signature: str, operand=None) -> List[str]:
    """The program as the lines of one C++ device function with the given
    ``signature`` (e.g. ``bit_rule(uint32_t a, uint32_t b)``).  ``operand``
    maps an input's name to the C++ expression that reads it (default: the
    name itself)."""
    def expr(x: str) -> str:
        if x in (ZERO, ONES):
            return "0u" if x == ZERO else "0xFFFFFFFFu"
        return operand(x) if operand and x in prog.inputs else x

    lines = [f"__device__ __forceinline__ uint32_t {signature} {{"]
    for out, op, a, b in prog.ops:
        rhs = f"~{expr(a)}" if op == "~" else f"{expr(a)} {op} {expr(b)}"
        lines.append(f"  const uint32_t {out} = {rhs};")
    return lines + [f"  return {expr(prog.result)};", "}"]
