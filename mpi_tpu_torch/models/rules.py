"""Outer-totalistic cellular-automaton rules over a Moore neighbourhood.

A rule is data: the neighbour counts on which a dead cell is born, the
counts on which a live cell survives, and the neighbourhood radius.  The
count excludes the centre cell, so a radius-r rule sees (2r+1)² − 1
neighbours.  The grammar and the errors of :func:`rule_from_name` are those
of ``mpi_tpu.models.rules``, so a rule string means the same thing to both
packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Tuple


def _intervals(counts: Iterable[int]) -> Tuple[Tuple[int, int], ...]:
    """Sorted, inclusive (lo, hi) runs of a set of counts: the form in
    which the dense and bit-sliced engines test a rule."""
    s = sorted(set(int(c) for c in counts))
    if not s:
        return ()
    out: List[Tuple[int, int]] = []
    lo = hi = s[0]
    for c in s[1:]:
        if c == hi + 1:
            hi = c
        else:
            out.append((lo, hi))
            lo = hi = c
    out.append((lo, hi))
    return tuple(out)


@dataclass(frozen=True)
class Rule:
    """Born on counts in ``birth``, stays alive on counts in ``survive``,
    over a radius-``radius`` Moore neighbourhood."""

    name: str
    birth: frozenset = field(default_factory=frozenset)
    survive: frozenset = field(default_factory=frozenset)
    radius: int = 1

    def __post_init__(self):
        object.__setattr__(self, "birth", frozenset(int(b) for b in self.birth))
        object.__setattr__(self, "survive", frozenset(int(s) for s in self.survive))
        nmax = self.max_count
        if self.radius < 1:
            raise ValueError(f"radius must be >= 1, got {self.radius}")
        if self.radius > 7:
            # the dense engines count neighbours in uint8: r=7 gives at most
            # 224, r=8 would give 288 and wrap
            raise ValueError(
                f"radius must be <= 7 (uint8 count accumulators), got {self.radius}"
            )
        for c in self.birth | self.survive:
            if not (0 <= c <= nmax):
                raise ValueError(
                    f"rule {self.name!r}: count {c} out of range [0, {nmax}] "
                    f"for radius {self.radius}"
                )

    @property
    def max_count(self) -> int:
        """Largest possible neighbour count: (2r+1)² − 1."""
        side = 2 * self.radius + 1
        return side * side - 1

    @property
    def birth_intervals(self) -> Tuple[Tuple[int, int], ...]:
        return _intervals(self.birth)

    @property
    def survive_intervals(self) -> Tuple[Tuple[int, int], ...]:
        return _intervals(self.survive)

    @property
    def birth_mask(self) -> int:
        """Bit c set iff a dead cell with c neighbours is born."""
        return sum(1 << c for c in self.birth)

    @property
    def survive_mask(self) -> int:
        """Bit c set iff a live cell with c neighbours survives."""
        return sum(1 << c for c in self.survive)

    def tables(self):
        """(birth_table, survive_table) as length-(max_count+1) uint8 numpy
        arrays, indexed by neighbour count."""
        import numpy as np

        n = self.max_count + 1
        bt = np.zeros(n, dtype=np.uint8)
        st = np.zeros(n, dtype=np.uint8)
        for c in self.birth:
            bt[c] = 1
        for c in self.survive:
            st[c] = 1
        return bt, st

    def __str__(self) -> str:
        b = "".join(str(c) for c in sorted(self.birth)) if self.radius == 1 else repr(sorted(self.birth))
        s = "".join(str(c) for c in sorted(self.survive)) if self.radius == 1 else repr(sorted(self.survive))
        return f"{self.name} (B{b}/S{s}, r={self.radius})"


LIFE = Rule("life", frozenset({3}), frozenset({2, 3}))
HIGHLIFE = Rule("highlife", frozenset({3, 6}), frozenset({2, 3}))
SEEDS = Rule("seeds", frozenset({2}), frozenset())
DAY_AND_NIGHT = Rule("daynight", frozenset({3, 6, 7, 8}), frozenset({3, 4, 6, 7, 8}))

# Larger-than-Life "Bosco's rule", radius 5.  Its usual statement counts the
# centre (born 34..45, survive 34..58 of 121); with the centre excluded,
# survival shifts down by one.
BOSCO = Rule("bosco", frozenset(range(34, 46)), frozenset(range(33, 58)), radius=5)

_REGISTRY = {r.name: r for r in (LIFE, HIGHLIFE, SEEDS, DAY_AND_NIGHT, BOSCO)}


def rule_from_name(name: str) -> Rule:
    """A built-in rule, a radius-1 'B3/S23' / 'B36/S23' string, or a
    Larger-than-Life 'R5,B34-45,S33-57' string."""
    key = name.lower()
    if key in _REGISTRY:
        return _REGISTRY[key]
    if key.startswith("b") and "/s" in key:
        bpart, spart = key[1:].split("/s", 1)
        return Rule(
            name,
            frozenset(int(ch) for ch in bpart if ch.isdigit()),
            frozenset(int(ch) for ch in spart if ch.isdigit()),
        )
    if key.startswith("r") and ",b" in key:
        try:
            rpart, bpart, spart = key.split(",")
            radius = int(rpart[1:])

            def parse_range(p: str) -> frozenset:
                p = p[1:]  # strip the leading b/s
                out = set()
                for piece in p.split("+"):
                    if "-" in piece:
                        lo, hi = piece.split("-")
                        out.update(range(int(lo), int(hi) + 1))
                    elif piece:
                        out.add(int(piece))
                return frozenset(out)

            return Rule(name, parse_range(bpart), parse_range(spart), radius=radius)
        except (ValueError, IndexError) as e:
            raise ValueError(f"cannot parse rule string {name!r}") from e
    raise ValueError(
        f"unknown rule {name!r}; built-ins: {sorted(_REGISTRY)}; "
        "or use 'B3/S23' / 'R5,B34-45,S33-57' syntax"
    )
