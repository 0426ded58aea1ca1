"""Bit-sliced SWAR engine for radius-r (Larger-than-Life) rules, in plain
PyTorch: the port's copy of ``mpi_tpu.ops.bitltl`` and the plain version
of kernel K3 (``ops/cuda_bitltl.py``).

The grid stays packed, 32 cells per word, and every per-cell integer is a
list of bit planes (plane k holds bit k of each cell's value, LSB first):

* **vertical sums**: a carry-save (3:2 compressor) sum of the 2r+1 row
  words gives each column's (2r+1)-cell sum as a <= 4-plane number;
* **horizontal sums**: each plane is shifted d = -r..r bits with the
  cross-word bits from the neighbouring words (``make_hshift``), and the
  2r+1 shifted sums are compressed (``bs_sum``) into the <= 8-plane total;
* **rule**: the total includes the centre cell, so the survive intervals
  are tested shifted by +1, by MSB-first bit-sliced comparators
  (``bs_ge``); the next state is ``(~mid & born) | (mid & stay)``.

Words are int32 tensors, whose bit patterns are the reference's uint32
words, so every right shift is masked: int32 ``>>`` is arithmetic.
``ltl_step`` steps the grid a block of rows at a time (each block with its
r halo rows, wrapped or zero), so a 65536² grid never holds all its planes
at once; the reference's ``_vshift`` rolls become these row slices.

The plane arithmetic is duck-typed (``& | ^ ~`` and the shift functions it
is handed), so :func:`ltl_word_ops` traces the same code into a graph and
counts the Hopper instructions of its compiled form.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from mpi_tpu_torch.config import WORD
from mpi_tpu_torch.models.rules import Rule
from mpi_tpu_torch.ops.bitlife import _map_cover, _Node

Plane = Optional[torch.Tensor]  # None encodes the constant-0 plane

# words per block of rows in ltl_step: about 40 planes of this size are live
_BLOCK_WORDS = 1 << 22


def _and(a: Plane, b: Plane) -> Plane:
    if a is None or b is None:
        return None
    return a & b


def _xor(a: Plane, b: Plane) -> Plane:
    if a is None:
        return b
    if b is None:
        return a
    return a ^ b


def _or(a: Plane, b: Plane) -> Plane:
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _full_add(x: Plane, y: Plane, z: Plane):
    """(sum, carry) of three one-bit planes; None planes drop out (z=None
    makes it a half adder)."""
    t = _xor(x, y)
    return _xor(t, z), _or(_and(x, y), _and(z, t))


def bs_add(a: List[Plane], b: List[Plane]) -> List[Plane]:
    """Ripple add two bit-sliced numbers (LSB-first plane lists)."""
    out: List[Plane] = []
    carry: Plane = None
    for i in range(max(len(a), len(b))):
        x = a[i] if i < len(a) else None
        y = b[i] if i < len(b) else None
        s, carry = _full_add(x, y, carry)
        out.append(s)
    if carry is not None:
        out.append(carry)
    return out


def bs_sum(numbers: List[List[Plane]]) -> List[Plane]:
    """Sum of many bit-sliced numbers: every weight's planes are compressed
    three at a time (3:2, carries to the next weight) until at most two
    remain, then one ripple ``bs_add`` joins the two rows."""
    buckets: dict = {}
    maxw = 0
    for num in numbers:
        for w, p in enumerate(num):
            if p is not None:
                buckets.setdefault(w, []).append(p)
                maxw = max(maxw, w)
    w = 0
    while w <= maxw:
        planes = buckets.get(w, [])
        while len(planes) >= 3:
            s, c = _full_add(planes.pop(), planes.pop(), planes.pop())
            planes.append(s)
            if c is not None:
                buckets.setdefault(w + 1, []).append(c)
                maxw = max(maxw, w + 1)
        w += 1
    a: List[Plane] = []
    b: List[Plane] = []
    for w in range(maxw + 1):
        ps = buckets.get(w, [])
        a.append(ps[0] if len(ps) > 0 else None)
        b.append(ps[1] if len(ps) > 1 else None)
    while b and b[-1] is None:
        b.pop()
    return bs_add(a, b) if b else a


def bs_ge(planes: List[Plane], t: int, zero):
    """Mask of cells whose bit-sliced value is >= the constant ``t``.
    ``zero`` is the all-zeros word (or array of words) that realises the
    constant answers.  A None *plane* is the constant-0 plane, while
    ``eq`` = None means "all cells still equal" (constant-1 mask)."""
    if t <= 0:
        return ~zero
    if t >= (1 << len(planes)):
        return zero
    gt: Plane = None  # strictly greater, decided at a higher plane
    eq: Plane = None  # still equal so far (None = all cells equal)

    def narrow(eq_mask, m):
        return m if eq_mask is None else (eq_mask & m)

    for k in reversed(range(len(planes))):
        p = planes[k]
        if (t >> k) & 1 == 0:
            if p is not None:
                gt = _or(gt, narrow(eq, p))
                eq = narrow(eq, ~p)
        else:
            if p is None:
                return gt if gt is not None else zero
            eq = narrow(eq, p)
    eq_mask = ~zero if eq is None else eq
    return eq_mask if gt is None else (gt | eq_mask)


def _in_intervals(planes: List[Plane], intervals, shift: int, zero):
    """OR of inclusive-interval tests ``lo+shift <= value <= hi+shift``."""
    acc = zero
    for lo, hi in intervals:
        m = bs_ge(planes, lo + shift, zero) \
            & ~bs_ge(planes, hi + shift + 1, zero)
        acc = acc | m
    return acc


def _funnel(p, neighbour, k: int):
    """``p`` seen from k columns away (|k| < 32): bit j of the result is
    column j + k, the bits beyond the word taken from ``neighbour`` (the
    next word for k > 0, the previous one for k < 0)."""
    if k > 0:
        return ((p >> k) & ((1 << (WORD - k)) - 1)) | (neighbour << (WORD - k))
    k = -k
    return (p << k) | ((neighbour >> (WORD - k)) & ((1 << k) - 1))


def make_hshift(v: List[Plane], word_roll, funnel=_funnel):
    """Horizontal shift family over bit-sliced planes ``v``: ``hshift(k)``
    is v shifted so bit j sees column j+k (|k| < 32), the cross-word bits
    from ``word_roll(plane, ±1)`` (the previous / next word), computed once
    and reused across all distances."""
    prev = [None if p is None else word_roll(p, 1) for p in v]
    nxt = [None if p is None else word_roll(p, -1) for p in v]

    def hshift(k: int) -> List[Plane]:
        if k == 0:
            return list(v)
        return [None if p is None else funnel(p, nw if k > 0 else pw, k)
                for p, pw, nw in zip(v, prev, nxt)]

    return hshift


def ltl_next(rows: List, word_roll, rule: Rule, zero, funnel=_funnel):
    """Next state of the middle words given the 2r+1 row words ``rows``
    (offsets 0, +1..+r, -1..-r); ``word_roll`` gives a plane's previous
    (+1) or next (-1) word along the row."""
    r = rule.radius
    v = bs_sum([[x] for x in rows])
    hshift = make_hshift(v, word_roll, funnel)
    total = bs_sum([list(v)]
                   + [hshift(d) for d in range(1, r + 1)]
                   + [hshift(-d) for d in range(1, r + 1)])
    born = _in_intervals(total, rule.birth_intervals, 0, zero)
    stay = _in_intervals(total, rule.survive_intervals, 1, zero)
    mid = rows[0]
    return (~mid & born) | (mid & stay)


def supports(shape: Tuple[int, int], rule: Rule) -> bool:
    """Packed-width shapes this engine serves (any H, any radius the rule
    system allows; radius-1 rules should prefer ``bitlife``)."""
    return shape[1] % WORD == 0 and rule.radius <= 7


def ltl_step(packed: torch.Tensor, rule: Rule,
             boundary: str = "periodic") -> torch.Tensor:
    """One generation of a radius-r rule on a packed (H, W/32) int32 grid."""
    if boundary not in ("periodic", "dead"):
        raise ValueError(f"unknown boundary {boundary!r}")
    H, NW = packed.shape
    r = rule.radius
    periodic = boundary == "periodic"

    def word_roll(x, d):
        if periodic:
            return torch.roll(x, d, dims=1)
        zero_col = torch.zeros_like(x[:, :1])
        if d == 1:
            return torch.cat([zero_col, x[:, :-1]], dim=1)
        return torch.cat([x[:, 1:], zero_col], dim=1)

    out = torch.empty_like(packed)
    step_rows = max(1, _BLOCK_WORDS // NW)
    for a in range(0, H, step_rows):
        n = min(step_rows, H - a)
        # rows [a - r, a + n + r): wrapped, or zero beyond a dead edge
        idx = torch.arange(a - r, a + n + r, device=packed.device)
        ext = packed[idx % H]
        if not periodic:
            ext[(idx < 0) | (idx >= H)] = 0
        rows = ([ext[r:r + n]]
                + [ext[r + d:r + d + n] for d in range(1, r + 1)]
                + [ext[r - d:r - d + n] for d in range(1, r + 1)])
        out[a:a + n] = ltl_next(rows, word_roll, rule, torch.zeros_like(rows[0]))
    return out


def make_ltl_stepper(rule: Rule, boundary: str = "periodic"):
    """evolve(packed, steps): ``steps`` generations, one ``ltl_step`` each."""

    def evolve(packed: torch.Tensor, steps: int) -> torch.Tensor:
        for _ in range(steps):
            packed = ltl_step(packed, rule, boundary)
        return packed

    return evolve


def row_count(x, prev, nxt, radius: int, funnel=_funnel) -> List[Plane]:
    """The live cells among columns j - r .. j + r of the row word ``x``,
    for each bit j, as bit planes: ``x`` and its 2r funnel-shifted copies
    (the bits beyond the word from the neighbouring words ``prev`` and
    ``nxt``) compressed by ``bs_sum`` into bit_length(2r+1) planes."""
    return bs_sum([[x]]
                  + [[funnel(x, nxt, d)] for d in range(1, radius + 1)]
                  + [[funnel(x, prev, -d)] for d in range(1, radius + 1)])


def slide_total(total: List[Plane], enter: List[Plane],
                leave: List[Plane]) -> List[Plane]:
    """``total + enter - leave`` on ``len(total)`` planes, as kernel K3's
    row-first form slides its window of row counts: the difference of the
    two counts (their planes and the borrow out, its sign) is added to
    ``total`` with the sign extended, modulo 2^len(total).  Exact whenever
    the true result fits the planes, as a window sum does once ``leave``
    is a count already in ``total``."""
    diff: List[Plane] = []
    borrow: Plane = None
    for e, l in zip(enter, leave):
        t = _xor(e, l)
        diff.append(_xor(t, borrow))
        # borrow out of e - l - borrow: (~e & l) | (~(e ^ l) & borrow)
        lo = None if l is None else (l if e is None else ~e & l)
        carry = None if borrow is None else (
            borrow if t is None else ~t & borrow)
        borrow = _or(lo, carry)
    diff += [borrow] * (len(total) - len(diff))
    out: List[Plane] = []
    carry = None
    for p, d in zip(total, diff):
        s, carry = _full_add(p, d, carry)
        out.append(s)
    return out


def ltl_next_row_first(rows: List, word_roll, rule: Rule, zero,
                       funnel=_funnel):
    """:func:`ltl_next` by rows first, as kernel K3's row-first form sums:
    each of the 2r+1 row words' horizontal counts (:func:`row_count`),
    then the column of counts into the neighbourhood total; the same rows
    (offsets 0, +1..+r, -1..-r) and the same next state."""
    r = rule.radius
    total = bs_sum([row_count(x, word_roll(x, 1), word_roll(x, -1), r, funnel)
                    for x in rows])
    born = _in_intervals(total, rule.birth_intervals, 0, zero)
    stay = _in_intervals(total, rule.survive_intervals, 1, zero)
    mid = rows[0]
    return (~mid & born) | (mid & stay)


# orders of the neighbourhood sum: each column's vertical sum first, then
# a horizontal sum of those (ltl_next, and kernel K3 until it summed rows
# first); or each row's horizontal count first, then a window of counts
# slid down the rows (kernel K3)
FORMS = ("vertical_first", "row_first")


def ltl_word_ops(rule: Rule, form: str = "vertical_first") -> int:
    """Hopper integer instructions (LOP3 and SHF) per word per generation
    in the compiled form of ``rule``, covered by ``_map_cover`` (the graph
    is too large for the exact ``_cover``): a valid cover, so an upper
    bound on the form's least count.

    ``vertical_first``: ``ltl_next``'s word graph, traced with the
    neighbouring words' planes as inputs (they arrive by shuffle) and each
    cross-word shift as one funnel shift; :func:`ltl_word_ops_lower`
    bounds it from below.  ``row_first``: one step of K3's row-first row
    loop, whose inputs are the entering row's word and its two neighbours
    (by shuffle), the total and the leaving row's count (registers) and
    the centre: the entering row's :func:`row_count`, :func:`slide_total`
    and the rule as ``ops/ltl_codegen.py`` compiles it."""
    graph: list = []
    shift = lambda p, nb, k: _Node(graph, (p, nb), shift=True)  # noqa: E731
    if form == "vertical_first":
        rows = [_Node(graph) for _ in range(2 * rule.radius + 1)]
        return _map_cover(ltl_next(rows, lambda p, d: _Node(graph), rule, 0,
                                   funnel=shift))
    if form != "row_first":
        raise ValueError(f"unknown form {form!r}, expected one of {FORMS}")
    from mpi_tpu_torch.ops import gates, ltl_codegen

    n = 2 * rule.radius + 1
    x, prev, nxt = (_Node(graph) for _ in range(3))
    enter = row_count(x, prev, nxt, rule.radius, shift)
    total = [_Node(graph) for _ in range(ltl_codegen.planes(rule.radius))]
    leave = [_Node(graph) for _ in range(n.bit_length())]
    total = slide_total(total, enter, leave)
    return _map_cover(gates.replay(ltl_codegen.rule_program(rule), {
        "mid": _Node(graph), **{f"T{k}": p for k, p in enumerate(total)}}))


def _bit_planes(rng, n: int, density: np.ndarray) -> List[np.ndarray]:
    """``n`` words of random cells, bit j of word i live with probability
    ``density[i, j]``, as uint32 arrays."""
    weights = np.uint32(1) << np.arange(WORD, dtype=np.uint32)
    return [((rng.random(density.shape) < density) * weights).sum(
        axis=1, dtype=np.uint32) for _ in range(n)]


def ltl_word_ops_lower(rule: Rule, words: int = 128, seed: int = 0) -> int:
    """A lower bound on the LOP3 and SHF instructions per word per
    generation of any program that sums each column's 2r+1 cells into bit
    planes first (per row, or slid from the row before) and takes the
    neighbouring words' planes by shuffle, as kernel K3 did before it
    summed rows first (``ltl_word_ops(rule, "row_first")``).

    An instruction reads at most three operands, so the instructions that
    join ``n`` values into one word number at least ceil((n - 1) / 2).
    The values are the row words at the cell's own column (a sliding
    vertical sum replaces them by the previous row's planes, the entering
    and leaving rows and the centre, and the smaller count of the two is
    taken) and the planes of the two neighbouring words' vertical sums,
    each counted once however it is shifted: a doubling horizontal sum
    shifts sums of planes, not every plane at every distance, so a count
    of one SHF per plane and distance would not bound it.  A value counts
    only where the random words of ``ltl_next`` (cells of every density,
    one column's planes changed only to another reachable sum) show that
    flipping it changes the state."""
    r = rule.radius
    rng = np.random.default_rng(seed)
    density = rng.random((words, 1)) * np.ones((1, WORD))
    zero = np.zeros(words, dtype=np.uint32)
    rows = _bit_planes(rng, 2 * r + 1, density)
    v = bs_sum([[x] for x in rows])
    # the planes k columns away: sums of independent cells
    far = {k: bs_sum([[x] for x in _bit_planes(rng, 2 * r + 1, density)])
           for k in [*range(1, r + 1), *range(-r, 0)]}
    bits = np.arange(WORD, dtype=np.uint32)
    weights = np.uint32(1) << bits

    def sums(planes):  # (words, 32) column sums of bit planes
        return sum(((p[:, None] >> bits) & 1).astype(np.int64) << i
                   for i, p in enumerate(planes) if p is not None)

    def next_state(rows, flip=None):
        planes = bs_sum([[x] for x in rows])
        index = {p.tobytes(): i for i, p in enumerate(planes) if p is not None}

        def funnel(p, nb, k):
            i = index[p.tobytes()]
            if flip != (i, k):
                return far[k][i]
            # flip bit i of the sum only where the sum stays reachable
            ok = (sums(far[k]) ^ (1 << i)) <= 2 * r + 1
            return far[k][i] ^ (ok * weights).sum(axis=1, dtype=np.uint32)

        return ltl_next(rows, lambda p, d: p, rule, zero, funnel)

    base = next_state(rows)
    # a plane of the next (previous) word matters where flipping it at some
    # distance k > 0 (k < 0) changes the state
    sides = {(i, k > 0) for k in far for i, p in enumerate(v) if p is not None
             and not np.array_equal(next_state(rows, (i, k)), base)}
    own = sum(not np.array_equal(next_state(
        [x ^ np.uint32(0xFFFFFFFF) if j == b else x
         for j, x in enumerate(rows)]), base) for b in range(len(rows)))
    own = min(own, sum(p is not None for p in v) + 3)
    return -(-(len(sides) + own - 1) // 2)
