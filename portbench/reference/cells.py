"""Life-like (radius 1) and Larger-than-Life (radius 2..7) rules on 0/1
uint8 cells, in plain PyTorch, and the packed board layout the harness
makes its inputs in.

A rule counts the live cells of the (2r+1) x (2r+1) box around a cell
(the Moore neighbourhood of range r), with the centre counted when the
rule's notation says so (Golly's ``M1``), and keeps a live cell alive
when the count lies in ``survive`` and makes a dead cell live when it
lies in ``birth``.  Two notations are read:

* ``B3/S23``: radius 1, the centre not counted (Conway's Life);
* ``R5,C0,M1,S34..58,B34..45``: Golly's Larger-than-Life notation
  (radius, states 0 or 2 for two, middle counted or not, ranges).

Packed boards: (..., rows, words) int32, bit ``j`` of word ``w`` is the
cell at column ``32 w + j``; a width that is not whole words leaves the
high bits of each row's last word as pad, which is always 0.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

WORD = 32

Intervals = Tuple[Tuple[int, int], ...]


@dataclass(frozen=True)
class Rule:
    """A two-state totalistic rule on the range-``radius`` box; counts are
    as the notation states them (the centre included when ``middle``)."""

    radius: int
    birth: Intervals
    survive: Intervals
    middle: bool


def _runs(counts) -> Intervals:
    out = []
    for c in sorted(set(counts)):
        if out and c == out[-1][1] + 1:
            out[-1] = (out[-1][0], c)
        else:
            out.append((c, c))
    return tuple(out)


def parse_rule(text: str) -> Rule:
    """The rule a ``B3/S23`` or ``R5,C0,M1,S34..58,B34..45`` string
    states; anything else raises ``ValueError``."""
    t = text.strip().upper()
    m = re.fullmatch(r"B(\d*)/S(\d*)", t)
    if m:
        return Rule(1, _runs(int(c) for c in m[1]),
                    _runs(int(c) for c in m[2]), False)
    parts = dict((p[0], p[1:]) for p in t.split(","))
    if sorted(parts) != ["B", "C", "M", "R", "S"]:
        raise ValueError(f"not a rule this reference reads: {text!r}")
    if parts["C"] not in ("0", "2") or parts["M"] not in ("0", "1"):
        raise ValueError(f"only two-state rules with M0 or M1: {text!r}")
    radius = int(parts["R"])

    def span(p: str) -> Intervals:
        lo, hi = p.split("..")
        return ((int(lo), int(hi)),)

    if not 1 <= radius <= 7:
        raise ValueError(f"radius {radius} outside 1..7: {text!r}")
    return Rule(radius, span(parts["B"]), span(parts["S"]), parts["M"] == "1")


def port_rule_text(rule: Rule) -> str:
    """The same rule in the grammar of the program under test: radius 1 as
    ``B3/S23``, a larger radius as ``R5,B34-45,S33-57``, both counting
    without the centre (a live centre lowers a survival count by one)."""
    shift = 1 if rule.middle else 0
    birth = [c for lo, hi in rule.birth for c in range(lo, hi + 1)]
    survive = [c - shift for lo, hi in rule.survive
               for c in range(lo, hi + 1) if c - shift >= 0]
    if rule.radius == 1:
        return (f"B{''.join(map(str, birth))}"
                f"/S{''.join(map(str, survive))}")

    def ranges(counts) -> str:
        return "+".join(f"{lo}-{hi}" for lo, hi in _runs(counts))

    return f"R{rule.radius},B{ranges(birth)},S{ranges(survive)}"


def words(cols: int) -> int:
    """Words a packed row of ``cols`` cells takes."""
    return -(-cols // WORD)


def unpack(packed: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 words -> (..., 32 W) uint8 cells (little-endian
    bytes, low bit first)."""
    u8 = packed.contiguous().view(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((u8.unsqueeze(-1) >> shifts) & 1).flatten(-2)


def pack(cells: torch.Tensor) -> torch.Tensor:
    """(..., C) uint8 0/1 cells -> (..., words(C)) int32, pad bits 0."""
    pad = words(cells.shape[-1]) * WORD - cells.shape[-1]
    if pad:
        cells = torch.nn.functional.pad(cells, (0, pad))
    shifts = torch.arange(8, dtype=torch.uint8, device=cells.device)
    octets = cells.unflatten(-1, (-1, 8)) << shifts
    return octets.sum(-1, dtype=torch.uint8).contiguous().view(torch.int32)


def _in(counts: torch.Tensor, intervals: Intervals) -> torch.Tensor:
    """Whether each uint8 count lies in one of ``intervals``: lo <= c <= hi
    as (c - lo) <= (hi - lo), the subtraction wrapping below lo."""
    hit = None
    for lo, hi in intervals:
        one = (counts - lo) <= (hi - lo)
        hit = one if hit is None else hit | one
    return hit if hit is not None else torch.zeros_like(counts,
                                                        dtype=torch.bool)


def _extend_cols(x: torch.Tensor, r: int, periodic: bool) -> torch.Tensor:
    if periodic:
        return torch.cat([x[..., -r:], x, x[..., :r]], dim=-1)
    return torch.nn.functional.pad(x, (r, r))


def generation(x: torch.Tensor, rule: Rule, periodic: bool,
               torus: bool = False) -> torch.Tensor:
    """One generation of the uint8 cells ``x`` (..., H, W) for its middle
    H - 2r rows: the rows above and below are the halo, consumed here.
    Columns wrap when ``periodic``, else cells past them are dead; with
    ``torus`` the rows wrap too and all H rows come back."""
    r, W = rule.radius, x.shape[-1]
    if torus:
        x = torch.cat([x[..., -r:, :], x, x[..., :r, :]], dim=-2)
    e = _extend_cols(x, r, periodic)
    across = e[..., 0:W] + e[..., 1:1 + W]
    for d in range(2, 2 * r + 1):
        across += e[..., d:d + W]
    H = x.shape[-2] - 2 * r
    counts = across[..., 0:H, :] + across[..., 1:1 + H, :]
    for d in range(2, 2 * r + 1):
        counts += across[..., d:d + H, :]
    centre = x[..., r:r + H, :]
    if not rule.middle:
        counts -= centre
    return torch.where(centre.bool(), _in(counts, rule.survive),
                       _in(counts, rule.birth)).to(torch.uint8)


def evolve_rows(x: torch.Tensor, rule: Rule, gens: int, periodic: bool,
                inside: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``gens`` generations of the block ``x`` (..., h + 2 gens r, W),
    whose outer gens x r rows on each side are its halo: the middle h
    rows.  ``inside`` (h + 2 gens r,) marks the rows that lie on the board;
    the others are held dead every generation (a dead boundary)."""
    r = rule.radius
    for _ in range(gens):
        x = generation(x, rule, periodic)
        if inside is not None:
            inside = inside[r:-r]
            x = x * inside.unsqueeze(-1).to(x.dtype)
    return x


_LOW31 = 0x7FFFFFFF


def _add8(planes):
    """The 4-bit count (bit planes, low first) of eight one-bit planes,
    by full and half adders."""
    def full(a, b, c):
        return a ^ b ^ c, (a & b) | (c & (a ^ b))

    ones_a, twos_a = full(*planes[0:3])
    ones_b, twos_b = full(*planes[3:6])
    ones_c, twos_c = planes[6] ^ planes[7], planes[6] & planes[7]
    bit0, twos_d = full(ones_a, ones_b, ones_c)
    twos, fours_a = full(twos_a, twos_b, twos_c)
    bit1, fours_b = twos ^ twos_d, twos & twos_d
    return bit0, bit1, fours_a ^ fours_b, fours_a & fours_b


def _count_in(bits, counts) -> torch.Tensor:
    """Where the 4-bit count ``bits`` equals one of ``counts``."""
    hit = torch.zeros_like(bits[0])
    for c in counts:
        eq = None
        for k, plane in enumerate(bits):
            term = plane if (c >> k) & 1 else ~plane
            eq = term if eq is None else eq & term
        hit |= eq
    return hit


def word_generation(x: torch.Tensor, rule: Rule,
                    torus: bool = False) -> torch.Tensor:
    """One generation of a radius-1 rule on packed words (..., H, W) whose
    rows are a torus of exactly 32 W cells, for the middle H - 2 rows (all
    H with ``torus``, the rows wrapping too), 32 cells an operation."""
    if torus:
        x = torch.cat([x[..., -1:, :], x, x[..., :1, :]], dim=-2)
    rows = x[..., :-2, :], x[..., 1:-1, :], x[..., 2:, :]
    planes = []
    for k, row in enumerate(rows):
        prev, nxt = torch.roll(row, 1, -1), torch.roll(row, -1, -1)
        planes.append((row << 1) | ((prev >> 31) & 1))      # column - 1
        planes.append(((row >> 1) & _LOW31) | (nxt << 31))  # column + 1
        if k != 1:
            planes.append(row)
    bits = _add8(planes)
    shift = 1 if rule.middle else 0
    survive = [c - shift for lo, hi in rule.survive
               for c in range(lo, hi + 1) if 0 <= c - shift <= 8]
    birth = [c for lo, hi in rule.birth for c in range(lo, hi + 1) if c <= 8]
    mid = rows[1]
    return (mid & _count_in(bits, survive)) | (~mid & _count_in(bits, birth))


def _evolve_block(before: torch.Tensor, r0: int, h: int, rule: Rule,
                  gens: int, cols: int, periodic: bool) -> torch.Tensor:
    """Rows [r0, r0 + h) of ``gens`` generations of the packed ``before``,
    as cells cropped to ``cols``: from those rows and a halo of gens x r
    rows on each side, or, where they are a whole torus, wrapping.  A
    radius-1 rule on a torus of whole words steps the packed words."""
    torus = periodic and h == before.shape[-2]
    if rule.radius == 1 and periodic and cols == before.shape[-1] * WORD:
        x = before if torus else _rows(before, r0, h, gens, True)[0]
        for _ in range(gens):
            x = word_generation(x, rule, torus)
        return unpack(x)
    if torus:
        x = unpack(before)[..., :cols]
        for _ in range(gens):
            x = generation(x, rule, True, torus=True)
        return x
    rows, inside = _rows(before, r0, h, gens * rule.radius, periodic)
    cells = unpack(rows)[..., :cols]
    if inside is not None:
        cells = cells * inside.unsqueeze(-1).to(cells.dtype)
    return evolve_rows(cells, rule, gens, periodic, inside)


def _rows(before: torch.Tensor, r0: int, h: int, halo: int,
          periodic: bool):
    """Rows [r0 - halo, r0 + h + halo) of the packed ``before``, and which
    of them lie on the board (None when the rows wrap)."""
    H = before.shape[-2]
    idx = torch.arange(r0 - halo, r0 + h + halo, device=before.device)
    inside = None
    if periodic:
        idx = idx % H
    else:
        inside = (idx >= 0) & (idx < H)
        idx = idx.clamp(0, H - 1)
    return before.index_select(-2, idx), inside


def evolve_packed(before: torch.Tensor, rule: Rule, gens: int, cols: int,
                  boundary: str, block_rows: int = 2048) -> torch.Tensor:
    """``gens`` generations of the packed board(s) ``before`` (..., H, W)
    of real width ``cols``, as a packed board of the same shape with its
    pad 0, computed a block of rows at a time."""
    periodic = boundary == "periodic"
    out = torch.empty_like(before)
    H = before.shape[-2]
    for r0 in range(0, H, block_rows):
        h = min(block_rows, H - r0)
        out[..., r0:r0 + h, :] = pack(
            _evolve_block(before, r0, h, rule, gens, cols, periodic))
    return out


def count_wrong(before: torch.Tensor, after: torch.Tensor, rule: Rule,
                gens: int, cols: int, boundary: str,
                block_rows: int = 2048) -> int:
    """Cells of the packed ``after`` that differ from ``gens`` generations
    of the packed ``before`` (both (..., H, W), real width ``cols``) under
    ``rule`` and ``boundary``, plus every pad bit that is set."""
    if before.shape != after.shape:
        raise ValueError(f"boards of shapes {tuple(before.shape)} and "
                         f"{tuple(after.shape)}")
    periodic = boundary == "periodic"
    H = before.shape[-2]
    wrong = 0
    for r0 in range(0, H, block_rows):
        h = min(block_rows, H - r0)
        expect = _evolve_block(before, r0, h, rule, gens, cols, periodic)
        got = unpack(after[..., r0:r0 + h, :])
        wrong += int((got[..., :cols] != expect).sum())
        wrong += int(got[..., cols:].sum())
    return wrong
