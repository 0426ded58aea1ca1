"""Bit-packed (SWAR) Life for radius-1 B/S rules: 32 cells per word,
bit-parallel neighbour counting, in plain PyTorch.

Layout: (H, W) cells → (H, W/32) words; bit ``j`` of word ``w`` is the cell
at column ``32·w + j``.  The port holds words as **int32** tensors, whose
bit patterns are the reference's uint32 words (torch lacks uint32 shifts,
comparisons and addition), so every right shift here is masked: int32
``>>`` is arithmetic.

The arithmetic is that of ``mpi_tpu.ops.bitlife``:

* carry-save column sums over the three row words: the full 2-bit sum
  ``f = up + mid + down`` for the side columns and the centre-excluded
  ``c = up + down`` for the centre column;
* the left/right columns are the sums shifted by one bit, with the carry
  bit taken from the neighbouring word along the row;
* ``count = s0 + 2k`` with ``s0`` the weight-1 parity and
  ``k = L1 + c1 + R1 + carry`` in 0..4, so any rule is a symmetric
  function of four addends; the rule compiler builds threshold indicators
  ``k >= v`` and a minimal function of (s0, alive) per run of k.

This module is the plain version of kernel K1 (``ops/cuda_bitlife.py``)
and the CPU path of the engine.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mpi_tpu_torch.config import WORD
from mpi_tpu_torch.models.rules import LIFE, Rule
from mpi_tpu_torch.utils.hashinit import i32_bits, init_tile_torch

_FULL = -1            # all 32 bits set, as an int32
_LOW31 = 0x7FFFFFFF   # mask after an arithmetic >> 1


def packable(shape: Tuple[int, int], rule: Rule) -> bool:
    return rule.radius == 1 and shape[1] % WORD == 0


def pack(grid: torch.Tensor) -> torch.Tensor:
    """(H, W) uint8 0/1 → (H, W/32) int32 words, LSB = lowest column.
    The sum runs in int64: bit 31 would overflow an int32 sum."""
    H, W = grid.shape
    if W % WORD:
        raise ValueError(f"width {W} not a multiple of {WORD}")
    bits = grid.reshape(H, W // WORD, WORD).to(torch.int64)
    shifts = torch.arange(WORD, dtype=torch.int64, device=grid.device)
    return i32_bits((bits << shifts).sum(dim=-1))


def unpack(packed: torch.Tensor) -> torch.Tensor:
    """(H, W/32) int32 words → (H, W) uint8 0/1."""
    H, nw = packed.shape
    shifts = torch.arange(WORD, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(H, nw * WORD).to(torch.uint8)


def pad_mask(nw: int, col_limit, device) -> torch.Tensor:
    """(nw,) int32 words whose bits are set below cell column ``col_limit``
    (all of them when it is None): the real cells of a padded row."""
    w = torch.arange(nw, dtype=torch.int64, device=device)
    limit = nw * WORD if col_limit is None else col_limit
    v = torch.clamp(limit - w * WORD, 0, WORD)
    return i32_bits((torch.ones_like(v) << v) - 1)


def mask_pad(packed: torch.Tensor, col_limit) -> torch.Tensor:
    """``packed`` (..., NW) with every bit at or past cell column
    ``col_limit`` zeroed (the reference's ``_mask_pad_cols``); unchanged
    when it is None."""
    if col_limit is None:
        return packed
    return packed & pad_mask(packed.shape[-1], col_limit, packed.device)


def init_packed(
    rows: int,
    cols: int,
    seed: int,
    row_offset: int = 0,
    col_offset: int = 0,
    block_rows: int = 1024,
    col_limit=None,
    device="cuda",
) -> torch.Tensor:
    """Hash-init a grid tile straight into packed words, a block of rows at
    a time, so a 65536² grid (512 MiB packed) never materialises its 4 GiB
    of unpacked cells.  ``col_limit``: cells whose global column
    (col_offset + local) is >= this start dead, as the pad of a padded grid
    does in the reference."""
    if cols % WORD:
        raise ValueError(f"cols {cols} not a multiple of {WORD}")
    nw = cols // WORD
    mask = None
    if col_limit is not None:
        mask = pad_mask(nw, col_limit - col_offset, device)
    out = torch.empty((rows, nw), dtype=torch.int32, device=device)
    step = max(1, min(block_rows, rows))
    for r0 in range(0, rows, step):
        n = min(step, rows - r0)
        p = pack(init_tile_torch(n, cols, seed, row_offset + r0, col_offset,
                                 device=device))
        out[r0:r0 + n] = p if mask is None else p & mask
    return out


def pack_np(grid) -> np.ndarray:
    """Host-side pack (numpy uint32, blockwise to bound intermediates)."""
    grid = np.asarray(grid, dtype=np.uint8)
    H, W = grid.shape
    if W % WORD:
        raise ValueError(f"width {W} not a multiple of {WORD}")
    out = np.empty((H, W // WORD), dtype=np.uint32)
    weights = (np.uint32(1) << np.arange(WORD, dtype=np.uint32))
    step_rows = max(1, (1 << 24) // max(W, 1))
    for r0 in range(0, H, step_rows):
        blk = grid[r0 : r0 + step_rows]
        out[r0 : r0 + step_rows] = (
            blk.reshape(blk.shape[0], -1, WORD).astype(np.uint32) * weights
        ).sum(axis=-1, dtype=np.uint32)
    return out


def unpack_np(packed) -> np.ndarray:
    """Host-side unpack of uint32 words (numpy, blockwise)."""
    packed = np.asarray(packed)
    H, nw = packed.shape
    out = np.empty((H, nw * WORD), dtype=np.uint8)
    shifts = np.arange(WORD, dtype=np.uint32)
    step_rows = max(1, (1 << 24) // max(nw * WORD, 1))
    for r0 in range(0, H, step_rows):
        blk = packed[r0 : r0 + step_rows]
        bits = (blk[:, :, None] >> shifts) & np.uint32(1)
        out[r0 : r0 + step_rows] = bits.reshape(blk.shape[0], -1).astype(np.uint8)
    return out


def column_sums(up, mid, down):
    """Carry-save vertical sums per bit column: full ``f = up + mid + down``
    (f0 weight 1, f1 weight 2) and centre-excluded ``c = up + down``."""
    t = up ^ mid
    f0 = t ^ down
    f1 = (up & mid) | (down & t)
    c0 = up ^ down
    c1 = up & down
    return f0, f1, c0, c1


# -- rule compiler ----------------------------------------------------------
#
# After the horizontal combine the neighbour count is
#   count = s0 + 2*k,   k = L1 + c1 + R1 + ca  in 0..4
# Every radius-1 rule is a symmetric function of the four weight-2 addends,
# so it compiles into threshold indicators k>=v and, per run of active k, a
# minimal 2-variable function of (s0, alive).  Counts above 8 cannot occur,
# which makes (k=4, s0=1) a don't-care.  Life compiles to
#   next = (k==1) & (s0 | mid)
# The compiler is duck-typed: it only uses & | ^ on its operands, so it runs
# on tensors and on anything else that defines them.

# minimal builders for every 2-variable boolean function of (s0, mid);
# key = outputs for (s0, mid) in ((0,0), (0,1), (1,0), (1,1)); value =
# (op_cost, builder).  NOT is xor with all ones (1 op).
_G2 = {
    (0, 0, 0, 0): (0, lambda s, m, F: None),           # handled as "drop term"
    (1, 1, 1, 1): (0, lambda s, m, F: "one"),          # indicator alone
    (0, 0, 1, 1): (0, lambda s, m, F: s),
    (0, 1, 0, 1): (0, lambda s, m, F: m),
    (0, 0, 0, 1): (1, lambda s, m, F: s & m),
    (0, 1, 1, 1): (1, lambda s, m, F: s | m),
    (0, 1, 1, 0): (1, lambda s, m, F: s ^ m),
    (1, 1, 0, 0): (1, lambda s, m, F: s ^ F),
    (1, 0, 1, 0): (1, lambda s, m, F: m ^ F),
    (1, 0, 0, 1): (2, lambda s, m, F: (s ^ m) ^ F),
    (1, 1, 1, 0): (2, lambda s, m, F: (s & m) ^ F),
    (1, 0, 0, 0): (2, lambda s, m, F: (s | m) ^ F),
    (0, 0, 1, 0): (2, lambda s, m, F: s & (m ^ F)),
    (0, 1, 0, 0): (2, lambda s, m, F: m & (s ^ F)),
    (1, 0, 1, 1): (2, lambda s, m, F: s | (m ^ F)),
    (1, 1, 0, 1): (2, lambda s, m, F: m | (s ^ F)),
}


def _minimal_g(table):
    """table: 4 entries in {0, 1, None} for (s0, mid); None = don't care.
    Returns (cost, builder) of the cheapest concrete function consistent
    with it."""
    best = None
    for concrete, (cost, build) in _G2.items():
        if all(t is None or t == c for t, c in zip(table, concrete)):
            if best is None or cost < best[0]:
                best = (cost, build)
    return best


def _merge_tables(ta, tb):
    """Merge two don't-care tables; None if they conflict."""
    out = []
    for x, y in zip(ta, tb):
        if x is None:
            out.append(y)
        elif y is None or x == y:
            out.append(x)
        else:
            return None
    return tuple(out)


class _Thresholds:
    """Lazy k>=v indicators over the four weight-2 addends."""

    def __init__(self, a, b, c, d, full):
        self.abcd = (a, b, c, d)
        self.full = full
        self._memo = {}

    def _pairs(self):
        if "p" not in self._memo:
            a, b, c, d = self.abcd
            self._memo["p"] = (a & b, c & d, a | b, c | d)
        return self._memo["p"]

    def ge(self, v):
        if v <= 0:
            return None  # k >= 0 is always true
        if v > 4:
            return 0     # never
        if v not in self._memo:
            p1, p2, o1, o2 = self._pairs()
            if v == 1:
                self._memo[v] = o1 | o2
            elif v == 2:
                self._memo[v] = p1 | p2 | (o1 & o2)
            elif v == 3:
                self._memo[v] = (p1 & o2) | (p2 & o1)
            else:
                self._memo[v] = p1 & p2
        return self._memo[v]

    def in_range(self, lo, hi):
        """Indicator of lo <= k <= hi (None = always true)."""
        glo = self.ge(lo)
        ghi = self.ge(hi + 1)
        if ghi is None or isinstance(ghi, int) and ghi == 0:
            return glo
        not_hi = ghi ^ self.full
        return not_hi if glo is None else glo & not_hi


def _rule_tables(rule: Rule):
    """Per-k don't-care tables over (s0, mid) in ((0,0),(0,1),(1,0),(1,1)):
    the next-state bit for count = 2k + s0, None where count > 8."""
    tables = []
    for k in range(5):
        row = []
        for s in (0, 1):
            count = 2 * k + s
            for alive in (0, 1):
                if count > 8:
                    row.append(None)
                else:
                    row.append(int(count in (rule.survive if alive else rule.birth)))
        tables.append(tuple(row))
    return tables


def compile_rule(L1, c1, R1, ca, s0, mid, rule: Rule, full, ones):
    """The compiled rule over the decomposed count: next state of ``mid``,
    or None when the rule never fires.  ``full`` is the all-ones constant,
    ``ones()`` builds an all-ones operand where an indicator is always
    true."""
    th = _Thresholds(L1, c1, R1, ca, full)
    # greedy maximal runs of consecutive k with compatible next-functions
    tables = _rule_tables(rule)
    acc = None
    k = 0
    while k < 5:
        if not any(t == 1 for t in tables[k]):
            k += 1
            continue
        merged = tables[k]
        hi = k
        while hi + 1 < 5:
            m2 = _merge_tables(merged, tables[hi + 1])
            if m2 is None or not any(t == 1 for t in tables[hi + 1]):
                # only extend over ks that actually fire, to keep ge() cheap
                break
            merged, hi = m2, hi + 1
        ind = th.in_range(k, hi)
        g = _minimal_g(merged)[1](s0, mid, full)
        if g is None:
            term = None
        elif isinstance(g, str):  # "one": indicator alone
            term = ind if ind is not None else ones()
        else:
            term = g if ind is None else ind & g
        if term is not None:
            acc = term if acc is None else acc | term
        k = hi + 1
    return acc


def low_bits(L0, c0, R0):
    """The weight-1 sum bit ``s0`` and the carry ``ca`` of L0 + c0 + R0."""
    u = L0 ^ c0
    return u ^ R0, (L0 & c0) | (R0 & u)


# -- instruction count of the compiled form ---------------------------------
#
# On Hopper one LOP3 computes any boolean function of up to three 32-bit
# operands (a NOT, or a constant operand, folds into its truth table), and one
# SHF funnel shift computes a shift with the carry bit of the neighbouring
# word, (x << 1) | (y >> 31).  ``word_ops`` traces one word's generation as
# the kernel computes it on uint32 words into a graph of gates and shifts,
# and counts the fewest LOP3 and SHF instructions that cover that graph.


class _Node:
    """A traced 32-bit value: an input, a gate over one or two nodes (a
    constant operand adds no node), or a funnel shift of one node.  A gate
    keeps its operator and its constant operand, so the function that one
    LOP3 computes over a cut can be tabulated (:func:`lop3_table`)."""

    def __init__(self, graph, kids=(), shift=False, op=None, const=None):
        self.graph, self.kids, self.shift = graph, kids, shift
        self.op, self.const = op, const
        self.id = len(graph)
        graph.append(self)

    def _gate(self, op, other):
        if isinstance(other, int):
            return _Node(self.graph, (self,), op=op, const=other)
        return _Node(self.graph, (self, other), op=op)

    def __and__(self, other):
        return self._gate("&", other)

    def __or__(self, other):
        return self._gate("|", other)

    def __xor__(self, other):
        return self._gate("^", other)

    __rand__, __ror__, __rxor__ = __and__, __or__, __xor__

    def __invert__(self):
        return _Node(self.graph, (self,), op="~")


def _cuts(node, memo):
    """The sets of at most three nodes that ``node`` is a function of and
    that one LOP3 can take as operands; inputs and shifts cut only at
    themselves."""
    if node.id not in memo:
        out = {frozenset([node])}
        if node.kids and not node.shift:
            combos = [frozenset()]
            for kid in node.kids:
                combos = [c | k for c in combos for k in _cuts(kid, memo)
                          if len(c | k) <= 3]
            out.update(combos)
        memo[node.id] = out
    return memo[node.id]


def cover_plan(root) -> list:
    """The fewest instructions that compute ``root``, as ``(node, cut)``
    pairs in an order that computes operands first: each gate that is kept
    is one LOP3 over the nodes of its cut, each shift one SHF of its
    operand.  Exact: the nodes still owed are settled highest first, and
    only a higher node can owe a lower one."""
    if not isinstance(root, _Node):
        return []
    cut_memo, best = {}, {}

    def owed(nodes):
        return frozenset(n for n in nodes if n.kids)

    def cost(todo):  # (instructions, the cut of the highest node owed)
        if not todo:
            return 0, None
        if todo not in best:
            n = max(todo, key=lambda x: x.id)
            rest = todo - {n}
            if n.shift:
                cuts = [frozenset(n.kids)]
            else:
                # in a fixed order, so ties break the same way in every run
                cuts = sorted((c for c in _cuts(n, cut_memo) if n not in c),
                              key=lambda c: sorted(x.id for x in c))
            best[todo] = min(((1 + cost(rest | owed(c))[0], c) for c in cuts),
                             key=lambda t: t[0])
        return best[todo]

    plan, todo = [], owed([root])
    while todo:
        n = max(todo, key=lambda x: x.id)
        cut = cost(todo)[1]
        plan.append((n, sorted(cut, key=lambda x: x.id)))
        todo = (todo - {n}) | owed(cut)
    return plan[::-1]


def _cover(root) -> int:
    """The fewest LOP3 and SHF instructions that compute ``root``
    (:func:`cover_plan`)."""
    return len(cover_plan(root))


def lop3_table(node, cut) -> int:
    """The 8-bit truth table of the gate ``node`` as a function of the (at
    most three) nodes of ``cut``, in LOP3's convention: bit
    ``4a + 2b + c`` is the output for operand bits a, b, c."""
    value = dict(zip(cut, (0xF0, 0xCC, 0xAA)))

    def table(n):
        if n not in value:
            x = table(n.kids[0])
            if n.op == "~":
                value[n] = ~x & 0xFF
            else:
                y = table(n.kids[1]) if len(n.kids) == 2 else n.const & 0xFF
                value[n] = x & y if n.op == "&" else (
                    x | y if n.op == "|" else x ^ y)
        return value[n]

    return table(node)


def _map_cover(root, passes: int = 3) -> int:
    """Instructions that compute ``root``, for graphs too large for the
    exact :func:`_cover`: a technology mapping of the graph onto LOP3 and
    SHF.  Each gate first takes the cut of least area flow (a leaf's cost
    shared among its readers), then, for a few passes, the cut that adds the
    fewest instructions given the rest of the cover.  A valid cover, so an
    upper bound on the exact count; on the radius-1 rules it lands within
    two instructions of it (``tests/test_torch_bitltl.py``)."""
    if not isinstance(root, _Node):
        return 0
    nodes, stack = {}, [root]
    while stack:
        n = stack.pop()
        if n.id not in nodes:
            nodes[n.id] = n
            stack.extend(n.kids)
    readers = dict.fromkeys(nodes, 0)
    for n in nodes.values():
        for k in n.kids:
            readers[k.id] += 1
    cut_memo, flow, choice = {}, {}, {}

    def candidates(n):
        if n.shift:
            return [frozenset(n.kids)]
        # in a fixed order, so ties break the same way in every run
        return sorted((c for c in _cuts(n, cut_memo) if n not in c),
                      key=lambda c: sorted(x.id for x in c))

    def gates(cut):
        return [x for x in cut if x.kids]

    for i in sorted(nodes):
        n = nodes[i]
        if n.kids:
            flow[i], choice[i] = min(
                ((1 + sum(flow[x.id] / readers[x.id] for x in gates(c)), c)
                 for c in candidates(n)), key=lambda fc: fc[0])

    refs: dict = {}

    def ref(n) -> int:    # take n's cut into the cover; instructions added
        added = 1
        for x in gates(choice[n.id]):
            refs[x.id] = refs.get(x.id, 0) + 1
            if refs[x.id] == 1:
                added += ref(x)
        return added

    def deref(n) -> int:  # take it out again; instructions removed
        removed = 1
        for x in gates(choice[n.id]):
            refs[x.id] -= 1
            if refs[x.id] == 0:
                removed += deref(x)
        return removed

    total = ref(root)
    for _ in range(passes):
        for i in sorted(nodes, reverse=True):
            n = nodes[i]
            if n.shift or not n.kids or (n is not root and not refs.get(i)):
                continue
            total -= deref(n)
            best = None
            for c in candidates(n):
                choice[i] = c
                added = ref(n)
                deref(n)
                if best is None or added < best[0]:
                    best = (added, c)
            choice[i] = best[1]
            total += ref(n)
    return total


def word_ops(rule: Rule) -> int:
    """Hopper integer instructions (LOP3 and SHF) per word per generation in
    the compiled form of ``rule``: the least integer work a generation
    needs, per 32 cells."""
    graph = []
    up, mid, down = (_Node(graph) for _ in range(3))
    f0, f1, c0, c1 = column_sums(up, mid, down)
    L0, L1, R0, R1 = (_Node(graph, (f,), shift=True) for f in (f0, f1, f0, f1))
    s0, ca = low_bits(L0, c0, R0)
    return _cover(compile_rule(L1, c1, R1, ca, s0, mid, rule, _FULL,
                               lambda: _FULL))


def bit_next(f0, f1, c0, c1, f0p, f1p, f0n, f1n, mid, rule: Rule):
    """Next state of ``mid`` given the vertical column sums of its own words
    (f*, c*) and of the previous/next words along the row (f*p, f*n), whose
    edge bits provide the cross-word shift carries."""
    # horizontal gather: L/R = the 2-bit column sums one column left/right;
    # masked right shifts, because int32 >> is arithmetic
    L0 = (f0 << 1) | ((f0p >> 31) & 1)
    L1 = (f1 << 1) | ((f1p >> 31) & 1)
    R0 = ((f0 >> 1) & _LOW31) | (f0n << 31)
    R1 = ((f1 >> 1) & _LOW31) | (f1n << 31)

    # count = s0 + 2*(L1 + c1 + R1 + ca)
    s0, ca = low_bits(L0, c0, R0)

    acc = compile_rule(L1, c1, R1, ca, s0, mid, rule, _FULL,
                       lambda: torch.full_like(mid, _FULL))
    return torch.zeros_like(mid) if acc is None else acc


def bit_step(packed: torch.Tensor, rule: Rule = LIFE,
             boundary: str = "periodic") -> torch.Tensor:
    """One generation on a packed (H, W/32) int32 grid, or on each board of
    a (B, H, W/32) batch."""
    if rule.radius != 1:
        raise ValueError("bitpacked engine supports radius-1 rules only")
    if boundary not in ("periodic", "dead"):
        raise ValueError(f"unknown boundary {boundary!r}")
    periodic = boundary == "periodic"
    zero_row = torch.zeros_like(packed[..., :1, :])
    zero_col = torch.zeros_like(packed[..., :1])

    if periodic:
        up = torch.roll(packed, 1, dims=-2)
        down = torch.roll(packed, -1, dims=-2)
    else:
        up = torch.cat([zero_row, packed[..., :-1, :]], dim=-2)
        down = torch.cat([packed[..., 1:, :], zero_row], dim=-2)

    def word_shift(x, direction):
        # previous/next word along the row for cross-word bit carries
        if periodic:
            return torch.roll(x, direction, dims=-1)
        if direction == 1:
            return torch.cat([zero_col, x[..., :-1]], dim=-1)
        return torch.cat([x[..., 1:], zero_col], dim=-1)

    # vertical sums once, then shift the 2-bit sums: the sums of a shifted
    # word are the shifted sums
    f0, f1, c0, c1 = column_sums(up, packed, down)
    return bit_next(
        f0, f1, c0, c1,
        word_shift(f0, 1), word_shift(f1, 1),
        word_shift(f0, -1), word_shift(f1, -1),
        packed, rule,
    )


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Live cells per int32 word (SWAR popcount; torch has none).  Right
    shifts are masked so the sign bit never smears."""
    x = words - ((words >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def population(packed: torch.Tensor) -> int:
    """Live cells of a packed grid, summed on its device in int64."""
    return int(popcount(packed).sum(dtype=torch.int64).item())

