"""The plain reference on boards of known evolution, against a direct
sum over every offset, and against the program at a small size on the
CPU."""

import numpy as np
import pytest
import torch

from portbench import board
from portbench.reference.cells import (
    count_wrong, evolve_packed, pack, parse_rule, port_rule_text, unpack,
)

LIFE = parse_rule("B3/S23")
BOSCO = parse_rule("R5,C0,M1,S34..58,B34..45")


def _board(cells):
    return pack(torch.tensor(np.asarray(cells, dtype=np.uint8)))


def _cells(packed, cols):
    return unpack(packed)[..., :cols].numpy()


def test_parse_and_port_text():
    assert LIFE.radius == 1 and not LIFE.middle
    assert LIFE.birth == ((3, 3),) and LIFE.survive == ((2, 3),)
    assert BOSCO.radius == 5 and BOSCO.middle
    assert BOSCO.birth == ((34, 45),) and BOSCO.survive == ((34, 58),)
    assert port_rule_text(LIFE) == "B3/S23"
    assert port_rule_text(BOSCO) == "R5,B34-45,S33-57"
    with pytest.raises(ValueError):
        parse_rule("R5,C3,M1,S34..58,B34..45")


@pytest.mark.parametrize("cols", [32, 60, 64, 100])
def test_pack_round_trip(cols):
    rng = np.random.default_rng(cols)
    cells = rng.integers(0, 2, (5, cols), dtype=np.uint8)
    packed = _board(cells)
    assert packed.dtype == torch.int32 and packed.shape == (5, -(-cols // 32))
    assert (_cells(packed, cols) == cells).all()
    assert unpack(packed)[:, cols:].sum() == 0


def test_blinker_has_period_two():
    g = np.zeros((16, 32), np.uint8)
    g[7, 6:9] = 1
    b = _board(g)
    one = evolve_packed(b, LIFE, 1, 32, "periodic")
    assert _cells(one, 32)[6:9, 7].tolist() == [1, 1, 1]
    assert _cells(one, 32).sum() == 3
    assert torch.equal(evolve_packed(b, LIFE, 2, 32, "periodic"), b)


def test_glider_crosses_the_torus():
    g = np.zeros((16, 32), np.uint8)
    g[0, 1] = g[1, 2] = g[2, 0] = g[2, 1] = g[2, 2] = 1
    b = _board(g)
    moved = np.roll(np.roll(g, 1, 0), 1, 1)
    got = evolve_packed(b, LIFE, 4, 32, "periodic", block_rows=5)
    assert (_cells(got, 32) == moved).all()
    # 64 generations later it is back (16 rows, 32 columns: 4 x 16 / 1)
    far = evolve_packed(b, LIFE, 128, 32, "periodic", block_rows=7)
    assert (_cells(far, 32) == np.roll(g, 32, 0)).all()


def test_dead_edge_stops_the_glider():
    g = np.zeros((8, 32), np.uint8)
    g[5, 6] = g[6, 7] = g[7, 5] = g[7, 6] = g[7, 7] = 1
    dead = _cells(evolve_packed(_board(g), LIFE, 8, 32, "dead"), 32)
    wrap = _cells(evolve_packed(_board(g), LIFE, 8, 32, "periodic"), 32)
    assert (dead != wrap).any()


def _direct(cells, rule, periodic):
    """One generation by a sum over every offset of the box."""
    r = rule.radius
    H, W = cells.shape
    pad = np.pad(cells, r, mode="wrap" if periodic else "constant")
    count = sum(pad[r + dy:r + dy + H, r + dx:r + dx + W].astype(int)
                for dy in range(-r, r + 1) for dx in range(-r, r + 1))
    if not rule.middle:
        count -= cells
    inside = lambda c, ivs: np.any([(c >= lo) & (c <= hi) for lo, hi in ivs],
                                   axis=0)
    return np.where(cells == 1, inside(count, rule.survive),
                    inside(count, rule.birth)).astype(np.uint8)


@pytest.mark.parametrize("rule", [LIFE, BOSCO], ids=["life", "bosco"])
@pytest.mark.parametrize("boundary", ["periodic", "dead"])
@pytest.mark.parametrize("cols", [64, 60])
def test_against_a_direct_sum(rule, boundary, cols):
    g = board.soup(board.generator(5, "cpu"), 1, 48, cols, 0.45, "cpu")[0]
    want = _cells(g, cols)
    for _ in range(3):
        want = _direct(want, rule, boundary == "periodic")
    got = evolve_packed(g, rule, 3, cols, boundary, block_rows=20)
    assert (_cells(got, cols) == want).all()
    assert count_wrong(g, got, rule, 3, cols, boundary, block_rows=16) == 0
    bad = got.clone()
    bad[7, 1] ^= 4
    assert count_wrong(g, bad, rule, 3, cols, boundary) == 1


def test_a_set_pad_bit_counts_wrong():
    g = board.soup(board.generator(3, "cpu"), 1, 32, 60, 0.5, "cpu")[0]
    after = evolve_packed(g, LIFE, 2, 60, "periodic")
    after[4, 1] |= 1 << 30
    assert count_wrong(g, after, LIFE, 2, 60, "periodic") == 1


def test_soup_is_the_seed():
    a = board.soup(board.generator(2 ** 33 + 1, "cpu"), 2, 16, 40, 0.5, "cpu")
    b = board.soup(board.generator(2 ** 33 + 1, "cpu"), 2, 16, 40, 0.5, "cpu")
    c = board.soup(board.generator(2 ** 33 + 2, "cpu"), 2, 16, 40, 0.5, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert unpack(a)[..., 40:].sum() == 0
    assert 0.35 < unpack(a)[..., :40].float().mean() < 0.65


@pytest.mark.parametrize("rule_text,cols,boundary,K", [
    ("B3/S23", 64, "periodic", 8), ("B3/S23", 60, "periodic", 8),
    ("B3/S23", 60, "dead", 4),
    ("R5,C0,M1,S34..58,B34..45", 64, "periodic", 1),
    ("R5,C0,M1,S34..58,B34..45", 60, "dead", 1)])
def test_against_the_program_on_the_cpu(rule_text, cols, boundary, K):
    from mpi_tpu_torch.backends.cuda import build_engine
    from mpi_tpu_torch.config import GolConfig
    from mpi_tpu_torch.models.rules import rule_from_name

    rule = parse_rule(rule_text)
    cfg = GolConfig(rows=64, cols=cols, steps=0, boundary=boundary,
                    rule=rule_from_name(port_rule_text(rule)), comm_every=K)
    engine = build_engine(cfg, device="cpu", depths=[K])
    g = board.soup(board.generator(11, "cpu"), 1, 64, cols, 0.5, "cpu")[0]
    before = g.clone()
    for _ in range(3):
        after = engine.step(g, K)
        assert count_wrong(before, after, rule, K, cols, boundary) == 0
        before = after.clone()
        g = after


@pytest.mark.parametrize("rule_text", ["B3/S23", "B36/S23", "B2/S",
                                       "R1,C0,M1,S3..4,B3..3"])
@pytest.mark.parametrize("block_rows", [2048, 13])
def test_packed_words_against_cells(rule_text, block_rows):
    """The packed-word path (radius 1, a torus of whole words, whole or in
    blocks with halos) against the cell path."""
    from portbench.reference import cells

    rule = parse_rule(rule_text)
    g = board.soup(board.generator(21, "cpu"), 2, 40, 96, 0.4, "cpu")
    got = evolve_packed(g, rule, 5, 96, "periodic", block_rows=block_rows)
    want = g.clone()
    for _ in range(5):
        x = cells.unpack(want)
        want = cells.pack(cells.generation(x, rule, True, torus=True))
    assert torch.equal(got, want)
