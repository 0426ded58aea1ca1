"""Batched stepping in the port against the JAX package, on the CPU:
``Engine.step_batched``, ``population_batched`` and ``fetch_batched``
against the reference's ``Engine.step_batched`` on a 1x1 mesh for the K1,
K2 and K3 engines and padded ones (a seam engine among them), one kernel
call per pass for the whole batch, and the kernels' board axis against
stepping each board alone."""

import numpy as np
import pytest
import torch

from mpi_tpu.backends.tpu import build_engine as jax_build_engine
from mpi_tpu.config import GolConfig as JaxConfig
from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu_torch.backends import cuda as port
from mpi_tpu_torch.config import GolConfig
from mpi_tpu_torch.models.rules import BOSCO, LIFE, rule_from_name
from mpi_tpu_torch.ops.cuda_bitlife import cuda_bit_step
from mpi_tpu_torch.ops.cuda_bitltl import cuda_ltl_step
from mpi_tpu_torch.ops.cuda_stencil import cuda_dense_step

R2 = rule_from_name("R2,B10-13,S8-12")

ENGINES = [
    (dict(cols=64, comm_every=4), "bit", False),
    (dict(cols=64, rule=R2, comm_every=2), "ltl", False),
    (dict(cols=70, rule=BOSCO, comm_every=3), "dense", False),
    (dict(cols=100, comm_every=3), "bit", True),             # padded, seam
    (dict(cols=100, comm_every=3, boundary="dead"), "bit", True),
    (dict(cols=50, rule=R2, comm_every=2), "ltl", True),     # padded, seam
]


@pytest.mark.parametrize("kw,kind,padded", ENGINES,
                         ids=[f"{k}{'-padded' if p else ''}-{i}"
                              for i, (_, k, p) in enumerate(ENGINES)])
def test_step_batched_matches_the_reference(kw, kind, padded):
    cfg = GolConfig(rows=24, steps=0, seed=1, **kw)
    eng = port.build_engine(cfg, device="cpu")
    assert eng.kind == kind and bool(eng.pad_bits) == padded
    ref = jax_build_engine(JaxConfig(
        rows=cfg.rows, cols=cfg.cols, steps=0, seed=1,
        rule=jax_rule_from_name(cfg.rule.name), boundary=cfg.boundary,
        comm_every=cfg.comm_every, backend="tpu", mesh_shape=(1, 1)))
    seeds = [3, 4, 5]
    want = ref.step_batched(ref.init_grids(seeds=seeds), 7)
    grids = eng.init_grids(seeds=seeds)
    assert grids.shape[0] == 3
    grids = eng.step_batched(grids, 7)
    boards = eng.fetch_batched(grids)
    for got, exp in zip(boards, ref.fetch_batched(want)):
        assert got.shape == (cfg.rows, cfg.cols)
        np.testing.assert_array_equal(got, exp)
    assert eng.population_batched(grids) == ref.population_batched(want)
    assert eng.batched_step_calls == 1 and eng.step_calls == 0
    # the units chain equals one step of the same length, board by board
    units = eng.step_batched_units(grids.clone(), 3)
    whole = eng.step_batched(grids, 3)
    assert units.equal(whole) and eng.batched_step_calls == 5
    solo = [eng.step_units(g, 3) for g in eng.unstack_grids(
        eng.step_batched(eng.init_grids(seeds=seeds), 7))]
    for a, b in zip(solo, eng.unstack_grids(whole)):
        assert a.equal(b)
    assert eng.step_calls == 9


@pytest.mark.parametrize("kw", [dict(cols=64, comm_every=4),
                                dict(cols=100, comm_every=3),
                                dict(cols=70, rule=BOSCO, comm_every=3)])
def test_one_kernel_call_per_pass_for_the_whole_batch(kw):
    cfg = GolConfig(rows=24, steps=0, seed=1, **kw)
    eng = port.build_engine(cfg, device="cpu")
    calls = []
    kernel = eng._kernel

    def counting(x, *a, **k):
        calls.append(tuple(x.shape))
        return kernel(x, *a, **k)

    eng._kernel = counting
    grids = eng.init_grids(seeds=range(5))
    grids = eng.step_batched(grids, 2 * cfg.comm_every + 1)
    assert len(calls) == 3 and all(c[0] == 5 for c in calls)


def test_batched_stepper_and_stacking():
    cfg = GolConfig(rows=16, cols=64, steps=0, seed=2, comm_every=2)
    eng = port.build_engine(cfg, device="cpu")
    step = eng.batched_stepper(3)
    assert step.B == 3 and step.engine is eng
    grids = eng.init_grids(seeds=[1, 2, 3])
    with pytest.raises(ValueError, match="B=3, got 2"):
        step(grids[:2], 1)
    with pytest.raises(ValueError, match="B=3"):
        step(grids[0], 1)
    boards = eng.unstack_grids(grids)
    assert len(boards) == 3 and all(b.shape == (16, 2) for b in boards)
    assert boards[0].data_ptr() != grids.data_ptr()
    assert eng.stack_grids(boards).equal(grids)
    cells = [eng.fetch(b) for b in boards]
    assert eng.init_grids(initials=cells).equal(grids)
    out = step(grids, 4)
    assert out.shape == (3, 16, 2) and eng.step_batched(out, 0) is out
    with pytest.raises(ValueError, match="batch"):
        eng.step_batched(boards[0], 1)


@pytest.mark.parametrize("cols", [64, 50])
def test_engine_keeps_one_solo_and_one_batch_spare(cols):
    # a serve layer steps batches of many widths B: each new B replaces the
    # batch spare rather than adding one
    cfg = GolConfig(rows=16, cols=cols, steps=0, seed=2, comm_every=2)
    eng = port.build_engine(cfg, device="cpu")
    eng.warm_up(boards=4)
    grid = eng.step(eng.init_grid(), 3)
    for B in (2, 3, 2, 5):
        grids = eng.step_batched(eng.init_grids(seeds=range(B)), 3)
        assert len(eng._spares) == 2
        assert {s.dim(): tuple(s.shape) for s in eng._spares.values()} == \
            {2: tuple(grid.shape), 3: (B, *grid.shape)}
        assert all(s.data_ptr() not in (grid.data_ptr(), grids.data_ptr())
                   for s in eng._spares.values())
    assert eng.step(grid, 1).shape == grid.shape and len(eng._spares) == 2


@pytest.mark.parametrize("wrapper,make,rule,kw", [
    (cuda_bit_step, "words", LIFE, dict(col_limit=None)),
    (cuda_bit_step, "words", LIFE, dict(col_limit=40)),
    (cuda_ltl_step, "words", R2, dict(col_limit=None)),
    (cuda_ltl_step, "words", R2, dict(col_limit=50)),
    (cuda_dense_step, "cells", BOSCO, {}),
])
@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_kernel_board_axis_equals_each_board_alone(wrapper, make, rule, kw,
                                                   boundary):
    rng = np.random.default_rng(4)
    if make == "words":
        x = torch.from_numpy(rng.integers(0, 2**32, size=(3, 9, 2),
                                          dtype=np.uint32).view(np.int32))
    else:
        x = torch.from_numpy(rng.integers(0, 2, size=(3, 20, 33),
                                          dtype=np.uint8))
    gens = 2 if rule.radius < 5 else 1
    got = wrapper(x, rule, boundary, gens, **kw)
    out = torch.empty_like(x)
    assert wrapper(x, rule, boundary, gens, out=out, **kw) is out
    assert out.equal(got)
    for b in range(3):
        assert got[b].equal(wrapper(x[b], rule, boundary, gens, **kw))
    with pytest.raises(ValueError, match=r"\(B, H, N\)"):
        wrapper(x[None], rule, boundary, gens, **kw)
