"""The port's engine on a mesh (``backends/cuda.py:build_engine`` with a
mesh, ``backends/cuda_mesh.py``, ``parallel/step.py``, the mesh seam of
``parallel/seam.py``) against the reference's ``build_engine(config,
mesh=make_mesh(shape))`` on its 8 virtual CPU devices: the engine it
picks, its padded width, notes, every snapshot tile and the final grid,
bit for bit, on every mesh shape the reference's tests use; K1, K3 and K2
(their plain versions here) as the shard interiors."""

import contextlib
import io

import numpy as np
import pytest
import torch

from mpi_tpu.backends.tpu import build_engine as jax_build_engine
from mpi_tpu.config import GolConfig as JaxConfig
from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_tpu.parallel.step import (
    make_sharded_bit_stepper as jax_bit_stepper,
    make_sharded_ltl_stepper as jax_ltl_stepper,
    make_sharded_stepper as jax_dense_stepper,
    sharded_bit_init as jax_bit_init, sharded_init as jax_init,
)
from mpi_tpu_torch import interop
from mpi_tpu_torch.backends import cuda as port
from mpi_tpu_torch.backends.cuda_mesh import MeshEngine, chunk_gens
from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.config import ConfigError, GolConfig
from mpi_tpu_torch.models.rules import rule_from_name
from mpi_tpu_torch.ops import cuda_bitlife, cuda_bitltl, cuda_stencil
from mpi_tpu_torch.parallel import seam
from mpi_tpu_torch.parallel import step as port_step
from mpi_tpu_torch.parallel.mesh import make_mesh
from mpi_tpu_torch.utils.hashinit import init_tile_np

R2 = "R2,B8-12,S9-14"

# (mesh, rule, boundary, rows, cols, comm_every, overlap, steps)
CASES = [
    # K1 interiors on every mesh shape, both boundaries
    *[(m, "life", b, 64, 256, 1, False, 5)
      for m in [(1, 2), (2, 1), (2, 2), (2, 4), (1, 8), (8, 1)]
      for b in ("periodic", "dead")],
    ((2, 2), "life", "periodic", 64, 256, 2, True, 7),
    ((2, 2), "life", "dead", 64, 256, 4, False, 7),
    ((2, 2), "life", "dead", 64, 256, 4, True, 7),
    ((1, 2), "life", "periodic", 64, 128, 8, False, 8),
    ((2, 1), "life", "dead", 64, 128, 8, True, 8),
    ((2, 4), "highlife", "dead", 64, 256, 2, True, 6),
    ((1, 8), "highlife", "periodic", 64, 256, 2, False, 6),
    # K3 interiors: R2 and Bosco
    ((1, 2), R2, "periodic", 64, 64, 1, False, 4),
    ((1, 2), R2, "periodic", 64, 128, 2, True, 5),
    ((2, 2), R2, "dead", 64, 128, 4, False, 8),
    ((2, 2), R2, "dead", 64, 128, 4, True, 8),
    ((8, 1), R2, "periodic", 64, 64, 1, False, 3),
    ((2, 4), R2, "dead", 64, 256, 1, True, 3),
    ((2, 2), "bosco", "dead", 64, 128, 1, False, 3),
    ((1, 2), "bosco", "periodic", 64, 128, 2, True, 4),
    # K2 interiors: comm_every x r past one ghost word, a periodic width
    # the seam cannot serve
    ((1, 2), R2, "periodic", 64, 160, 16, False, 17),
    ((1, 2), R2, "dead", 64, 160, 16, True, 17),
    ((2, 1), "life", "periodic", 80, 60, 16, False, 8),
    ((2, 1), "life", "dead", 80, 66, 3, True, 7),
    # padded widths: K1 and K3 with a local col_limit, shards wholly in the
    # pad, and the seam band across the first and last shard column
    ((2, 4), "life", "dead", 64, 100, 1, False, 5),
    ((2, 4), "life", "dead", 64, 100, 2, False, 5),
    ((2, 4), "life", "dead", 64, 100, 1, True, 5),
    ((2, 4), R2, "dead", 64, 100, 1, False, 4),
    ((2, 4), "life", "periodic", 64, 100, 1, False, 5),
    ((1, 2), "life", "periodic", 64, 80, 1, False, 5),
    ((1, 2), "life", "periodic", 64, 80, 1, True, 5),
    ((1, 2), "life", "periodic", 64, 80, 3, False, 7),
    ((1, 2), R2, "periodic", 64, 80, 2, False, 5),
    ((2, 4), "life", "periodic", 32, 32, 1, False, 4),
    # the seam band deeper than K2's 16 cells (comm_every x r in 17..31),
    # still one launch: Bosco at comm_every 4, R2 at 9
    ((1, 2), "bosco", "periodic", 39, 90, 4, False, 11),
    ((1, 2), R2, "periodic", 40, 140, 9, False, 11),
]


def _id(case):
    m, rule, b, rows, cols, k, ov, n = case
    return (f"{m[0]}x{m[1]}-{rule.split(',')[0]}-{b}-{rows}x{cols}-k{k}"
            f"{'-ov' if ov else ''}")


def _configs(case, seed=7):
    m, rule, b, rows, cols, k, ov, n = case
    ours = GolConfig(rows=rows, cols=cols, steps=n, seed=seed,
                     rule=rule_from_name(rule), boundary=b, mesh_shape=m,
                     comm_every=k, overlap=ov)
    theirs = JaxConfig(rows=rows, cols=cols, steps=n, seed=seed,
                       rule=jax_rule_from_name(rule), boundary=b,
                       backend="tpu", mesh_shape=m, comm_every=k,
                       overlap=ov)
    return ours, theirs


def _build_both(case, **kw):
    ours, theirs = _configs(case, **kw)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        ref = jax_build_engine(theirs, mesh=jax_make_mesh(case[0]))
    want_notes = err.getvalue()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        eng = port.build_engine(ours, device="cpu")
    return eng, ref, err.getvalue(), want_notes


def _tiles(tiles):
    return [(pid, r0, c0, np.asarray(t)) for pid, t, r0, c0 in tiles]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_engine_equals_the_reference_on_the_mesh(case):
    eng, ref, notes, want_notes = _build_both(case)
    assert isinstance(eng, MeshEngine)
    assert (eng.mi, eng.mj) == (ref.mi, ref.mj) == case[0]
    assert eng.bitpacked == ref.bitpacked
    assert (eng.cols_eff, eng.pad_bits) == (ref.cols_eff, ref.pad_bits)
    assert notes == want_notes
    n = case[-1]
    g, h = eng.init_grid(), ref.init_grid()
    for got, want in zip(_tiles(eng.tiles(g)), _tiles(ref.tiles(h))):
        assert got[:3] == want[:3]
        np.testing.assert_array_equal(got[3], want[3])
    # a whole pass plan and then a remainder of one generation
    g = eng.step(eng.step(g, n), 1)
    h = ref.step(ref.step(h, n), 1)
    got_tiles, want_tiles = _tiles(eng.tiles(g)), _tiles(ref.tiles(h))
    assert [t[:3] for t in got_tiles] == [t[:3] for t in want_tiles]
    for got, want in zip(got_tiles, want_tiles):
        np.testing.assert_array_equal(got[3], want[3])
    final = eng.fetch(g)
    np.testing.assert_array_equal(final, ref.fetch(h))
    cfg = eng.config
    np.testing.assert_array_equal(final, evolve_np(
        init_tile_np(cfg.rows, cfg.cols, 7), n + 1, cfg.rule, cfg.boundary))
    assert eng.population(g) == int(final.sum())


@pytest.mark.parametrize("case", [CASES[3], CASES[22], CASES[36], CASES[26]],
                         ids=_id)
def test_checkpoint_init_equals_the_reference(case):
    """init from a host grid (the resume path) and from a region loader,
    shard by shard, as the reference's ``_put_initial``."""
    eng, ref, _, _ = _build_both(case)
    cfg = eng.config
    start = init_tile_np(cfg.rows, cfg.cols, 11)
    g = eng.step(eng.init_grid(initial=start), 3)
    h = ref.step(ref.init_grid(initial=start), 3)
    np.testing.assert_array_equal(eng.fetch(g), ref.fetch(h))
    calls = []

    def loader(r0, r1, c0, c1):
        calls.append((r0, r1, c0, c1))
        return start[r0:r1, c0:c1]

    g2 = eng.step(eng.init_grid(initial=loader), 3)
    np.testing.assert_array_equal(eng.fetch(g2), eng.fetch(g))
    assert len(calls) == len(eng.tiles(g2))


@pytest.mark.parametrize("kind,rule,K,boundary,overlap", [
    ("bit", "life", 8, "periodic", False), ("bit", "life", 8, "dead", False),
    ("bit", "life", 8, "periodic", True), ("bit", "life", 8, "dead", True),
    ("ltl", R2, 4, "periodic", True), ("ltl", R2, 4, "dead", False),
    ("ltl", "bosco", 2, "periodic", False), ("ltl", "bosco", 2, "dead", True),
    ("dense", "bosco", 3, "periodic", True),
    ("dense", "bosco", 3, "dead", False),
    ("dense", R2, 16, "periodic", False)])
def test_steppers_equal_the_reference_steppers(kind, rule, K, boundary,
                                               overlap):
    """The three sharded steppers over ``make_mesh((2, 2))`` against the
    reference's on the same sharded init, K generations a pass and a
    remainder."""
    rows, cols = 96, 128
    mesh, jmesh = make_mesh((2, 2), platform="cpu"), jax_make_mesh((2, 2))
    ours, theirs = rule_from_name(rule), jax_rule_from_name(rule)
    if kind == "dense":
        ev = port_step.make_sharded_stepper(
            mesh, ours, boundary, gens_per_exchange=K, overlap=overlap)
        jev = jax_dense_stepper(jmesh, theirs, boundary, gens_per_exchange=K,
                                overlap=overlap)
        g, h = (port_step.sharded_init(mesh, rows, cols, 3),
                jax_init(jmesh, rows, cols, 3))
    else:
        make, jmake = ((port_step.make_sharded_bit_stepper, jax_bit_stepper)
                       if kind == "bit" else
                       (port_step.make_sharded_ltl_stepper, jax_ltl_stepper))
        ev = make(mesh, ours, boundary, gens_per_exchange=K, overlap=overlap)
        jev = jmake(jmesh, theirs, boundary, gens_per_exchange=K,
                    overlap=overlap)
        g, h = (port_step.sharded_bit_init(mesh, rows, cols, 3),
                jax_bit_init(jmesh, rows, cols, 3))
    n = K + 1
    np.testing.assert_array_equal(interop.shards_to_numpy(ev(g, n)),
                                  np.asarray(jev(h, n)))


@pytest.mark.parametrize("K", [1, 3])
def test_padded_dead_stepper_equals_the_reference(K):
    """pad_bits with a local col_limit on narrow tiles: 64x100 on 2x4
    pads every shard to one word, and the last shard holds 4 real
    columns."""
    mesh, jmesh = make_mesh((2, 4), platform="cpu"), jax_make_mesh((2, 4))
    ev = port_step.make_sharded_bit_stepper(
        mesh, rule_from_name("life"), "dead", gens_per_exchange=K,
        pad_bits=28)
    jev = jax_bit_stepper(jmesh, jax_rule_from_name("life"), "dead",
                          gens_per_exchange=K, pad_bits=28)
    g = port_step.sharded_bit_init(mesh, 64, 128, 5, col_limit=100)
    h = jax_bit_init(jmesh, 64, 128, 5, col_limit=100)
    np.testing.assert_array_equal(interop.shards_to_numpy(g), np.asarray(h))
    np.testing.assert_array_equal(interop.shards_to_numpy(ev(g, 2 * K + 1)),
                                  np.asarray(jev(h, 2 * K + 1)))


def _count_fused_bands(monkeypatch):
    """Record every ``seam.fused_band`` call as (src shape, width, k)."""
    calls = []
    real = seam.fused_band

    def counting(src, out, rule, width, k, handle=None):
        calls.append((tuple(src.shape), width, k))
        return real(src, out, rule, width, k, handle)

    monkeypatch.setattr(seam, "fused_band", counting)
    return calls


@pytest.mark.parametrize("rule,rows,cols,k,seed", [
    ("bosco", 39, 90, 4, 47), (R2, 40, 140, 9, 47)], ids=["bosco", "r2"])
def test_seam_band_deeper_than_k2_steps_in_chunks(monkeypatch, rule, rows,
                                                   cols, k, seed):
    """A padded periodic mesh keeps the bit-sliced engine while
    comm_every x r <= 31, past K2's 16: the seam band is one
    ``fused_band`` call a pass, K2 runs nothing, and the grid equals the
    reference engine's and the oracle's after 11 steps."""
    calls = _count_fused_bands(monkeypatch)
    k2 = []

    def no_k2(*args, **kw):
        k2.append(args[0].shape)
        return real_k2(*args, **kw)

    real_k2 = cuda_stencil.cuda_dense_step
    monkeypatch.setattr(cuda_stencil, "cuda_dense_step", no_k2)
    monkeypatch.setitem(port.KERNELS, "dense",
                        ("K2", no_k2, cuda_stencil.refusal))
    case = ((1, 2), rule, "periodic", rows, cols, k, False, 11)
    eng, ref, _, _ = _build_both(case, seed=seed)
    assert eng.kind == "ltl" and eng.seam
    g = eng.step(eng.init_grid(), 11)
    r = eng.config.rule.radius
    passes = [k] * (11 // k) + [11 % k]
    assert [c[2] for c in calls] == passes and 16 < k * r <= 31
    assert k2 == []
    np.testing.assert_array_equal(eng.fetch(g), ref.fetch(ref.step(
        ref.init_grid(), 11)))
    np.testing.assert_array_equal(eng.fetch(g), evolve_np(
        init_tile_np(rows, cols, seed), 11, eng.config.rule, "periodic"))


def test_seam_block_holds_the_strip_at_its_own_width():
    """``seam.seam_block``: for every depth d <= 31 and width C >= 4d,
    4d <= width <= 32 x len(words), and the block of the strip's words
    holds the strip at that width as the grid holds it at C."""
    gen = torch.Generator().manual_seed(5)
    for d in range(1, 32):
        for C in range(4 * d, 4 * d + 97):
            words, width = seam.seam_block(C, d)
            assert words == seam.strip_words(C, d)
            assert 4 * d <= width <= 32 * len(words), (C, d)
            if words[-1] - words[0] + 1 == len(words):
                assert width == C   # the runs touch: the grid's first words
            if C % 7:
                continue
            grid = torch.randint(-2**31, 2**31, (2, -(-C // 32)),
                                 generator=gen, dtype=torch.int64)
            grid = grid.to(torch.int32)
            block = grid[:, list(words)].contiguous()
            assert seam.extract_band(block, width, d).equal(
                seam.extract_band(grid, C, d)), (C, d)


# (mesh, rule, rows, cols, comm_every, steps, boards, the band's block:
# its words and real width at the full pass's depth)
MESH_SEAM = [
    ((1, 2), "life", 64, 80, 3, 7, 0, (0, 2), 48),
    ((2, 2), "life", 64, 100, 2, 5, 0, (0, 3), 36),
    ((1, 2), "life", 64, 80, 3, 7, 2, (0, 2), 48),       # a batch of 2
    ((1, 2), R2, 40, 140, 9, 11, 0, (0, 1, 3, 4), 108),  # d = 18 > 16
    ((1, 2), "life", 32, 70, 8, 9, 0, (0, 1, 2), 70),    # the runs touch
]


@pytest.mark.parametrize(
    "mesh,rule,rows,cols,K,steps,boards,words,width", MESH_SEAM,
    ids=["1x2", "2x2", "1x2-batch", "1x2-deep", "1x2-touching"])
def test_mesh_seam_pass_is_one_fused_band_on_its_block(
        monkeypatch, mesh, rule, rows, cols, K, steps, boards, words,
        width):
    """Each pass of a padded periodic mesh gathers the strip's words into
    one block and calls ``fused_band`` once on it, at the block's own
    width; the grid (each board of a batch) equals the reference mesh
    engine's and the oracle's."""
    calls = _count_fused_bands(monkeypatch)
    case = (mesh, rule, "periodic", rows, cols, K, False, steps)
    eng, ref, _, _ = _build_both(case)
    assert eng.seam and (eng.mi, eng.mj) == mesh
    r = eng.config.rule.radius
    assert seam.seam_block(cols, K * r) == (words, width)
    passes = [K] * (steps // K) + ([steps % K] if steps % K else [])
    oracle = [evolve_np(init_tile_np(rows, cols, s), steps, eng.config.rule,
                        "periodic") for s in (7, 8)]
    if boards:
        g = eng.step_batched(eng.stack_grids(
            [eng.init_grid(seed=s) for s in (7, 8)]), steps)
        finals = eng.fetch_batched(g)
        lead = (boards,)
    else:
        finals = [eng.fetch(eng.step(eng.init_grid(), steps))]
        lead = ()
    assert [c[1:] for c in calls] == [seam.seam_block(cols, k * r)[1:] + (k,)
                                      for k in passes]
    assert calls[0][0] == lead + (rows, len(words))
    for c in calls:
        assert 4 * c[2] * r <= c[1] <= 32 * c[0][-1]
    np.testing.assert_array_equal(finals[0], ref.fetch(ref.step(
        ref.init_grid(), steps)))
    for got, want in zip(finals, oracle):
        np.testing.assert_array_equal(got, want)


def test_every_local_launch_is_the_engines_kernel(monkeypatch):
    """Each shard's local work goes through its engine's wrapper, dead
    boundary, at the launch counts the plan says: one a shard a pass, five
    with overlap, K3 in chunks of max_gens(r), K2 in chunks of 16/r."""
    calls = []

    def counting(wrapper, kid):
        def call(x, rule, boundary, gens=1, **kw):
            calls.append((kid, boundary, gens))
            return wrapper(x, rule, boundary, gens=gens, **kw)
        return call

    for kind, (kid, wrapper, refusal) in list(port.KERNELS.items()):
        monkeypatch.setitem(port.KERNELS, kind,
                            (kid, counting(wrapper, kid), refusal))
    for case, kid, per_pass in [
            (((2, 2), "life", "dead", 64, 256, 4, False, 9), "K1", 1),
            (((2, 2), "life", "dead", 64, 256, 4, True, 9), "K1", 5),
            (((1, 2), "bosco", "periodic", 64, 128, 3, False, 3), "K3", 3),
            (((1, 2), R2, "periodic", 64, 160, 16, True, 16), "K2", 10)]:
        calls.clear()
        eng = port.build_engine(_configs(case)[0], device="cpu")
        g = eng.init_grid()
        calls.clear()
        eng.step(g, case[-1])
        K, n = case[5], case[-1]
        passes = n // min(K, n) + bool(n % min(K, n))
        shards = case[0][0] * case[0][1]
        assert {c[0] for c in calls} == {kid}
        assert {c[1] for c in calls} == {"dead"}
        if kid == "K1":
            assert len(calls) == shards * passes * per_pass
        else:
            assert len(calls) == shards * per_pass
    assert chunk_gens("ltl", rule_from_name("bosco"), [1, 3]) == [1]
    assert chunk_gens("dense", rule_from_name(R2), [16, 5]) == [5, 8]
    assert chunk_gens("bit", rule_from_name("life"), [8, 3]) == [3, 8]


def test_mesh_engine_refusals_match_the_reference():
    """The reference's mesh refusals, message for message: sparse on a
    mesh, overlap on tiles too small for the bands (packed and dense)."""
    from mpi_tpu.config import ConfigError as JaxConfigError

    for kw in [dict(rows=64, cols=256, comm_every=8, overlap=True,
                    mesh_shape=(8, 1)),
               dict(rows=64, cols=320, comm_every=8, overlap=True,
                    mesh_shape=(8, 1)),
               dict(rows=64, cols=128, sparse_tile=32, mesh_shape=(2, 2))]:
        with pytest.raises(JaxConfigError) as want:
            jax_build_engine(JaxConfig(steps=1, backend="tpu", **kw))
        with pytest.raises(ConfigError) as got:
            port.build_engine(GolConfig(steps=1, **kw), device="cpu")
        assert str(got.value) == str(want.value)


def test_card_mesh_keeps_the_references_device_count_rule(monkeypatch):
    """On the card a shape must use every card (one here: the reference's
    message); an explicit device list may repeat a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"mesh shape \(2, 2\) needs 4 "
                       r"devices, have 1"):
        make_mesh((2, 2))
    m = make_mesh((2, 2), devices=[torch.device("cuda", 0)] * 4)
    assert m.dims == (2, 2) and {d for row in m.devices for d in row} == {
        torch.device("cuda", 0)}
    assert make_mesh((1, 1)).dims == (1, 1)


def test_cpu_mesh_sees_eight_virtual_devices_like_the_reference():
    for shape in [None, (1, 1), (2, 4), (1, 8), (8, 1), (2, 2)]:
        want = jax_make_mesh(shape).devices.shape
        assert make_mesh(shape, platform="cpu").dims == tuple(want)
    for shape in [(4, 4), (3, 3)]:
        with pytest.raises(ValueError) as want:
            jax_make_mesh(shape)
        with pytest.raises(ValueError) as got:
            make_mesh(shape, platform="cpu")
        assert str(got.value) == str(want.value)


def test_refused_shard_window_raises_and_does_not_fall_back(monkeypatch):
    """A shard window the kernel's refusal declines is a ConfigError naming
    the kernel and the shape, at build time."""
    def refuse_wide(shape, rule, gens=1, boundary="periodic"):
        return "too wide" if shape[1] > 64 else None

    monkeypatch.setitem(port.KERNELS, "bit", (
        "K1", cuda_bitlife.cuda_bit_step, refuse_wide))
    with pytest.raises(ConfigError, match=r"kernel K1 cannot run .* on a "
                       r"34x192 shard window of the 2x2 mesh: too wide"):
        port.build_engine(GolConfig(rows=64, cols=256, steps=1,
                                    mesh_shape=(2, 2)), device="cpu")
    assert cuda_bitltl.refusal and cuda_stencil.refusal
