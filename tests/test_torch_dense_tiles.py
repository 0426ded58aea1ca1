"""Kernel K2's CTA tile as a build variant (``-DK2_ROWS``/``-DK2_COLS`` of
``csrc/stencil.cu``), on the CPU: the shared-memory screen, the macros, the
variant library's key and build, the wrapper's refusal of a tile on a CPU
tensor, the engines that carry a tile on every launch (and the seam band
that keeps the default build), ``check_blocks``, the tuner's dense block
plane and a cached K2 tile, and the reference's ``pallas_step(...,
blocks=)`` override against its own auto-blocked call and the port's
``cuda_dense_step`` on the same board: a block override changes no cell in
either package.
"""

from __future__ import annotations

import dataclasses
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_tpu.models.rules import rule_from_name as ref_rule
from mpi_tpu.ops.pallas_stencil import pallas_step
from mpi_tpu_torch import interop, tune
from mpi_tpu_torch.backends import cuda as backend
from mpi_tpu_torch.backends.cuda import check_blocks, plan_engine
from mpi_tpu_torch.config import ConfigError, GolConfig
from mpi_tpu_torch.models.rules import rule_from_name
from mpi_tpu_torch.ops import _build, cuda_stencil
from mpi_tpu_torch.ops.cuda_stencil import cuda_dense_step, dense_step_plain
from mpi_tpu_torch.parallel import seam
from mpi_tpu_torch.parallel.mesh import make_mesh
from mpi_tpu_torch.tune import tuner as port_tuner

BOSCO = rule_from_name("bosco")
R2 = rule_from_name("R2,B10-13,S8-12")
CUDA = torch.device("cuda")
TILE = [64, 128]
MACROS = {"K2_ROWS": 64, "K2_COLS": 128}


def _dense(rule=BOSCO, **kw):
    base = dict(rows=2048, cols=2048, steps=0, rule=rule, comm_every=3)
    base.update(kw)
    return GolConfig(**base)


# ------------------------------------------------------------ the screen


@pytest.mark.parametrize("rows", cuda_stencil.BLOCK_ROWS)
@pytest.mark.parametrize("cols", cuda_stencil.BLOCK_COLS)
@pytest.mark.parametrize("radius", range(1, 8))
def test_k2_screen_is_the_kernels_shared_memory(rows, cols, radius):
    """Two buffers of ``rows + 2 gens r`` rows of ``8 + (cols + 32) / 4``
    words (``csrc/stencil.cu:launch_kernel``) and the 512-byte rule
    table, at the deepest pass K2 launches for a depth, against the
    H100's 227 KB."""
    for depth in range(1, 17):
        h = min(depth, 16 // radius) * radius
        most = 2 * (rows + 2 * h) * (8 + (cols + 32) // 4) * 4 + 512
        assert cuda_stencil.tile_bytes(rows, cols, radius, depth) == most
        assert cuda_stencil.blocks_ok(rows, cols, radius, depth) == \
            (most <= 227 * 1024)
        # the default tile fits at every depth and radius
        assert cuda_stencil.blocks_ok(*cuda_stencil.DEFAULT_TILE, radius,
                                      depth)
    assert not cuda_stencil.blocks_ok(rows, 100, radius, 1)   # not a tile
    assert not cuda_stencil.blocks_ok(48, cols, radius, 1)
    assert not cuda_stencil.blocks_ok(rows, cols, radius, 1,
                                      H=rows * 65536)  # 65536 row tiles
    assert cuda_stencil.block_defines([rows, cols]) == \
        {"K2_ROWS": rows, "K2_COLS": cols}


def test_default_tile_is_the_sources():
    src = (_build.CSRC_DIR / "stencil.cu").read_text()
    assert "#define K2_ROWS 128" in src and "#define K2_COLS 256" in src
    assert cuda_stencil.DEFAULT_TILE == [128, 256]
    assert cuda_stencil.tile_bytes(128, 256, 5, 3) == 101632


# ------------------------------------------------------------ check_blocks


@pytest.mark.parametrize("config,tile", [
    (_dense(), TILE),                                  # Bosco at depth 3
    (_dense(), [512, 128]),
    (_dense(R2, comm_every=8), [512, 128]),            # 16 cells of halo
    (_dense(comm_every=7), [256, 256]),                # passes of 3
    (_dense(cols=40, rule=rule_from_name("life"), comm_every=16),
     [32, 512]),                    # Life on K2: the seam declines 40 cols
])
def test_check_blocks_takes_a_screened_k2_tile(config, tile):
    assert plan_engine(config)[0] == "dense"
    check_blocks(config, "dense", CUDA, tile)


@pytest.mark.parametrize("config,tile,device,match", [
    (_dense(), [64], CUDA, r"\[rows, cols\]"),          # wrong arity
    (_dense(), [64, 128, 4], CUDA, r"\[rows, cols\]"),
    (_dense(), [512, 256], CUDA, "232448 bytes"),       # 339 KiB at depth 3
    (_dense(), [48, 128], CUDA, "rows in"),
    (_dense(), [64, 100], CUDA, "cols in"),
    (_dense(), TILE, torch.device("cpu"), "plain versions"),
    (dataclasses.replace(_dense(comm_every=1), backend="serial"), TILE, CUDA,
     "runs no kernel"),
    (dataclasses.replace(_dense(comm_every=1), backend="cpp-par"), TILE,
     CUDA, "runs no kernel"),
])
def test_check_blocks_refuses_a_k2_tile_off_its_screen(config, tile, device,
                                                       match):
    with pytest.raises(ConfigError, match=match):
        check_blocks(config, "dense", device, tile)


def test_a_sparse_engine_screens_its_dense_chunks():
    """A sparse dense engine runs chunks of 2 generations of Bosco even at
    comm_every 1: its tile is screened at that depth."""
    config = _dense(comm_every=1, sparse_tile=40, rows=2000, cols=2000)
    assert plan_engine(config)[0] == "dense"
    assert backend.pass_depth(config, "dense") == 1
    assert backend.deepest_pass(config, "dense") == 2
    check_blocks(config, "dense", CUDA, [512, 128])
    with pytest.raises(ConfigError, match="passes of 2 generations"):
        check_blocks(config, "dense", CUDA, [256, 512])


def test_build_engine_refuses_a_k2_tile_on_the_cpu():
    with pytest.raises(ConfigError, match="blocks"):
        backend.build_engine(_dense(rows=64, cols=64), device="cpu",
                             blocks=TILE)


# ------------------------------------------------------------ the wrapper


def test_wrapper_refuses_a_tile_on_a_cpu_tensor():
    g = torch.zeros((40, 70), dtype=torch.uint8)
    before = cuda_dense_step.launches
    with pytest.raises(ValueError, match="no CTA tile"):
        cuda_dense_step(g, BOSCO, "dead", 3, defines=MACROS)
    # no macros (or none at all) is the plain version
    assert torch.equal(cuda_dense_step(g, BOSCO, "dead", 3, defines={}),
                       dense_step_plain(g, BOSCO, "dead", 3))
    assert cuda_dense_step.launches == before


def test_wrapper_loads_the_variant_and_never_the_plain_version(monkeypatch):
    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a tensor off the CPU")

    monkeypatch.setattr(cuda_stencil, "dense_step_plain", no_plain)
    monkeypatch.setattr(cuda_stencil, "check_cuda", lambda x, kernel: None)
    asked = []

    def no_variant(defines):
        asked.append(dict(defines))
        raise _build.BuildError("nvcc not found")

    def no_default():
        raise AssertionError("the default build was loaded for a variant")

    monkeypatch.setattr(_build, "load_variant_library", no_variant)
    monkeypatch.setattr(_build, "load_library", no_default)
    off_cpu = torch.zeros((4, 40), dtype=torch.uint8, device="meta")
    before = cuda_dense_step.launches
    with pytest.raises(_build.BuildError, match="nvcc"):
        cuda_dense_step(off_cpu, BOSCO, "periodic", 3, defines=MACROS)
    assert asked == [MACROS] and cuda_dense_step.launches == before


# ------------------------------------------------------------ the library


def test_variant_library_is_keyed_by_its_macros():
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for src in _build.sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    default = _build.BUILD_DIR / f"libmpi_tpu_torch_{h.hexdigest()[:16]}.so"
    assert _build.library_path() == _build.library_path({}) == default
    a = _build.library_path(MACROS)
    b = _build.library_path({"K2_ROWS": 64, "K2_COLS": 256})
    assert len({default, a, b}) == 3 and a.parent == _build.BUILD_DIR
    assert a.name.startswith("libmpi_tpu_torch_dense_")
    # the order the macros come in does not matter
    assert _build.library_path({"K2_COLS": 128, "K2_ROWS": 64}) == a


_FAKE_NVCC = """#!/bin/sh
out=""; srcs=""; defs=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; -D*) defs="$defs${1#-D}";;
  *.cu) srcs="$srcs $(basename $1)";; esac
  shift
done
case "$defs" in *"$FAIL_ON"*) if [ -n "$FAIL_ON" ]; then
  echo "error: broken" >&2; exit 2; fi;; esac
echo "ptxas info : Compiling entry function '_ZN12_GLOBAL__N_117dense_step_kernelILi5EEEvPKj' for 'sm_90a'" >&2
echo "ptxas info : Used 40 registers, 384 bytes cmem[0]" >&2
echo "$defs$srcs" > "$out"
"""


def test_variants_build_together_one_nvcc_each(monkeypatch, tmp_path):
    (tmp_path / "bin").mkdir()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("FAIL_ON", "")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    before = _build.builds
    other = {"K2_ROWS": 32, "K2_COLS": 512}
    libs = _build.build_variants([MACROS, other, MACROS], jobs=2)
    assert _build.builds - before == 2 and libs[0] == libs[2]
    assert libs == [_build.library_path(MACROS), _build.library_path(other)
                    ] + [_build.library_path(MACROS)]
    assert libs[0].read_text() == \
        "K2_COLS=128K2_ROWS=64 errors.cu stencil.cu\n"
    assert _build.kernel_resources(libs[1]) == [
        {"kernel": "dense_step_kernel<5>", "registers": 40}]
    assert _build.build_variants([other]) == [libs[1]]   # reused
    assert _build.builds - before == 2
    monkeypatch.setenv("FAIL_ON", "K2_ROWS=256")
    with pytest.raises(_build.BuildError, match="K2_ROWS"):
        _build.build_variants([{"K2_ROWS": 256, "K2_COLS": 128}])
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [libs[0].name, libs[1].name, _build.ptxas_log(libs[0]).name,
         _build.ptxas_log(libs[1]).name])     # no half-built library left


def test_tuner_prebuilds_k2_variants_as_variants(monkeypatch):
    built = []
    monkeypatch.setattr(_build, "build_variants",
                        lambda defines: built.append(list(defines)))
    monkeypatch.setattr(_build, "build_rules", lambda *a, **k: (
        pytest.fail("K2 variants are not per rule")))
    config = _dense()
    space = tune.candidates(config, (1, 1), device="cuda")
    port_tuner._prebuild(config, space, "cuda", lambda msg: None)
    want = [cuda_stencil.block_defines(c.plan["blocks"]) for c in space
            if "blocks" in c.plan]
    assert built == [want] and len(want) == 6


# ------------------------------------------------------------ the engines


def _recording(calls, plain=dense_step_plain):
    """A stand-in for K2's wrapper that records each launch's macros and
    steps the plain version."""
    def kernel(x, rule, boundary="periodic", gens=1, out=None, defines=None,
               **kw):
        calls.append(defines)
        res = plain(x, rule, boundary, gens, **kw)
        return res if out is None else out.copy_(res)
    return kernel


def _plain(grid, n):
    for _ in range(n):
        grid = dense_step_plain(grid, BOSCO, "periodic", 1)
    return grid


def test_engine_carries_the_tile_on_every_launch(monkeypatch):
    calls = []
    monkeypatch.setitem(backend.KERNELS, "dense",
                        ("K2", _recording(calls), cuda_stencil.refusal))
    config = _dense(rows=40, cols=70)
    eng = backend.Engine(config, torch.device("cpu"), "dense", (1, 2, 3),
                         depth=3, blocks=TILE)
    eng.warm_up(boards=2)    # launches its kernel on the card only
    assert all(d == MACROS for d in calls)
    calls.clear()
    grid = eng.step(eng.init_grid(seed=5), 7)          # passes of 3, 3, 1
    assert calls == [MACROS] * 3
    assert torch.equal(grid, _plain(eng.init_grid(seed=5), 7))
    batch = eng.step_batched(eng.stack_grids(
        [eng.init_grid(seed=s) for s in (5, 6)]), 4)   # 3, 1
    assert calls == [MACROS] * 5
    assert torch.equal(batch[1], _plain(eng.init_grid(seed=6), 4))
    # the real wrapper refuses the tile on the CPU: no fallback
    monkeypatch.setitem(backend.KERNELS, "dense",
                        ("K2", cuda_dense_step, cuda_stencil.refusal))
    plain_eng = backend.Engine(config, torch.device("cpu"), "dense",
                               (1, 2, 3), depth=3, blocks=TILE)
    with pytest.raises(ValueError, match="no CTA tile"):
        plain_eng.step(plain_eng.init_grid(seed=5), 3)


def test_mesh_engine_carries_the_tile_on_every_window(monkeypatch):
    calls = []
    monkeypatch.setitem(backend.KERNELS, "dense",
                        ("K2", _recording(calls), cuda_stencil.refusal))
    monkeypatch.setattr(backend, "check_blocks", lambda *a: None)
    config = _dense(rows=160, cols=160, comm_every=7)
    eng = backend.build_engine(config, mesh=make_mesh((1, 2), platform="cpu"),
                               blocks=TILE)
    assert eng.blocks == TILE and eng.kind == "dense"
    eng.warm_up()
    assert all(d == MACROS for d in calls)
    calls.clear()
    grid = eng.step(eng.init_grid(), 7)                 # chunks of 3, 3, 1
    assert calls == [MACROS] * (2 * 3)
    one = backend.build_engine(config, device="cpu")
    assert np.array_equal(eng.fetch(grid),
                          one.fetch(one.step(one.init_grid(), 7)))


def test_seam_band_keeps_the_default_build(monkeypatch, capsys):
    """A padded periodic grid's engine is K1 or K3; its tile is theirs, and
    the seam band launches from the default build of the common library:
    its one launch (``seam.fused_band``) takes no build macros, and K2
    runs nothing."""
    k1_calls, band_calls, k2_calls = [], [], []

    def k1(x, rule, boundary="periodic", gens=1, out=None, defines=None,
           **kw):
        k1_calls.append(defines)
        res = backend.cuda_bitlife.bit_step_plain(x, rule, boundary, gens,
                                                  **kw)
        return res if out is None else out.copy_(res)

    real_band, real_k2 = seam.fused_band, cuda_stencil.cuda_dense_step

    def band(*args, **kw):
        band_calls.append(kw)
        return real_band(*args, **kw)

    def k2(*args, **kw):
        k2_calls.append(kw.get("defines"))
        return real_k2(*args, **kw)

    monkeypatch.setitem(backend.KERNELS, "bit",
                        ("K1", k1, backend.cuda_bitlife.refusal))
    monkeypatch.setattr(seam, "fused_band", band)
    monkeypatch.setattr(cuda_stencil, "cuda_dense_step", k2)
    monkeypatch.setitem(backend.KERNELS, "dense",
                        ("K2", k2, cuda_stencil.refusal))
    monkeypatch.setattr(backend, "check_blocks", lambda *a: None)
    config = GolConfig(rows=64, cols=90, steps=0, comm_every=2)
    eng = backend.build_engine(config, device="cpu", blocks=[32, 4])
    assert eng.seam and eng.kind == "bit"
    assert "the seam band's one launch takes no tile" in \
        capsys.readouterr().err
    eng.step(eng.init_grid(), 4)
    assert k1_calls and all(d == {"K1_ROWS": 32, "K1_WPL": 4}
                            for d in k1_calls)
    assert band_calls and all(kw == {} for kw in band_calls)
    assert k2_calls == []


# ------------------------------------------------------------ the tuner


def test_card_candidates_propose_k2_tiles_on_dense_plans():
    config = _dense()
    tiles = [c.plan["blocks"] for c in tune.candidates(config, (1, 1))
             if "blocks" in c.plan]
    assert 0 < len(tiles) <= tune.space.MAX_BLOCK_CANDIDATES
    assert cuda_stencil.DEFAULT_TILE not in tiles
    assert all(cuda_stencil.blocks_ok(rows, cols, 5, 3, 2048)
               for rows, cols in tiles)
    # the tiles that add CTAs first
    assert [r * c for r, c in tiles] == sorted(r * c for r, c in tiles)
    assert tiles[0] == [32, 128]
    # paired: Bosco at comm_every 8 runs K2 in passes of 3
    paired = [c.plan for c in tune.candidates(_dense(comm_every=1), (1, 1))
              if "blocks" in c.plan and "comm_every" in c.plan]
    assert [p["blocks"] for p in paired] == tiles
    assert {p["comm_every"] for p in paired} == {8}
    # none off the card, none on a mesh
    assert not any("blocks" in c.plan for c in
                   tune.candidates(config, (1, 1), device="cpu"))
    assert not any("blocks" in c.plan for c in
                   tune.candidates(config, (1, 2)))


def test_a_cached_k2_tile_applies_on_the_card_only(tmp_path):
    config = _dense()
    plan = {"blocks": TILE}
    card = "cuda:NVIDIA_H100_80GB_HBM3:1"
    assert tune.cache.validate_plan(config, (1, 1), plan, card) == config
    with pytest.raises(ConfigError, match="plain versions"):
        tune.cache.validate_plan(config, (1, 1), plan, "cpu:cpu:1")
    cache = tune.TuneCache(str(tmp_path / "tc.json"))
    for platform in (card, "cpu:cpu:1"):
        cache.record(config, (1, 1), plan, {}, platform=platform)
    assert cache.resolve(config, (1, 1), platform=card) == (config, plan)
    assert cache.resolve(config, (1, 1), platform="cpu:cpu:1") == \
        (config, None)
    findings = cache.check()
    assert len(findings) == 1 and "cpu:cpu:1" in findings[0]


# ------------------------------------------------------------ the reference


def test_a_block_override_changes_no_cell_in_either_package():
    """The reference's ``pallas_step`` in interpret mode with ``blocks=(32,
    32)`` on 64 x 128 Bosco, gens 3, equals its auto-blocked call and the
    port's ``cuda_dense_step`` on the CPU (K2's plain version), exactly."""
    g = (np.random.default_rng(17).random((64, 128)) < 0.5).astype(np.uint8)
    x = jnp.asarray(g)
    tiled = np.asarray(pallas_step(x, ref_rule("bosco"), "periodic",
                                   interpret=True, gens=3, blocks=(32, 32)))
    auto = np.asarray(pallas_step(x, ref_rule("bosco"), "periodic",
                                  interpret=True, gens=3))
    ours = cuda_dense_step(interop.dense_from_numpy(g, "cpu"), BOSCO,
                           "periodic", 3)
    np.testing.assert_array_equal(tiled, auto)
    np.testing.assert_array_equal(interop.dense_to_numpy(ours), tiled)
    assert 0 < tiled.sum() < g.size
