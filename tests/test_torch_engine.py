"""The port's main paths against the JAX package's, on the CPU: ``run_cuda``
(with ``device="cpu"``, the plain versions of kernels K1, K2 and K3)
against ``run_tpu`` on XLA:CPU and the serial oracle, the engine choice
against the reference's single-device policy, and the port's CLI against
the reference CLI's ``.gol`` files, byte for byte."""

import filecmp
import os

import numpy as np
import pytest
import torch

from mpi_tpu.backends.tpu import run_tpu
from mpi_tpu.cli import main as jax_main
from mpi_tpu.config import GolConfig as JaxConfig
from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu_torch import golio, interop
from mpi_tpu_torch.backends import cuda as port
from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.cli import main as port_main
from mpi_tpu_torch.config import ConfigError, GolConfig
from mpi_tpu_torch.models.rules import BOSCO, LIFE, rule_from_name
from mpi_tpu_torch.ops import _build
from mpi_tpu_torch.ops.cuda_bitlife import bit_step_plain, cuda_bit_step
from mpi_tpu_torch.ops.cuda_bitltl import cuda_ltl_step, ltl_step_plain
from mpi_tpu_torch.ops.cuda_stencil import cuda_dense_step, dense_step_plain
from mpi_tpu_torch.utils.hashinit import init_tile_np


def _collect():
    seen = []

    def cb(iteration, tiles):
        seen.append((iteration, [(pid, np.array(t), r0, c0)
                                 for pid, t, r0, c0 in tiles]))
    return seen, cb


@pytest.mark.parametrize("comm_every", [1, 4, 16])
@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_run_cuda_matches_run_tpu(comm_every, boundary):
    # mesh (1, 1): the test harness gives JAX 8 virtual CPU devices, and the
    # reference would otherwise shard the grid 2x4
    kw = dict(rows=32, cols=64, steps=23, snapshot_every=10, seed=7,
              boundary=boundary, comm_every=comm_every)
    jax_snaps, jax_cb = _collect()
    want = run_tpu(JaxConfig(backend="tpu", mesh_shape=(1, 1), **kw),
                   snapshot_cb=jax_cb)
    snaps, cb = _collect()
    got = port.run_cuda(GolConfig(**kw), snapshot_cb=cb, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert [i for i, _ in snaps] == [i for i, _ in jax_snaps] == [0, 10, 20, 23]
    for (_, tiles), (_, jtiles) in zip(snaps, jax_snaps):
        assert len(tiles) == len(jtiles) == 1
        np.testing.assert_array_equal(tiles[0][1], jtiles[0][1])
        assert (tiles[0][0], tiles[0][2], tiles[0][3]) == \
            (jtiles[0][0], jtiles[0][2], jtiles[0][3])


def _gol_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".gol"))


@pytest.mark.parametrize("boundary,rule,comm", [
    ("periodic", "life", "1"), ("dead", "life", "4"),
    ("periodic", "highlife", "3"),
])
def test_cli_gol_files_match_reference_serial(tmp_path, boundary, rule, comm):
    common = ["48", "64", "5", "12", "--save", "--name", "n", "--seed", "3",
              "--boundary", boundary, "--rule", rule, "--quiet"]
    ref, mine = tmp_path / "ref", tmp_path / "port"
    assert jax_main(common + ["--backend", "serial", "--out-dir", str(ref)]) == 0
    assert port_main(common + ["--device", "cpu", "--comm-every", comm,
                               "--out-dir", str(mine)]) == 0
    names = _gol_files(ref)
    assert names == _gol_files(mine)
    assert names == ["n.gol", "n_0_0.gol", "n_10_0.gol", "n_12_0.gol",
                     "n_5_0.gol"]
    match, mismatch, errors = filecmp.cmpfiles(ref, mine, names, shallow=False)
    assert mismatch == [] and errors == []


def test_cli_serial_backend_and_reports(tmp_path):
    common = ["32", "32", "4", "8", "t", "1", "--save", "--name", "s",
              "--quiet"]
    assert port_main(common + ["--backend", "serial",
                               "--out-dir", str(tmp_path)]) == 0
    assert jax_main(common + ["--backend", "serial",
                              "--out-dir", str(tmp_path / "r")]) == 0
    for f in ("s.gol", "s_8_0.gol"):
        assert filecmp.cmp(tmp_path / f, tmp_path / "r" / f, shallow=False)
    csv = (tmp_path / "t_compact.csv").read_text().splitlines()
    assert csv[0] == (tmp_path / "r" / "t_compact.csv").read_text().splitlines()[0]
    assert csv[1].startswith("32,32,1,")
    assert "Processors" in (tmp_path / "t_detailed.out").read_text()


def test_cli_resume_continues_the_run(tmp_path):
    d = str(tmp_path)
    base = ["32", "64", "6", "12", "--save", "--device", "cpu", "--quiet",
            "--out-dir", d]
    assert port_main(base + ["--name", "a"]) == 0
    assert port_main(["32", "64", "6", "6", "--save", "--device", "cpu",
                      "--quiet", "--out-dir", d, "--name", "b",
                      "--resume", "a@6"]) == 0
    assert filecmp.cmp(tmp_path / "a_12_0.gol", tmp_path / "b_12_0.gol",
                       shallow=False)
    assert (tmp_path / "b.gol").read_text() == "32 64 6 12 1\n"


@pytest.mark.parametrize("cols,rule,comm", [(48, "bosco", "4"),
                                            (64, "R3,B20-25,S18-30", "6")])
def test_cli_serves_comm_every_beyond_k2s_halo(cols, rule, comm, tmp_path):
    # 4 x 5 = 20 and 6 x 3 = 18 cells of halo, beyond K2's 16: K2 runs
    # passes of 3 and 5 generations, the same grid on one device
    d = ["--out-dir", str(tmp_path), "--device", "cpu", "--quiet",
         "--name", "n", "--save"]
    assert port_main(["32", str(cols), "4", "4", "--rule", rule,
                      "--comm-every", comm] + d) == 0
    got = golio.load_snapshot(str(tmp_path), "n", 4)
    want = evolve_np(init_tile_np(32, cols, 0), 4, rule_from_name(rule),
                     "periodic")
    np.testing.assert_array_equal(got, want)


def test_cli_refuses_what_this_slice_does_not_run(tmp_path, capsys):
    d = ["--out-dir", str(tmp_path), "--device", "cpu", "--quiet"]
    assert port_main(["32", "64", "0", "4", "--comm-every", "auto",
                      "--backend", "serial"] + d) == 2
    assert port_main(["32", "64", "0", "4", "--comm-every", "nope"] + d) == 2
    assert port_main(["32", "64", "0", "4", "--comm-every", "17"] + d) == 2
    assert port_main(["32", "64", "0", "4", "--backend", "serial",
                      "--comm-every", "2"] + d) == 2
    assert port_main(["32", "64", "0", "4", "--strict"] + d) == 2
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("kw,engine", [
    (dict(sparse_tile=32), "bit"),
    (dict(rule=BOSCO, comm_every=4), "dense"),
    (dict(cols=80, rule=BOSCO, comm_every=4), "dense"),
], ids=["sparse", "bosco-4", "bosco-4-ragged"])
def test_config_serves_what_earlier_slices_refused(kw, engine):
    cfg = GolConfig(**{**dict(rows=64, cols=64, steps=9, seed=2), **kw})
    assert port.select_engine(cfg) == engine
    want = evolve_np(init_tile_np(cfg.rows, cfg.cols, 2), 9, cfg.rule,
                     "periodic")
    np.testing.assert_array_equal(port.run_cuda(cfg, device="cpu"), want)


def test_config_refuses_other_slices():
    for kw, item in [(dict(mesh_shape=(2, 1)), "item 13"),
                     (dict(overlap=True), "item 13")]:
        with pytest.raises(ConfigError, match=item):
            GolConfig(**{**dict(rows=64, cols=64, steps=1), **kw})
    GolConfig(rows=64, cols=64, steps=1, mesh_shape=(1, 1))
    GolConfig(rows=64, cols=80, steps=1, rule=BOSCO, backend="serial")
    # radius > 1 and widths off 32 now run on K3 and K2
    GolConfig(rows=64, cols=64, steps=1, rule=BOSCO)
    GolConfig(rows=64, cols=80, steps=1, rule=BOSCO, comm_every=3)
    GolConfig(rows=64, cols=80, steps=1, comm_every=16)
    # the reference's single-device size check: rows and cols >= r x K
    with pytest.raises(ConfigError, match="ghost"):
        GolConfig(rows=8, cols=64, steps=1, comm_every=9)
    with pytest.raises(ConfigError, match="birth-on-0"):
        GolConfig(rows=8, cols=64, steps=1, comm_every=2,
                  rule=rule_from_name("B0/S8"))


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GolConfig(rows=32, cols=64, steps=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.run_cuda(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.build_engine(cfg)
    assert port.resolve_device("cpu").type == "cpu"


def test_build_raises_naming_nvcc_when_absent(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.build()
    assert _build.library_path().name.startswith("libmpi_tpu_torch_")
    # K1 and K3 are built once per rule, not into the common library
    assert [p.name for p in _build.sources()] == ["errors.cu", "stencil.cu"]
    assert {k: v.source.name for k, v in _build.PER_RULE.items()} == {
        "bit": "bitlife.cu", "ltl": "bitltl.cu"}


_FAKE_NVCC = """#!/bin/sh
out=""; src=""; shared=0
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; -shared) shared=1;; *.cu) src="$1";; esac
  shift
done
if [ $shared = 1 ]; then echo lib > "$out"; exit 0; fi
name=$(basename "$src" .cu)
if [ "$name" = "$FAIL_ON" ]; then echo "error: broken" >&2; exit 2; fi
echo "ptxas info : Compiling entry function '_ZN12_GLOBAL__N_1${#name}${name}_kernelILi5EEEvPKj' for 'sm_90a'" >&2
echo "ptxas info : Function properties for x" >&2
echo "    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads" >&2
echo "ptxas info : Used 40 registers, 384 bytes cmem[0]" >&2
echo obj > "$out"
"""


def test_build_compiles_each_source_and_keeps_the_ptxas_report(
        monkeypatch, tmp_path):
    (tmp_path / "bin").mkdir()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("FAIL_ON", "stencil")
    with pytest.raises(_build.BuildError, match="stencil.cu"):
        _build.build()
    assert list((tmp_path / "build").iterdir()) == []  # no objects left
    monkeypatch.setenv("FAIL_ON", "")
    lib = _build.build()
    assert lib == _build.library_path() and lib.read_text() == "lib\n"
    assert _build.kernel_resources(lib) == [
        {"kernel": f"{name}_kernel<5>", "stack_bytes": 16, "spill_stores": 8,
         "spill_loads": 4, "registers": 40}
        for name in ("errors", "stencil")]
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [lib.name, _build.ptxas_log(lib).name])
    other = _build.build(tmp_path / "other" / "lib.so")  # an explicit path
    assert other.read_text() == "lib\n"
    assert len(_build.kernel_resources(other)) == 2
    assert sorted(p.name for p in other.parent.iterdir()) == [
        "lib.ptxas.txt", "lib.so"]


def test_engine_ping_pong_consumes_input_and_stays_exact():
    cfg = GolConfig(rows=24, cols=96, steps=0, seed=2, comm_every=3,
                    boundary="dead", rule=rule_from_name("highlife"))
    eng = port.build_engine(cfg, device="cpu")
    g0 = eng.init_grid()
    want = bit_step_plain(g0.clone(), cfg.rule, cfg.boundary, 11)
    before = cuda_bit_step.launches
    g = eng.step(g0, 7)
    g = eng.step(g, 4)
    assert torch.equal(g, want)
    assert cuda_bit_step.launches == before  # CPU tensors launch nothing
    np.testing.assert_array_equal(
        eng.fetch(g), evolve_np(init_tile_np(24, 96, 2), 11, cfg.rule, "dead"))
    assert eng.population(g) == int(eng.fetch(g).sum())
    assert eng.step(g, 0) is g


def test_engine_takes_an_initial_grid_from_either_package():
    grid = init_tile_np(16, 64, 9)
    cfg = GolConfig(rows=16, cols=64, steps=0)
    eng = port.build_engine(cfg, device="cpu")
    t = eng.init_grid(initial=grid)
    from mpi_tpu.ops.bitlife import pack_np as jax_pack_np

    assert torch.equal(t, interop.grid_from_numpy(jax_pack_np(grid), "cpu"))
    np.testing.assert_array_equal(interop.grid_to_numpy(t), jax_pack_np(grid))
    with pytest.raises(ConfigError):
        eng.init_grid(initial=grid[:8])
    r = jax_rule_from_name("daynight")
    assert interop.rule_from_fields(r.name, r.birth, r.survive) == \
        rule_from_name("daynight")
    with pytest.raises(TypeError):
        interop.grid_from_numpy(grid, "cpu")
    assert LIFE.birth_mask == 0b1000 and LIFE.survive_mask == 0b1100


R2 = rule_from_name("R2,B10-13,S8-12")
R3 = rule_from_name("R3,B20-25,S18-30")


@pytest.mark.parametrize("kw,engine", [
    (dict(cols=64), "bit"),                                  # K1
    (dict(cols=64, comm_every=16), "bit"),
    (dict(cols=64, rule=BOSCO), "ltl"),                      # K3, k <= 8/r
    (dict(cols=64, rule=R2, comm_every=4), "ltl"),
    (dict(cols=64, rule=R3, comm_every=2), "ltl"),
    (dict(cols=64, rule=BOSCO, comm_every=3), "dense"),      # K2, k > 8/r
    (dict(cols=64, rule=R2, comm_every=8), "dense"),
    (dict(cols=80, rule=R2), "ltl"),                         # K3, padded
    (dict(cols=50, comm_every=16), "dense"),
    (dict(cols=50, rule=BOSCO, comm_every=3), "dense"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_select_engine_follows_the_reference_policy(kw, engine):
    cfg = GolConfig(**{**dict(rows=64, steps=1), **kw})
    assert port.select_engine(cfg) == engine
    eng = port.build_engine(cfg, device="cpu")
    assert (eng.kind, eng.bitpacked) == (engine, engine != "dense")
    assert eng.kernel_id == {"bit": "K1", "ltl": "K3", "dense": "K2"}[engine]
    # the table's last row: 6 x 3 cells of halo, K2 in passes of 5
    deep = GolConfig(**{**dict(rows=64, steps=1), **kw,
                        "rule": R3, "comm_every": 6})
    assert (port.select_engine(deep), port.pass_depth(deep)) == ("dense", 5)


@pytest.mark.parametrize("kw", [
    dict(cols=64, rule=BOSCO),
    dict(cols=64, rule=R2, comm_every=4),
    dict(cols=64, rule=BOSCO, comm_every=3),
    dict(cols=50, rule=R2, comm_every=3),
    dict(cols=50, comm_every=5),
], ids=["bosco-K3", "r2-K3", "bosco-K2", "r2-K2-ragged", "life-K2-ragged"])
@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_run_cuda_matches_the_serial_oracle_on_each_path(kw, boundary):
    cfg = GolConfig(rows=33, steps=11, snapshot_every=5, seed=4,
                    boundary=boundary, **kw)
    snaps, cb = _collect()
    got = port.run_cuda(cfg, snapshot_cb=cb, device="cpu")
    g = init_tile_np(cfg.rows, cfg.cols, 4)
    assert [i for i, _ in snaps] == [0, 5, 10, 11]
    for (it, tiles), n in zip(snaps, [0, 5, 5, 1]):
        g = evolve_np(g, n, cfg.rule, boundary)
        np.testing.assert_array_equal(tiles[0][1], g, err_msg=str(it))
    np.testing.assert_array_equal(got, g)


def test_run_cuda_matches_run_tpu_on_the_ltl_and_dense_paths():
    for kw in (dict(cols=64, rule=R2, comm_every=4),
               dict(cols=48, rule=BOSCO, comm_every=2)):
        kw = dict(rows=40, steps=9, seed=2, boundary="dead", **kw)
        want = run_tpu(JaxConfig(backend="tpu", mesh_shape=(1, 1), **{
            **kw, "rule": jax_rule_from_name(kw["rule"].name)}))
        np.testing.assert_array_equal(
            port.run_cuda(GolConfig(**kw), device="cpu"), want)


@pytest.mark.parametrize("boundary,rule,comm,cols", [
    ("periodic", "bosco", "1", "64"), ("dead", "bosco", "3", "64"),
    ("dead", "R2,B10-13,S8-12", "4", "64"), ("periodic", "life", "5", "50"),
    ("dead", "bosco", "2", "50"),
])
def test_cli_ltl_and_ragged_gol_files_match_reference_serial(
        tmp_path, boundary, rule, comm, cols):
    common = ["40", cols, "5", "12", "--save", "--name", "n", "--seed", "3",
              "--boundary", boundary, "--rule", rule, "--quiet"]
    ref, mine = tmp_path / "ref", tmp_path / "port"
    assert jax_main(common + ["--backend", "serial", "--out-dir", str(ref)]) == 0
    assert port_main(common + ["--device", "cpu", "--comm-every", comm,
                               "--out-dir", str(mine)]) == 0
    names = _gol_files(ref)
    assert names == _gol_files(mine) and len(names) == 5
    match, mismatch, errors = filecmp.cmpfiles(ref, mine, names, shallow=False)
    assert mismatch == [] and errors == []


@pytest.mark.parametrize("kw,plain,wrapper", [
    (dict(cols=64, rule=R2, comm_every=4), ltl_step_plain, cuda_ltl_step),
    (dict(cols=70, rule=BOSCO, comm_every=3), dense_step_plain,
     cuda_dense_step),
], ids=["ltl", "dense"])
def test_ltl_and_dense_engines_ping_pong_and_stay_exact(kw, plain, wrapper):
    cfg = GolConfig(rows=24, steps=0, seed=2, boundary="dead", **kw)
    eng = port.build_engine(cfg, device="cpu")
    g0 = eng.init_grid()
    want = g0.clone()
    for _ in range(12):
        want = plain(want, cfg.rule, cfg.boundary)
    before = wrapper.launches
    g = eng.step(g0, 7)
    g = eng.step(g, 5)
    assert torch.equal(g, want)
    assert wrapper.launches == before  # CPU tensors launch nothing
    cells = evolve_np(init_tile_np(24, cfg.cols, 2), 12, cfg.rule, "dead")
    np.testing.assert_array_equal(eng.fetch(g), cells)
    assert eng.population(g) == int(cells.sum())
    assert eng.step(g, 0) is g
    t = eng.init_grid(initial=cells)
    np.testing.assert_array_equal(eng.fetch(t), cells)
    with pytest.raises(ConfigError):
        eng.init_grid(initial=cells[:8])


def test_dense_grids_cross_between_the_packages():
    cells = init_tile_np(9, 13, 1)
    t = interop.dense_from_numpy(cells, "cpu")
    assert t.dtype == torch.uint8 and t.shape == (9, 13)
    np.testing.assert_array_equal(interop.dense_to_numpy(t), cells)
    with pytest.raises(TypeError):
        interop.dense_from_numpy(cells.astype(np.int32), "cpu")
    with pytest.raises(TypeError):
        interop.dense_to_numpy(t.to(torch.int32))
