"""The port's native backends (``mpi_tpu_torch/backends/cpp.py`` and its own
``backends/native`` build) on the CPU: the scenarios of the reference's
``tests/test_cpp.py`` against the port's ctypes bindings and its own
``gol_native`` binary, grids equal to the oracle; the port's CLI with
``--backend cpp`` and ``--backend cpp-par`` writing ``.gol`` files byte for
byte equal to the reference CLI's on the same arguments; ``run_serial``;
and ``cpp``/``cpp-par`` sessions of the port's ``SessionManager`` equal to
the oracle.  Every comparison is exact."""

import os
import re
import subprocess

import numpy as np
import pytest

from mpi_tpu.backends.serial_np import evolve_np as jax_evolve_np
from mpi_tpu.cli import main as jax_main
from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu_torch import golio
from mpi_tpu_torch.backends import cpp
from mpi_tpu_torch.backends.cpp import (
    evolve_cpp, evolve_par_cpp, init_tile_cpp, plan_tiles, step_cpp,
)
from mpi_tpu_torch.backends.serial_np import evolve_np, run_serial, step_np
from mpi_tpu_torch.cli import main
from mpi_tpu_torch.config import GolConfig
from mpi_tpu_torch.models.rules import (
    BOSCO, HIGHLIFE, LIFE, Rule, rule_from_name,
)
from mpi_tpu_torch.serve import SessionManager
from mpi_tpu_torch.utils.hashinit import init_tile_np
from mpi_tpu_torch.utils.timing import PhaseTimer, write_reports

REPO = os.path.join(os.path.dirname(__file__), os.pardir)


def test_the_port_builds_and_loads_its_own_native_files():
    lib = cpp.load_library()
    assert os.path.realpath(lib._name) == os.path.realpath(cpp.SO_PATH)
    native = os.path.realpath(cpp.NATIVE_DIR)
    assert native == os.path.realpath(
        os.path.join(REPO, "mpi_tpu_torch", "backends", "native"))
    cpp.build_native()
    assert os.path.realpath(cpp.BIN_PATH).startswith(native + os.sep)
    for f in ("golcore.cpp", "gol_main.cpp", "Makefile"):
        assert os.path.exists(os.path.join(native, f))
    # a build leaves no temporary directory behind
    assert not [f for f in os.listdir(native) if f.startswith(".build-")]


def test_a_stale_library_is_rebuilt_under_the_lock(tmp_path, monkeypatch):
    """The rebuild-on-mtime rule, on a copy of the sources: a source newer
    than the built files rebuilds both, and an up-to-date tree builds
    nothing."""
    import shutil

    d = tmp_path / "native"
    d.mkdir()
    for f in ("golcore.cpp", "gol_main.cpp", "Makefile"):
        shutil.copy2(os.path.join(cpp.NATIVE_DIR, f), d / f)
    monkeypatch.setattr(cpp, "NATIVE_DIR", str(d))
    monkeypatch.setattr(cpp, "SO_PATH", str(d / "libgolcore.so"))
    monkeypatch.setattr(cpp, "BIN_PATH", str(d / "gol_native"))
    assert cpp._stale()
    cpp.build_native()
    assert not cpp._stale()
    so = (d / "libgolcore.so").stat().st_mtime_ns
    cpp.build_native()                  # up to date: nothing runs
    assert (d / "libgolcore.so").stat().st_mtime_ns == so
    os.utime(d / "golcore.cpp", ns=(so + 10**9, so + 10**9))
    assert cpp._stale()
    cpp.build_native()
    assert not cpp._stale()
    assert sorted(os.listdir(d)) == ["Makefile", "gol_main.cpp",
                                     "gol_native", "golcore.cpp",
                                     "libgolcore.so"]


def test_concurrent_builders_install_one_whole_library(tmp_path):
    """Four processes asking for a stale build at once: one builds, the
    others wait on the lock and find it fresh; every one loads a whole
    library, and no temporary directory is left."""
    import shutil
    import sys

    d = tmp_path / "native"
    d.mkdir()
    for f in ("golcore.cpp", "gol_main.cpp", "Makefile"):
        shutil.copy2(os.path.join(cpp.NATIVE_DIR, f), d / f)
    code = (
        "import ctypes, sys\n"
        "import mpi_tpu_torch.backends.cpp as c\n"
        "d = sys.argv[1]\n"
        "c.NATIVE_DIR, c.SO_PATH, c.BIN_PATH = d, d + '/libgolcore.so', "
        "d + '/gol_native'\n"
        "c.build_native()\n"
        "ctypes.CDLL(c.SO_PATH).gol_init\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(d)], env=env,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    assert sorted(os.listdir(d)) == ["Makefile", "gol_main.cpp",
                                     "gol_native", "golcore.cpp",
                                     "libgolcore.so"]


# -- the ctypes bindings against the oracle ---------------------------------

def test_cpp_init_matches_numpy():
    a = init_tile_cpp(37, 53, seed=42)
    np.testing.assert_array_equal(a, init_tile_np(37, 53, seed=42))


def test_cpp_init_offsets():
    a = init_tile_cpp(16, 16, seed=7, row_offset=100, col_offset=200)
    np.testing.assert_array_equal(
        a, init_tile_np(16, 16, seed=7, row_offset=100, col_offset=200))


@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_cpp_step_parity(boundary):
    g = init_tile_np(33, 47, seed=3)
    np.testing.assert_array_equal(step_cpp(g, LIFE, boundary),
                                  step_np(g, LIFE, boundary))


@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_cpp_evolve_parity(boundary):
    g = init_tile_np(64, 64, seed=5)
    np.testing.assert_array_equal(evolve_cpp(g, 50, LIFE, boundary),
                                  evolve_np(g, 50, LIFE, boundary))


def test_cpp_bosco_parity():
    g = init_tile_np(48, 48, seed=11)
    np.testing.assert_array_equal(evolve_cpp(g, 4, BOSCO, "periodic"),
                                  evolve_np(g, 4, BOSCO, "periodic"))


@pytest.mark.parametrize("tiles", [(1, 1), (2, 2), (4, 2), (1, 8), (8, 1)])
@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_cpp_parallel_matches_serial(tiles, boundary):
    g = init_tile_np(64, 64, seed=17)
    np.testing.assert_array_equal(
        evolve_par_cpp(g, 30, LIFE, boundary, tiles=tiles),
        evolve_np(g, 30, LIFE, boundary))


@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_cpp_parallel_deep_halo(boundary):
    g = init_tile_np(48, 48, seed=23)
    np.testing.assert_array_equal(
        evolve_par_cpp(g, 3, BOSCO, boundary, tiles=(2, 4)),
        evolve_np(g, 3, BOSCO, boundary))


def test_cpp_parallel_odd_steps():
    g = init_tile_np(32, 32, seed=29)
    np.testing.assert_array_equal(
        evolve_par_cpp(g, 7, LIFE, "periodic", tiles=(2, 2)),
        evolve_np(g, 7, LIFE, "periodic"))


def test_cpp_parallel_auto_workers():
    g = init_tile_np(60, 60, seed=31)
    np.testing.assert_array_equal(evolve_par_cpp(g, 10, HIGHLIFE, "periodic"),
                                  evolve_np(g, 10, HIGHLIFE, "periodic"))


def test_cpp_parallel_rejects_bad_mesh():
    g = init_tile_np(33, 33, seed=0)
    with pytest.raises(ValueError, match="rejected tile mesh 2x2"):
        evolve_par_cpp(g, 1, LIFE, "periodic", tiles=(2, 2))


@pytest.mark.parametrize("shape,workers,radius", [
    ((64, 64), 8, 1), ((60, 60), 16, 1), ((33, 33), 4, 1), ((48, 48), 8, 5),
    ((8, 8), 16, 5), ((2048, 2048), 8, 1), ((24, 24), 9, 1)])
def test_plan_tiles_matches_the_reference(shape, workers, radius):
    from mpi_tpu.backends.cpp import plan_tiles as jax_plan_tiles

    assert plan_tiles(shape, workers, radius) == jax_plan_tiles(
        shape, workers, radius)


@pytest.mark.parametrize("n", [1, 2, 6, 8, 9, 12, 16, 17, 64])
def test_choose_mesh_shape_matches_the_reference(n):
    from mpi_tpu.parallel.mesh import choose_mesh_shape as jax_shape
    from mpi_tpu_torch.parallel.mesh import choose_mesh_shape

    assert choose_mesh_shape(n) == jax_shape(n)


@pytest.mark.parametrize("boundary", ["periodic", "dead"])
@pytest.mark.parametrize("rule_name", ["life", "highlife", "seeds", "daynight"])
def test_cpp_swar_rules_parity(rule_name, boundary):
    rule = rule_from_name(rule_name)
    g = init_tile_np(96, 128, seed=11)  # 128 % 64 == 0: the packed path
    np.testing.assert_array_equal(evolve_cpp(g, 9, rule, boundary),
                                  evolve_np(g, 9, rule, boundary))


@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_cpp_swar_matches_byte_engine(boundary):
    g = init_tile_np(64, 128, seed=13)
    byte_result = g
    for _ in range(7):
        byte_result = step_cpp(byte_result, LIFE, boundary)
    np.testing.assert_array_equal(evolve_cpp(g, 7, LIFE, boundary),
                                  byte_result)
    g_byte = init_tile_np(64, 96, seed=13)
    np.testing.assert_array_equal(evolve_cpp(g_byte, 7, LIFE, boundary),
                                  evolve_np(g_byte, 7, LIFE, boundary))


@pytest.mark.parametrize("workers", [(1, 3), (4, 1), (2, 2)])
def test_cpp_swar_parallel_bands(workers):
    g = init_tile_np(64, 192, seed=17)
    np.testing.assert_array_equal(
        evolve_par_cpp(g, 8, LIFE, "periodic", tiles=workers),
        evolve_np(g, 8, LIFE, "periodic"))


def test_cpp_swar_parallel_more_workers_than_rows():
    g = init_tile_np(4, 64, seed=19)
    np.testing.assert_array_equal(
        evolve_par_cpp(g, 5, LIFE, "dead", tiles=(4, 2)),
        evolve_np(g, 5, LIFE, "dead"))


def test_cpp_swar_single_column_word_wrap():
    g = init_tile_np(32, 64, seed=23)
    np.testing.assert_array_equal(evolve_cpp(g, 10, LIFE, "periodic"),
                                  evolve_np(g, 10, LIFE, "periodic"))


@pytest.mark.parametrize("boundary", ["periodic", "dead"])
@pytest.mark.parametrize("steps", [2, 8, 10, 23])
def test_cpp_swar_temporal_blocking(monkeypatch, boundary, steps):
    monkeypatch.setenv("GOLCORE_SWAR_BLOCK_THRESHOLD", "0")
    g = init_tile_np(96, 128, seed=29)
    np.testing.assert_array_equal(evolve_cpp(g, steps, LIFE, boundary),
                                  evolve_np(g, steps, LIFE, boundary))


@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_cpp_swar_temporal_blocking_parallel(monkeypatch, boundary):
    monkeypatch.setenv("GOLCORE_SWAR_BLOCK_THRESHOLD", "0")
    g = init_tile_np(1088, 128, seed=31)
    np.testing.assert_array_equal(
        evolve_par_cpp(g, 11, LIFE, boundary, tiles=(2, 2)),
        evolve_np(g, 11, LIFE, boundary))


def test_cpp_swar_temporal_blocking_multiblock_serial(monkeypatch):
    monkeypatch.setenv("GOLCORE_SWAR_BLOCK_THRESHOLD", "0")
    g = init_tile_np(520, 128, seed=37)
    np.testing.assert_array_equal(evolve_cpp(g, 16, LIFE, "periodic"),
                                  evolve_np(g, 16, LIFE, "periodic"))


@pytest.mark.parametrize("rule", [
    BOSCO, rule_from_name("R2,B10-13,S8-12"),
    Rule("r7", frozenset(range(80, 101)), frozenset(range(75, 120)),
         radius=7)], ids=lambda r: r.name)
@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_cpp_ltl_bitsliced_path_matches_oracle(rule, boundary):
    g = init_tile_np(48, 192, seed=3)
    np.testing.assert_array_equal(evolve_cpp(g, 4, rule, boundary),
                                  evolve_np(g, 4, rule, boundary))


def test_cpp_ltl_small_rows_fall_back_to_byte_engine():
    g = init_tile_np(8, 128, seed=9)
    np.testing.assert_array_equal(evolve_cpp(g, 3, BOSCO, "periodic"),
                                  evolve_np(g, 3, BOSCO, "periodic"))


@pytest.mark.parametrize("kw", [
    dict(rows=32, cols=48, steps=9), dict(rows=40, cols=40, steps=3,
                                          rule=BOSCO, boundary="dead")])
def test_run_serial_matches_the_reference(kw):
    from mpi_tpu.backends.serial_np import run_serial as jax_run_serial
    from mpi_tpu.config import GolConfig as JaxConfig

    got = run_serial(GolConfig(seed=6, backend="serial", **kw))
    rule = jax_rule_from_name("bosco" if kw.get("rule") else "life")
    want = jax_run_serial(JaxConfig(seed=6, backend="serial",
                                    **dict(kw, rule=rule)))
    np.testing.assert_array_equal(got, want)


# -- the CLI against the reference's, byte for byte ---------------------------

CLI_CASES = [
    # rows cols gap iters, then flags; the scenarios of the binding tests
    (["33", "47", "5", "10"], []),
    (["33", "47", "5", "10"], ["--boundary", "dead"]),
    (["64", "64", "25", "50"], []),
    (["48", "48", "2", "4"], ["--rule", "bosco"]),
    (["48", "48", "8", "8"], ["--rule", "bosco", "--workers", "4"]),
    (["64", "64", "10", "30"], ["--workers", "8", "--boundary", "dead"]),
    (["60", "60", "5", "10"], ["--rule", "highlife", "--workers", "16"]),
    (["96", "128", "3", "9"], ["--rule", "seeds", "--workers", "4"]),
    (["48", "192", "2", "4"], ["--rule", "R2,B10-13,S8-12", "--workers", "6"]),
    (["32", "32", "8", "8"], ["--workers", "4", "--snapshot-format", "golp"]),
]


def _run_cli(fn, tmp, name, args, flags, backend):
    rc = fn(args + flags + ["--backend", backend, "--save", "--seed", "7",
                            "--name", name, "--out-dir", str(tmp),
                            "--quiet"])
    assert rc == 0


def _gol_files(d, name):
    return sorted(f for f in os.listdir(d)
                  if re.match(rf"{name}(_\d+_\d+)?\.gol", f)
                  or f.endswith(".golp"))


@pytest.mark.parametrize("backend", ["cpp", "cpp-par"])
@pytest.mark.parametrize("args,flags", CLI_CASES,
                         ids=lambda v: "-".join(v) if v else "default")
def test_cli_gol_bytes_equal_the_reference_cli(tmp_path, backend, args, flags):
    if backend == "cpp":
        flags = [f for i, f in enumerate(flags) if f != "--workers"
                 and (i == 0 or flags[i - 1] != "--workers")]
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    _run_cli(jax_main, tmp_path / "ref", "r", args, flags, backend)
    _run_cli(main, tmp_path / "port", "r", args, flags, backend)
    ref = _gol_files(tmp_path / "ref", "r")
    assert ref and ref == _gol_files(tmp_path / "port", "r")
    for f in ref:
        assert ((tmp_path / "ref" / f).read_bytes()
                == (tmp_path / "port" / f).read_bytes()), f


def test_cpp_par_header_counts_its_tiles(tmp_path):
    _run_cli(main, tmp_path, "par", ["64", "64", "4", "4"],
             ["--workers", "8"], "cpp-par")
    _run_cli(main, tmp_path, "one", ["64", "64", "4", "4"], [], "cpp")
    par = golio.read_master(golio.master_path(str(tmp_path), "par"))
    one = golio.read_master(golio.master_path(str(tmp_path), "one"))
    assert par[:4] == one[:4] and one[4] == 1
    assert par[4] == 8 == len(golio.iteration_tile_pids(str(tmp_path),
                                                         "par", 4))
    np.testing.assert_array_equal(
        golio.load_snapshot(str(tmp_path), "par", 4),
        golio.load_snapshot(str(tmp_path), "one", 4))


@pytest.mark.parametrize("argv,message", [
    (["32", "16", "8", "4", "--strict", "--backend", "cpp"], "square"),
    (["32", "32", "8", "4", "--strict", "--backend", "cpp-par",
      "--workers", "2"], "perfect square mesh (effective mesh 1x2)"),
    (["8", "8", "8", "4", "--strict", "--backend", "cpp-par",
      "--workers", "16"], ">= 4 cells per side"),
])
def test_cli_strict_judges_the_tile_plan_as_the_reference(
        tmp_path, capsys, argv, message):
    argv = argv + ["--out-dir", str(tmp_path), "--quiet"]
    assert jax_main(argv) == 2
    want = capsys.readouterr().err
    assert main(argv) == 2
    got = capsys.readouterr().err
    assert message in got and got == want


def test_cli_strict_accepts_a_square_tile_plan(tmp_path):
    assert main(["32", "32", "8", "4", "--strict", "--backend", "cpp-par",
                 "--workers", "4", "--out-dir", str(tmp_path),
                 "--quiet"]) == 0


def test_cli_native_resume_round_trip(tmp_path):
    _run_cli(main, tmp_path, "full", ["32", "32", "8", "16"], [], "cpp")
    _run_cli(main, tmp_path, "half", ["32", "32", "8", "8"],
             ["--workers", "4"], "cpp-par")
    assert main(["32", "32", "8", "8", "--backend", "cpp-par", "--workers",
                 "4", "--save", "--resume", "half@8", "--out-dir",
                 str(tmp_path), "--quiet"]) == 0
    np.testing.assert_array_equal(
        golio.load_snapshot(str(tmp_path), "half", 16),
        golio.load_snapshot(str(tmp_path), "full", 16))


# -- the port's own gol_native binary ------------------------------------------

def _run_native(out_dir, *args):
    cpp.build_native()
    return subprocess.run([cpp.BIN_PATH, *args, "--out-dir", str(out_dir)],
                          capture_output=True, text=True, timeout=300)


def test_gol_native_bosco_workers_matches_python(tmp_path):
    r = _run_native(tmp_path, "48", "48", "8", "8", "--rule", "bosco",
                    "--workers", "4", "--save", "--seed", "7",
                    "--name", "nat")
    assert r.returncode == 0, r.stderr
    assert main(["48", "48", "8", "8", "--backend", "cpp-par", "--workers",
                 "4", "--rule", "bosco", "--save", "--seed", "7", "--name",
                 "py", "--out-dir", str(tmp_path), "--quiet"]) == 0
    assert golio.read_master(golio.master_path(str(tmp_path), "nat"))[4] == 4
    for it in (0, 8):
        for pid in range(4):
            assert ((tmp_path / f"nat_{it}_{pid}.gol").read_bytes()
                    == (tmp_path / f"py_{it}_{pid}.gol").read_bytes())


def test_gol_native_rule_string_grammar(tmp_path):
    for name, rule in (("bs", "B36/S23"), ("hl", "highlife")):
        r = _run_native(tmp_path, "32", "32", "8", "8", "--rule", rule,
                        "--save", "--seed", "3", "--name", name)
        assert r.returncode == 0, r.stderr
    np.testing.assert_array_equal(golio.load_snapshot(str(tmp_path), "bs", 8),
                                  golio.load_snapshot(str(tmp_path), "hl", 8))
    r = _run_native(tmp_path, "32", "32", "8", "4", "--rule",
                    "R2,B10-13,S8-12", "--save", "--seed", "5", "--name", "r2")
    assert r.returncode == 0, r.stderr
    want = jax_evolve_np(init_tile_np(32, 32, seed=5), 4,
                         jax_rule_from_name("R2,B10-13,S8-12"), "periodic")
    np.testing.assert_array_equal(golio.load_snapshot(str(tmp_path), "r2", 4),
                                  want)


@pytest.mark.parametrize("bad", ["nope", "R9,B1,S1", "R2,B999,S1", "B9/S23",
                                 "R2,B1a,S2"])
def test_gol_native_rejects_bad_rules(tmp_path, bad):
    r = _run_native(tmp_path, "16", "16", "4", "4", "--rule", bad)
    assert r.returncode == 2, f"{bad}: rc={r.returncode}\n{r.stderr}"


def test_gol_native_detailed_report_layout(tmp_path):
    r = _run_native(tmp_path, "32", "32", "8", "8", "nat", "1",
                    "--workers", "4", "--seed", "3", "--name", "n")
    assert r.returncode == 0, r.stderr
    nat = (tmp_path / "nat_detailed.out").read_text().splitlines()
    t = PhaseTimer()
    t.setup_done()
    t.finish()
    write_reports("py", t, 32, 32, 4, out_dir=str(tmp_path))
    py = (tmp_path / "py_detailed.out").read_text().splitlines()

    def strip(s):
        return re.sub(r"\d+", "#", s)

    assert [strip(x) for x in nat] == [strip(x) for x in py]
    row = (tmp_path / "nat_compact.csv").read_text().splitlines()[-1]
    nos_avg, nos_sum = (int(v) for v in row.split(",")[7:9])
    assert nos_sum >= nos_avg * 4 - 4 and nos_avg > 0


def test_gol_native_avg_over_active_workers(tmp_path):
    r = _run_native(tmp_path, "8", "2048", "200", "400", "cap", "1",
                    "--workers", "16", "--seed", "3", "--name", "c")
    assert r.returncode == 0, r.stderr
    row = (tmp_path / "cap_compact.csv").read_text().splitlines()[-1]
    row = row.split(",")
    p, nos_avg, nos_sum = int(row[2]), int(row[7]), int(row[8])
    assert p == 16 and nos_avg > 8
    active = round(nos_sum / nos_avg)
    assert active <= 8, (nos_sum, nos_avg)
    assert abs(nos_sum - nos_avg * active) <= active


@pytest.mark.parametrize("fmt", ["gol", "golp"])
def test_gol_native_resume_roundtrip(tmp_path, fmt):
    for args in (["32", "32", "8", "16", "--save", "--seed", "5",
                  "--name", "full"],
                 ["32", "32", "8", "8", "--save", "--seed", "5", "--name",
                  "half", "--snapshot-format", fmt],
                 ["32", "32", "8", "8", "--save", "--resume", "half@8"]):
        r = _run_native(tmp_path, *args)
        assert r.returncode == 0, r.stderr
    np.testing.assert_array_equal(
        golio.load_snapshot(str(tmp_path), "half", 16),
        golio.load_snapshot(str(tmp_path), "full", 16))
    assert golio.read_master(golio.master_path(str(tmp_path), "half"))[3] == 16


def test_gol_native_resume_python_snapshot(tmp_path):
    assert main(["32", "32", "8", "8", "--backend", "serial", "--save",
                 "--snapshot-format", "golp", "--out-dir", str(tmp_path),
                 "--name", "py", "--seed", "5", "--quiet"]) == 0
    r = _run_native(tmp_path, "32", "32", "8", "8", "--save",
                    "--resume", "py@8")
    assert r.returncode == 0, r.stderr
    np.testing.assert_array_equal(
        golio.load_snapshot(str(tmp_path), "py", 16),
        evolve_np(init_tile_np(32, 32, 5), 16, LIFE, "periodic"))


@pytest.mark.parametrize("args,message", [
    (["32", "16", "8", "4", "--strict"], "square"),
    (["32", "32", "8", "4", "--strict", "--workers", "2"], "perfect square"),
    (["8", "8", "8", "4", "--strict", "--workers", "16"], ">= 4"),
    (["32", "32", "8", "4", "--strict", "--workers", "4", "--name", "ok"],
     None),
])
def test_gol_native_strict(tmp_path, args, message):
    r = _run_native(tmp_path, *args)
    if message is None:
        assert r.returncode == 0, r.stderr
    else:
        assert r.returncode == 2 and message in r.stderr


def test_gol_native_resume_errors(tmp_path):
    r = _run_native(tmp_path, "32", "32", "8", "4", "--resume", "nope")
    assert r.returncode == 2 and "NAME@ITER" in r.stderr
    r = _run_native(tmp_path, "32", "32", "8", "4", "--resume", "ghost@8")
    assert r.returncode == 2 and "cannot resume" in r.stderr
    r = _run_native(tmp_path, "32", "32", "8", "4", "--save", "--name", "m",
                    "--seed", "1")
    assert r.returncode == 0
    r = _run_native(tmp_path, "32", "32", "8", "4", "--resume", "m@999")
    assert r.returncode == 2 and "no tile files" in r.stderr
    r = _run_native(tmp_path, "64", "64", "8", "4", "--resume", "m@4")
    assert r.returncode == 2 and "asks for" in r.stderr


def test_gol_native_resume_prunes_stale_wider_run_tiles(tmp_path):
    for args in (["24", "24", "8", "16", "--save", "--seed", "3", "--name",
                  "w", "--workers", "9"],
                 ["24", "24", "8", "8", "--save", "--resume", "w@8",
                  "--workers", "4"],
                 ["24", "24", "8", "16", "--save", "--seed", "3", "--name",
                  "ref", "--workers", "1"]):
        r = _run_native(tmp_path, *args)
        assert r.returncode == 0, r.stderr
    assert golio.iteration_tile_pids(str(tmp_path), "w", 16) == [0, 1, 2, 3]
    np.testing.assert_array_equal(
        golio.load_snapshot(str(tmp_path), "w", 16),
        golio.load_snapshot(str(tmp_path), "ref", 16))


# -- sessions on the native backends -------------------------------------------

@pytest.mark.parametrize("backend", ["cpp", "cpp-par"])
@pytest.mark.parametrize("spec", [
    dict(rows=64, cols=64), dict(rows=48, cols=40, rule="bosco",
                                 boundary="dead")], ids=["life", "bosco"])
def test_native_sessions_equal_the_oracle(backend, spec):
    mgr = SessionManager(device="cpu")
    try:
        sid = mgr.create(dict(spec, backend=backend, seed=12))["id"]
        for n in (1, 4, 2):
            mgr.step(sid, n)
        t = mgr.step_async(sid, 3)["ticket"]
        assert mgr.ticket_result(t, wait=True)["result"]["generation"] == 10
        want = evolve_np(init_tile_np(spec["rows"], spec["cols"], 12), 10,
                         rule_from_name(spec.get("rule", "life")),
                         spec.get("boundary", "periodic"))
        np.testing.assert_array_equal(mgr.snapshot_array(sid)[0], want)
        d = mgr.describe(mgr.get(sid))
        assert d["backend"] == backend and "engine_compiles" not in d
        assert mgr.get(sid).engine is None
    finally:
        mgr.shutdown()


def test_native_sessions_restore_from_a_state_dir(tmp_path):
    m1 = SessionManager(device="cpu", state_dir=str(tmp_path),
                        checkpoint_every=2)
    sid = m1.create({"rows": 32, "cols": 64, "backend": "cpp-par",
                     "seed": 3})["id"]
    m1.step(sid, 5)
    m1.shutdown()
    m2 = SessionManager(device="cpu", state_dir=str(tmp_path))
    try:
        assert m2.restored_sessions == 1 and m2.get(sid).generation == 5
        np.testing.assert_array_equal(
            m2.snapshot_array(sid)[0],
            evolve_np(init_tile_np(32, 64, 3), 5, LIFE, "periodic"))
    finally:
        m2.shutdown()
