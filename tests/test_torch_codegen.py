"""Kernel K3's per-rule code on the CPU: the emitted rule program against
the bit-sliced interval tests of both packages, its printed C++ compiled
with the host compiler, and the per-rule build's library names and
errors.  Rules come from a seed with numpy."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu.ops import bitltl as jltl
from mpi_tpu_torch.models.rules import BOSCO, Rule, rule_from_name
from mpi_tpu_torch.ops import _build
from mpi_tpu_torch.ops import bitltl as tltl
from mpi_tpu_torch.ops import ltl_codegen as cg

NAMED = ["bosco", "R2,B10-13,S8-12", "R3,B20-25,S18-30", "R4,B30-40,S25-50",
         "R6,B50-70,S40-90", "R7,B80-100,S75-119", "R4,B0-3+40,S1-80",
         "R2,B,S", "R3,B5-9,S", "R5,B,S0-120", "R7,B0-224,S0-224"]


def _random_rules(seed, n=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = int(rng.integers(2, 8))
        top = (2 * r + 1) ** 2
        out.append(Rule("fuzz", frozenset(np.flatnonzero(rng.random(top) < 0.3)
                                          .tolist()),
                        frozenset(np.flatnonzero(rng.random(top) < 0.4)
                                  .tolist()), r))
    return out


RULES = [rule_from_name(n) for n in NAMED] + _random_rules(3)


def _totals(r):
    """Every total 0..(2r+1)² as planes of one-cell-per-bit words: bit j
    of word t is total t if j is even, with the centre's state in mid."""
    top = (2 * r + 1) ** 2
    tot = np.arange(top + 1, dtype=np.uint32)
    planes = [np.where((tot >> k) & 1, np.uint32(0xFFFFFFFF), np.uint32(0))
              .astype(np.uint32) for k in range(cg.planes(r))]
    return tot, planes


def _want(rule, tot, alive):
    counts = tot.astype(np.int64) - alive
    keep = rule.survive if alive else rule.birth
    return np.array([c in keep for c in counts])


@pytest.mark.parametrize("rule", RULES, ids=lambda r: cg.rule_key(r))
def test_rule_program_equals_the_interval_tests(rule):
    tot, planes = _totals(rule.radius)
    prog = cg.rule_program(rule)
    zero = np.zeros_like(tot)
    jrule = jax_rule_from_name(cg.rule_key(rule))
    for alive in (0, 1):
        mid = np.full_like(tot, 0xFFFFFFFF * alive)
        got = cg.evaluate(prog, planes, mid)
        shift = alive  # survive intervals are tested on the total at +1
        ivs = rule.survive_intervals if alive else rule.birth_intervals
        port = tltl._in_intervals(planes, ivs, shift, zero)
        ref = np.asarray(jltl._in_intervals(planes, ivs, shift,
                                            np.zeros_like(tot)))
        want = _want(rule, tot, alive)
        live = slice(alive, None)  # a live centre makes a total >= 1
        np.testing.assert_array_equal(got[live] == 0xFFFFFFFF, want[live])
        np.testing.assert_array_equal(got[live], port[live])
        np.testing.assert_array_equal(got[live], ref[live])
        assert jrule.birth == rule.birth and jrule.survive == rule.survive


def test_rule_program_tests_survival_shifted_by_one():
    rule = rule_from_name("R2,B3-4+9,S0+7-8")
    tot, planes = _totals(2)
    prog = cg.rule_program(rule)
    born = cg.evaluate(prog, planes, np.zeros_like(tot)) != 0
    stay = cg.evaluate(prog, planes, np.full_like(tot, 0xFFFFFFFF)) != 0
    assert np.flatnonzero(born).tolist() == [3, 4, 9]
    assert np.flatnonzero(stay).tolist() == [1, 8, 9]
    assert cg.rule_program(rule_from_name("R2,B,S")).ops == ()
    assert cg.rule_program(rule_from_name("R2,B,S")).result == cg.ZERO


def test_rule_key_and_planes():
    assert cg.rule_key(BOSCO) == "R5,B34-45,S33-57"
    assert cg.rule_key(rule_from_name("R2,B3-4+9,S0+7-8")) == "R2,B3-4+9,S0+7-8"
    assert cg.rule_key(rule_from_name("R3,B,S")) == "R3,B,S"
    assert [cg.planes(r) for r in range(2, 8)] == [5, 6, 7, 7, 8, 8]
    # against constant thresholds each comparison folds to a gate a plane
    assert cg.lop3_count(cg.rule_program(BOSCO)) <= 25
    assert cg.lop3_count(cg.rule_program(rule_from_name("R2,B10-13,S8-12"))) \
        <= 20
    assert "#define LTL_RULE_PLANES 7" in cg.rule_header(BOSCO)


_HOST = """
#include <cstdint>
#define __device__
#define __forceinline__ inline
#include "rule.cuh"
extern "C" void run(const uint32_t* planes, const uint32_t* mid,
                    uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    uint32_t T[LTL_RULE_PLANES];
    for (int k = 0; k < LTL_RULE_PLANES; ++k) T[k] = planes[k * n + i];
    out[i] = ltl_rule(T, mid[i]);
  }
}
"""


@pytest.mark.parametrize("seed", [0, 1])
def test_printed_rule_compiles_and_agrees(tmp_path, seed):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine to compile the printed rule")
    rules = [BOSCO, rule_from_name("R2,B,S"),
             rule_from_name("R4,B0-3+40,S1-80")] + _random_rules(seed, 3)
    for i, rule in enumerate(rules):
        d = tmp_path / str(i)
        d.mkdir()
        (d / "rule.cuh").write_text(cg.rule_header(rule))
        (d / "host.cpp").write_text(_HOST)
        lib = d / "rule.so"
        proc = subprocess.run([gxx, "-O1", "-shared", "-fPIC", "-o", str(lib),
                               str(d / "host.cpp")], capture_output=True,
                              text=True)
        assert proc.returncode == 0, proc.stderr
        run = ctypes.CDLL(str(lib)).run
        run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
        rng = np.random.default_rng(seed + i)
        n = 64
        planes = rng.integers(0, 2**32, size=(cg.planes(rule.radius), n),
                              dtype=np.uint32)
        mid = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        out = np.zeros(n, dtype=np.uint32)
        run(planes.ctypes.data, mid.ctypes.data, out.ctypes.data, n)
        want = cg.evaluate(cg.rule_program(rule), list(planes), mid)
        np.testing.assert_array_equal(out, want, err_msg=cg.rule_key(rule))


def test_per_rule_library_path_follows_the_rule_not_its_name():
    same = Rule("other-name", BOSCO.birth, BOSCO.survive, 5)
    path = _build.rule_library_path
    assert path("ltl", same) == path("ltl", BOSCO)
    assert path("ltl", BOSCO).name.startswith("libmpi_tpu_torch_ltl_r5_")
    paths = {path("ltl", r) for r in RULES}
    assert len(paths) == len({cg.rule_key(r) for r in RULES})
    # a build variant (K3's run length) is a library of its own
    assert path("ltl", BOSCO, {"K3_ROWS": 64}) != \
        path("ltl", BOSCO, {"K3_ROWS": 128}) != path("ltl", BOSCO)
    assert path("ltl", BOSCO).parent == _build.BUILD_DIR
    assert [p.name for p in _build.sources()] == ["errors.cu", "stencil.cu"]


def test_per_rule_build_raises_naming_nvcc_when_absent(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.build_rules("ltl", [BOSCO])
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.load_rule_library("ltl", rule_from_name("R3,B20-25,S18-30"))


_FAKE_NVCC = """#!/bin/sh
out=""; src=""; radius=""; header=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift;;
    -DLTL_RADIUS=*) radius="${1#-DLTL_RADIUS=}";;
    -DLTL_RULE_HEADER=*) header="${1#-DLTL_RULE_HEADER=}";;
    *.cu) src="$1";;
  esac
  shift
done
if [ "$radius" = "$FAIL_ON" ]; then echo "error: broken radius" >&2; exit 2; fi
echo "ptxas info : Compiling entry function '_ZN12_GLOBAL__N_115ltl_step_kernelEPKjPjiiii' for 'sm_90a'" >&2
echo "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" >&2
echo "ptxas info : Used 64 registers" >&2
echo "$radius $header $(basename $src)" > "$out"
"""


def test_per_rule_build_runs_in_parallel_and_reports_failures(
        monkeypatch, tmp_path):
    (tmp_path / "bin").mkdir()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("FAIL_ON", "3")
    rules = [BOSCO, rule_from_name("R2,B10-13,S8-12"),
             rule_from_name("R3,B20-25,S18-30")]
    before = _build.builds
    with pytest.raises(_build.BuildError, match="R3|broken radius"):
        _build.build_rules("ltl", rules, jobs=2)
    assert _build.builds - before == 3
    built = sorted(p.name for p in (tmp_path / "build").glob("*.so"))
    assert len(built) == 2  # the two rules that compiled are kept
    monkeypatch.setenv("FAIL_ON", "")
    libs = _build.build_rules("ltl", rules + [BOSCO], jobs=2)
    assert _build.builds - before == 4  # only the failed rule again
    assert libs[0] == libs[3] == _build.rule_library_path("ltl", BOSCO)
    radius, header, src = libs[2].read_text().split()
    assert (radius, src) == ("3", "bitltl.cu")
    assert (tmp_path / "build" / header).read_text() == \
        cg.rule_header(rules[2])
    assert _build.kernel_resources(libs[1]) == [
        {"kernel": "ltl_step_kernel", "stack_bytes": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 64}]
    assert not list((tmp_path / "build").glob("*.tmp*"))
