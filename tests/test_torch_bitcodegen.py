"""Kernel K1's per-rule code on the CPU: the emitted rule program against
``bit_next`` of the port and ``bit_step`` of the JAX package, its printed
C++ compiled with the host compiler, its instruction count, and the shared
per-rule build's library names and errors for K1 and K3.  Rules and words
come from a seed with numpy; everything is exact (integer state)."""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu.ops import bitlife as jbit
from mpi_tpu_torch import interop
from mpi_tpu_torch.models.rules import BOSCO, LIFE, Rule, rule_from_name
from mpi_tpu_torch.ops import _build, bit_codegen as bc, cuda_bitlife, gates
from mpi_tpu_torch.ops import bitlife as tbit

NAMED = ["life", "highlife", "seeds", "daynight", "B3678/S34678",
         "B36/S125", "B0/S8", "B012345678/S012345678", "B/S"]


def _random_names(seed, n=30):
    rng = np.random.default_rng(seed)
    out = ["B0123/S", "B/S012345678"]  # birth-on-0; "stays as it is"
    while len(out) < n:
        birth, survive = (int(v) for v in rng.integers(0, 512, size=2))
        out.append("B" + "".join(str(c) for c in range(9) if birth >> c & 1)
                   + "/S" + "".join(str(c) for c in range(9)
                                    if survive >> c & 1))
    return out


NAMES = NAMED + _random_names(7)
RULES = [rule_from_name(n) for n in NAMES]


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape,
                                                dtype=np.uint32)


def _operands(rows):
    """The seven operands of ``bit_rule`` as K1 computes them from ``rows``,
    uint32 arrays indexed [up/mid/down][previous/own/next word]."""
    f0, f1 = {}, {}
    for j in range(3):
        up, mid, down = rows[0][j], rows[1][j], rows[2][j]
        t = up ^ mid
        f0[j], f1[j] = t ^ down, (up & mid) | (down & t)
    L0, L1 = ((f[1] << np.uint32(1)) | (f[0] >> np.uint32(31))
              for f in (f0, f1))
    R0, R1 = ((f[1] >> np.uint32(1)) | (f[2] << np.uint32(31))
              for f in (f0, f1))
    return dict(L0=L0, L1=L1, R0=R0, R1=R1, up=rows[0][1], mid=rows[1][1],
                down=rows[2][1])


def _port_bit_next(rows, rule):
    """``mpi_tpu_torch.ops.bitlife.bit_next`` on the same words."""
    t = [[interop.grid_from_numpy(w[None], "cpu") for w in row]
         for row in rows]
    sums = [tbit.column_sums(t[0][j], t[1][j], t[2][j]) for j in range(3)]
    f0, f1, c0, c1 = sums[1]
    out = tbit.bit_next(f0, f1, c0, c1, sums[0][0], sums[0][1], sums[2][0],
                        sums[2][1], t[1][1], rule)
    return interop.grid_to_numpy(out)[0]


def _torus_rows(grid):
    """[up/mid/down][previous/own/next word] of every word of a periodic
    grid, flattened."""
    return [[np.roll(np.roll(grid, dr, axis=0), dc, axis=1).ravel()
             for dc in (1, 0, -1)] for dr in (1, 0, -1)]


@pytest.mark.parametrize("name", NAMES)
def test_rule_program_equals_bit_next_and_the_reference(name):
    rule = rule_from_name(name)
    prog = bc.rule_program(rule)
    assert prog.key == gates.rule_key(rule) and prog.inputs == bc.INPUTS
    rows = _words((3, 3, 64), len(name))
    got = gates.evaluate(prog, _operands(rows))
    np.testing.assert_array_equal(got, _port_bit_next(rows, rule))
    grid = _words((6, 3), len(name) + 1)
    want = np.asarray(jbit.bit_step(jnp.asarray(grid),
                                    jax_rule_from_name(name), "periodic"))
    got = gates.evaluate(prog, _operands(_torus_rows(grid)))
    np.testing.assert_array_equal(got.reshape(grid.shape), want)


_HOST = """
#include <cstdint>
#define __device__
#define __forceinline__ inline
// the kernel's lop3<LUT>: bit 4a + 2b + c of LUT is the output for a, b, c
template <int LUT>
uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d = 0;
  for (int i = 0; i < 8; ++i)
    if (LUT >> i & 1)
      d |= ((i & 4) ? a : ~a) & ((i & 2) ? b : ~b) & ((i & 1) ? c : ~c);
  return d;
}
%s
typedef uint32_t (*rule_fn)(uint32_t, uint32_t, uint32_t, uint32_t, uint32_t,
                            uint32_t, uint32_t);
// each rule as explicit LOP3s, then each as gates
static const rule_fn rules[] = {%s};
// rows: [up/mid/down][previous/own/next word][n]
extern "C" void run(int rule, const uint32_t* rows, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    uint32_t f0[3], f1[3];
    for (int j = 0; j < 3; ++j) {
      const uint32_t up = rows[(0 * 3 + j) * n + i];
      const uint32_t mid = rows[(1 * 3 + j) * n + i];
      const uint32_t down = rows[(2 * 3 + j) * n + i];
      const uint32_t t = up ^ mid;
      f0[j] = t ^ down;
      f1[j] = (up & mid) | (down & t);
    }
    const uint32_t up = rows[1 * n + i], down = rows[7 * n + i];
    const uint32_t L0 = (f0[1] << 1) | (f0[0] >> 31);
    const uint32_t L1 = (f1[1] << 1) | (f1[0] >> 31);
    const uint32_t R0 = (f0[1] >> 1) | (f0[2] << 31);
    const uint32_t R1 = (f1[1] >> 1) | (f1[2] << 31);
    out[i] = rules[rule](L0, L1, R0, R1, up, rows[4 * n + i], down);
  }
}
"""


@pytest.fixture(scope="module")
def printed_rules(tmp_path_factory):
    """Every rule's printed header, compiled together with g++ around the
    arithmetic ``csrc/bitlife.cu`` does before it calls ``bit_rule``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to compile the printed rules")
    d = tmp_path_factory.mktemp("bit_rules")
    includes = []
    for i, rule in enumerate(RULES):
        (d / f"rule{i}.cuh").write_text(bc.rule_header(rule))
        includes.append(f'namespace r{i} {{\n#include "rule{i}.cuh"\n}}')
    (d / "host.cpp").write_text(_HOST % (
        "\n".join(includes),
        ", ".join(f"r{i}::{fn}" for fn in ("bit_rule", "bit_rule_gates")
                  for i in range(len(RULES)))))
    lib = d / "rules.so"
    proc = subprocess.run([gxx, "-O1", "-shared", "-fPIC", "-o", str(lib),
                           str(d / "host.cpp")], capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stderr
    run = ctypes.CDLL(str(lib)).run
    run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int]

    def call(index, rows):
        """Both printed forms of rule ``index`` on ``rows``: they must
        agree; returns the LOP3 form's words."""
        rows = np.ascontiguousarray(np.asarray(rows, dtype=np.uint32))
        n = rows.shape[-1]
        out = np.zeros((2, n), dtype=np.uint32)
        for form in (0, 1):
            run(index + form * len(RULES), rows.ctypes.data,
                out[form].ctypes.data, n)
        np.testing.assert_array_equal(out[0], out[1], err_msg=NAMES[index])
        return out[0]

    return call


@pytest.mark.parametrize("index", range(len(NAMES)), ids=NAMES)
def test_printed_rule_compiles_and_agrees(printed_rules, index):
    name, rule = NAMES[index], RULES[index]
    rows = _words((3, 3, 64), index)
    np.testing.assert_array_equal(printed_rules(index, rows),
                                  _port_bit_next(rows, rule), err_msg=name)
    for boundary in ("periodic", "dead"):
        grid = _words((7, 4), 50 + index)
        want = np.asarray(jbit.bit_step(jnp.asarray(grid),
                                        jax_rule_from_name(name), boundary))
        if boundary == "dead":  # a ring of dead words, cut off again
            padded = np.pad(grid, 1)
            got = printed_rules(index, _torus_rows(padded))
            got = got.reshape(padded.shape)[1:-1, 1:-1]
        else:
            got = printed_rules(index, _torus_rows(grid)).reshape(grid.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {boundary}")


@pytest.mark.parametrize("name", NAMED)
def test_emitted_program_costs_the_compiled_forms_instructions(name):
    # the header holds the compiled form, not the run-time masks' 52 LOP3:
    # with the two sums and four shifts before it, its LOP3s are those of
    # word_ops(rule) (sharing equal gates can only save some)
    rule = rule_from_name(name)
    prog = bc.rule_program(rule)
    plan = bc.lop3_plan(prog)
    assert bc.word_cover(rule) <= tbit.word_ops(rule)
    assert bc.rule_header(rule).count("lop3<0x") == len(plan)
    for out, table, operands in plan:
        assert 0 <= table <= 0xFF and 1 <= len(operands) <= 3
    if name == "life":
        assert bc.word_cover(rule) == tbit.word_ops(rule) == 15
        assert len(plan) == 9 and len(prog.ops) == 19
        assert plan[-1][0] == "t8" and plan[0] == ("t0", 0x3C, ["up", "down"])


def test_rule_header_is_one_function_of_the_six_operands():
    text = bc.rule_header(LIFE)
    assert text.startswith("// R1,B3,S2-3: generated by")
    args = ("(uint32_t L0, uint32_t L1, uint32_t R0, uint32_t R1, "
            "uint32_t up, uint32_t mid, uint32_t down)")
    assert text.count("bit_rule" + args) == 1
    assert text.count("bit_rule_gates" + args) == 1
    assert bc.rule_header(rule_from_name("B/S")).count("return 0u;") == 2
    assert bc.rule_header(rule_from_name("B012345678/S012345678")).count(
        "return 0xFFFFFFFFu;") == 2
    assert bc.rule_header(rule_from_name("B/S012345678")).count(
        "return mid;") == 2
    assert bc.rule_program(rule_from_name("B/S")).ops == ()
    with pytest.raises(ValueError, match="radius"):
        bc.rule_program(BOSCO)


def test_k1_library_path_follows_the_rules_sets_not_its_name():
    path = _build.rule_library_path
    assert path("bit", LIFE) == path("bit", rule_from_name("B3/S23")) == \
        path("bit", Rule("other-name", frozenset({3}), frozenset({2, 3})))
    assert path("bit", LIFE).name.startswith("libmpi_tpu_torch_bit_r1_")
    assert path("bit", LIFE).parent == _build.BUILD_DIR
    assert len({path("bit", r) for r in RULES}) == \
        len({gates.rule_key(r) for r in RULES})
    assert path("bit", LIFE, {"K1_WPL": 2}) != path("bit", LIFE)
    assert path("bit", LIFE, {}) == path("bit", LIFE)


@pytest.mark.parametrize("kind,rule", [("bit", LIFE), ("ltl", BOSCO)])
def test_per_rule_build_raises_naming_nvcc_when_absent(monkeypatch, tmp_path,
                                                       kind, rule):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_RULE_LIBS", {})
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.build_rules(kind, [rule])
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.load_rule_library(kind, rule)


_FAKE_NVCC = """#!/bin/sh
out=""; src=""; header=""; defs=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift;;
    -DBIT_RULE_HEADER=*) header="${1#-DBIT_RULE_HEADER=}";;
    -DK1_*) defs="$defs${1#-D}";;
    *.cu) src="$1";;
  esac
  shift
done
echo "ptxas info : Compiling entry function '_ZN12_GLOBAL__N_115bit_step_kernelEPKjPjiiiii' for 'sm_90a'" >&2
echo "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" >&2
echo "ptxas info : Used 40 registers" >&2
echo "$header $(basename $src) $defs" > "$out"
"""


def test_k1_builds_per_rule_and_variants_of_a_rule_together(monkeypatch,
                                                            tmp_path):
    (tmp_path / "bin").mkdir()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    before = _build.builds
    same = rule_from_name("B3/S23")
    libs = _build.build_rules("bit", [LIFE, rule_from_name("seeds"), same],
                              jobs=2)
    assert _build.builds - before == 2 and libs[0] == libs[2]
    header, src, defs = libs[1].read_text().split(" ")
    assert (src, defs.strip()) == ("bitlife.cu", "")
    assert (tmp_path / "build" / header).read_text() == \
        bc.rule_header(rule_from_name("seeds"))
    assert _build.kernel_resources(libs[0]) == [
        {"kernel": "bit_step_kernel", "stack_bytes": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 40}]
    # three variants of one rule, one nvcc process each, the default reused
    variants = [None, {"K1_WPL": 2}, {"K1_RULE_MASKS": 1, "K1_WPL": 1}]
    vlibs = _build.build_rules("bit", [LIFE] * 3, variants)
    assert _build.builds - before == 4 and vlibs[0] == libs[0]
    assert vlibs[2].read_text().split(" ")[2].strip() == \
        "K1_RULE_MASKS=1K1_WPL=1"
    assert vlibs[1] == _build.rule_library_path("bit", same, {"K1_WPL": 2})
    with pytest.raises(ValueError, match="one set of macros per rule"):
        _build.build_rules("bit", [LIFE], variants)


def test_cuda_bit_step_never_reaches_the_plain_version_off_the_cpu(
        monkeypatch):
    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a tensor off the CPU")

    monkeypatch.setattr(cuda_bitlife, "bit_step_plain", no_plain)
    monkeypatch.setattr(cuda_bitlife, "bit_step", no_plain)
    off_cpu = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        cuda_bitlife.cuda_bit_step(off_cpu)
    # a tensor that passes for a CUDA one: the rule's library is loaded, and
    # a failed build is raised, not stepped around
    monkeypatch.setattr(cuda_bitlife, "check_cuda", lambda x, kernel: None)
    asked = []

    def no_build(kind, rule, defines=None):
        asked.append((kind, gates.rule_key(rule)))
        raise _build.BuildError("nvcc not found")

    monkeypatch.setattr(_build, "load_rule_library", no_build)
    before = cuda_bitlife.cuda_bit_step.launches
    with pytest.raises(_build.BuildError, match="nvcc"):
        cuda_bitlife.cuda_bit_step(off_cpu, rule_from_name("highlife"),
                                   "dead", gens=3)
    assert asked == [("bit", "R1,B3+6,S2-3")]
    assert cuda_bitlife.cuda_bit_step.launches == before
