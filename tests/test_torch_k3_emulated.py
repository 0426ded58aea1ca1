"""Kernel K3's CUDA source (``mpi_tpu_torch/csrc/bitltl.cu``) on the CPU:
built by the host C++ compiler against a warp emulation
(``tests/cuda_warp_emulation.h``: a thread a lane, a shuffle through a
barrier of the warp's 32 threads) and held to the kernel's plain version,
bit for bit.  The card runs the same source (``chip_smoke.py`` phase 2);
this catches a fault of its row loop, its wavefront of generations or its
host launch without one.  Two spots of the source are rewritten for the
host compiler: the ``<<<...>>>`` launch becomes a call of the emulation's
launcher, and the dynamic shared memory its buffer."""

import ctypes
import itertools
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi_tpu_torch.models.rules import Rule, rule_from_name
from mpi_tpu_torch.ops import _build, ltl_codegen
from mpi_tpu_torch.ops.bitlife import mask_pad
from mpi_tpu_torch.ops.cuda_bitltl import ltl_step_plain, max_gens

NAMED = {2: "R2,B10-13,S8-12", 3: "R3,B20-25,S18-30", 4: "R4,B30-40,S25-50",
         5: "bosco", 6: "R6,B50-70,S40-90", 7: "R7,B80-100,S75-119"}
EMULATION = Path(__file__).with_name("cuda_warp_emulation.h")
# (rows, words): one word, a ragged tile, two tiles side by side (a CTA's
# warps across the rows), a grid shorter than a run
SHAPES = [(1, 1), (37, 2), (100, 3), (70, 31), (45, 250)]
_libs: dict = {}


def _library(tmp: Path, rule: Rule, defines: dict):
    key = (ltl_codegen.rule_key(rule), tuple(sorted(defines.items())))
    if key not in _libs:
        gxx = shutil.which("g++")
        if gxx is None:
            pytest.skip("no g++ on this machine to build K3's source")
        d = tmp / f"k3_{len(_libs)}"
        d.mkdir()
        (d / "cuda_runtime.h").write_text(f'#include "{EMULATION}"\n')
        (d / "rule.cuh").write_text(ltl_codegen.rule_header(rule))
        src = (_build.CSRC_DIR / "bitltl.cu").read_text()
        src = re.sub(r"(\w+(?:<\w+>)?)<<<([^>]*)>>>\(",
                     r"emulated_launch(\1, \2, ", src)
        src = src.replace("extern __shared__ uint32_t smem[];",
                          "uint32_t* smem = emulated_shared_memory;")
        (d / "bitltl.cpp").write_text(src)
        cmd = [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
               f"-I{d}", f"-DLTL_RADIUS={rule.radius}",
               "-DLTL_RULE_HEADER=rule.cuh",
               *(f"-D{k}={v}" for k, v in defines.items()),
               "-o", str(d / "k3.so"), str(d / "bitltl.cpp")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-3000:]
        lib = ctypes.CDLL(str(d / "k3.so"))
        lib.gol_ltl_step.restype = ctypes.c_int
        lib.gol_ltl_step.argtypes = ([ctypes.c_void_p] * 2
                                     + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        _libs[key] = lib
    return _libs[key]


def _step(lib, x, rule, boundary, gens, col_limit):
    out = torch.full_like(x, 0x5A5A5A5A)  # every word the kernel must write
    B, H, NW = (1, *x.shape) if x.dim() == 2 else x.shape
    err = lib.gol_ltl_step(x.data_ptr(), out.data_ptr(), B, H, NW,
                           rule.radius, gens, int(boundary == "periodic"),
                           col_limit or 0, None)
    assert err == 0
    return out


def _check(lib, rule, shapes, seed, boards=1):
    rng = np.random.default_rng(seed)
    for (H, NW), boundary, gens in itertools.product(
            shapes, ("periodic", "dead"), range(1, max_gens(rule.radius) + 1)):
        if gens > 1 and 0 in rule.birth:
            continue
        for col_limit in {None, 32 * NW - 5 if NW > 1 else None}:
            shape = (boards, H, NW) if boards > 1 else (H, NW)
            x = mask_pad(torch.from_numpy(rng.integers(
                -2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)),
                col_limit)
            want = ltl_step_plain(x, rule, boundary, gens, col_limit)
            got = _step(lib, x, rule, boundary, gens, col_limit)
            assert torch.equal(got, want), (rule, shape, boundary, gens,
                                            col_limit)


@pytest.mark.parametrize("radius", range(2, 8))
def test_k3_source_equals_the_plain_version(radius, tmp_path_factory):
    # the named rule of each radius at every depth, periodic and dead, with
    # and without a pad; a seeded random rule beside it
    tmp = tmp_path_factory.getbasetemp()
    rule = rule_from_name(NAMED[radius])
    _check(_library(tmp, rule, {}), rule, SHAPES, radius)
    rng = np.random.default_rng(radius)
    n = (2 * radius + 1) ** 2
    fuzz = Rule("fuzz", np.flatnonzero(rng.random(n) < 0.3),
                np.flatnonzero(rng.random(n) < 0.4), radius)
    _check(_library(tmp, fuzz, {}), fuzz, SHAPES[1:3], 100 + radius)


@pytest.mark.parametrize("radius", [2, 5])
def test_k3_source_on_boards_and_a_short_run(radius, tmp_path_factory):
    # B boards in one launch; the tuner's shortest run (K3_ROWS 32), so
    # that a grid holds many runs and each run's halo is most of it
    tmp = tmp_path_factory.getbasetemp()
    rule = rule_from_name(NAMED[radius])
    _check(_library(tmp, rule, {}), rule, [(37, 2), (5, 1)], 7, boards=3)
    _check(_library(tmp, rule, {"K3_ROWS": 32}), rule, [(100, 3), (70, 31)],
           8)
