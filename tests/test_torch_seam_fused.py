"""The seam band in one launch, on the CPU.

``seam_band_kernel``'s CUDA source (``mpi_tpu_torch/csrc/stencil.cu``) is
built by the host C++ compiler against the warp emulation
(``tests/cuda_warp_emulation.h``: a thread a lane, ``__syncwarp`` through a
barrier of the warp's 32 threads) and held bit for bit to the three-piece
pass, ``stitch_band(out, evolve_band(extract_band(src, C, d), rule, k), C,
d)``, at every radius, at widths on both sides of a word and where both
ends of the seam share word 0, on grids shorter than the band's halo and
on a batch of boards.  The card runs the same source (``chip_smoke.py``
phase 2).  Two spots of the source are rewritten for the host compiler,
as for K3 (``tests/test_torch_k3_emulated.py``): the ``<<<...>>>`` launch
and the dynamic shared memory.

Then the seam stepper: every pass calls ``fused_band`` once, after its
kernel, and equals the three pieces composed by hand."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi_tpu_torch.backends import cuda as backend
from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.config import GolConfig
from mpi_tpu_torch.models.rules import LIFE, Rule, rule_from_name
from mpi_tpu_torch.ops import _build
from mpi_tpu_torch.ops.bitlife import init_packed, mask_pad, unpack
from mpi_tpu_torch.ops.cuda_bitlife import cuda_bit_step
from mpi_tpu_torch.ops.cuda_stencil import rule_table
from mpi_tpu_torch.parallel import seam
from mpi_tpu_torch.utils.hashinit import init_tile_np

EMULATION = Path(__file__).with_name("cuda_warp_emulation.h")
NAMED = {1: LIFE, 2: rule_from_name("R2,B10-13,S8-12"),
         3: rule_from_name("R3,B20-25,S18-30"),
         4: rule_from_name("R4,B30-40,S25-50"), 5: rule_from_name("bosco"),
         6: rule_from_name("R6,B50-70,S40-90"),
         7: rule_from_name("R7,B80-100,S75-119")}
# births and survivals at the counts' ends, 0 and 8
EDGES = Rule("edges", frozenset({0, 1, 2, 8}), frozenset({0, 8}), 1)
_lib: dict = {}


def _library(tmp: Path):
    if "lib" not in _lib:
        gxx = shutil.which("g++")
        if gxx is None:
            pytest.skip("no g++ on this machine to build the seam kernel")
        d = tmp / "seam_band"
        d.mkdir(exist_ok=True)
        (d / "cuda_runtime.h").write_text(f'#include "{EMULATION}"\n')
        src = (_build.CSRC_DIR / "stencil.cu").read_text()
        src = re.sub(r"(\w+(?:<\w+>)?)<<<([^>]*)>>>\(",
                     r"emulated_launch(\1, \2, ", src)
        old = "extern __shared__ uint4 smem4[];"
        assert old in src
        src = src.replace(old, "uint4* smem4 = reinterpret_cast<uint4*>("
                               "emulated_shared_memory);")
        (d / "stencil.cpp").write_text(src)
        cmd = [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
               "-Wno-unknown-pragmas", f"-I{d}", "-o", str(d / "seam.so"),
               str(d / "stencil.cpp")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-3000:]
        lib = ctypes.CDLL(str(d / "seam.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gol_seam_band.argtypes = [ptr, ptr] + [i32] * 6 + [
            ctypes.POINTER(ctypes.c_uint), ptr]
        lib.gol_seam_band.restype = i32
        _lib["lib"] = lib
    return _lib["lib"]


def _fuzz(radius: int, seed: int) -> Rule:
    rng = np.random.default_rng(seed)
    n = (2 * radius + 1) ** 2
    return Rule("fuzz", np.flatnonzero(rng.random(n) < 0.3),
                np.flatnonzero(rng.random(n) < 0.4), radius)


def _words(rng, shape, C):
    x = torch.from_numpy(rng.integers(-2**31, 2**31, size=shape,
                                      dtype=np.int64).astype(np.int32))
    return mask_pad(x, C)


# (rule, k, C, H, B): d = k r <= 31 at every radius
CASES = [
    (1, 1, 4, 40, 1),         # C = 4d, a one-word grid
    (1, 8, 32, 70, 1),        # C < 64: both ends in word 0; a ragged run
    (1, 8, 65000, 5, 1),      # the padded Life width; H < 2d
    (1, 8, 65000, 40, 3),     # ... three boards
    (1, 31, 124, 37, 1),      # the deepest band, C = 4d
    (1, 31, 200, 33, 1),      # a strip of five words
    (1, 3, 63, 64, 3),        # one below a multiple of 32, both ends word 0
    (2, 4, 95, 64, 1),        # one below
    (2, 4, 97, 64, 3),        # one above
    (2, 15, 127, 20, 1),      # d = 30
    (3, 3, 129, 50, 1),
    (3, 10, 1000, 66, 1),
    (4, 2, 33, 45, 1),        # C < 64 with word 1 holding the pad
    (4, 7, 112, 70, 1),
    (5, 1, 20, 12, 1),        # Bosco's pass, C = 4d
    (5, 6, 121, 70, 3),
    (6, 1, 65, 8, 1),         # H < 2d
    (6, 5, 1000, 33, 1),
    (7, 4, 112, 65, 1),       # C = 4d, d = 28
    (7, 1, 33, 7, 3),         # H = r < 2d, three boards
    (5, 2, 40, 3, 1),         # H < r: the rows wrap more than once
    # random rules (birth on 0 allowed) on each of the rule's forms: one
    # mask at r 1 and 2, two at r 3, the table beyond
    ("f1", 8, 40, 40, 1),
    ("b0", 5, 70, 33, 1),     # radius 1, births at counts 0 and 8
    ("f2", 3, 90, 40, 1),
    ("f3", 2, 161, 40, 1),
    ("f6", 2, 50, 30, 3),
]


@pytest.mark.parametrize("radius,k,C,H,B", CASES,
                         ids=[f"r{r}-k{k}-C{C}-H{H}-B{B}"
                              for r, k, C, H, B in CASES])
def test_fused_band_source_equals_the_three_pieces(radius, k, C, H, B,
                                                   tmp_path_factory):
    lib = _library(tmp_path_factory.getbasetemp())
    rule = (EDGES if radius == "b0" else _fuzz(int(radius[1:]), 11)
            if isinstance(radius, str) else NAMED[radius])
    d = k * rule.radius
    NW = -(-C // 32)
    shape = (B, H, NW) if B > 1 else (H, NW)
    rng = np.random.default_rng(C * 31 + H)
    src = _words(rng, shape, C)
    out = _words(rng, shape, C)      # the pass's output, as K1 leaves it
    band = seam.evolve_band(seam.extract_band(src, C, d), rule, k)
    want = seam.stitch_band(out.clone(), band, C, d)
    got = out.clone()
    err = lib.gol_seam_band(src.data_ptr(), got.data_ptr(), B, H, NW, C,
                            rule.radius, k, rule_table(rule), None)
    assert err == 0
    assert torch.equal(got, want)
    # no bit outside the 2d seam columns changed
    ones = torch.ones(band.shape, dtype=torch.uint8)
    cols = seam.stitch_band(torch.zeros_like(out), ones, C, d)
    assert not ((got ^ out) & ~cols).any()
    assert int(unpack(cols.reshape(-1, NW)).sum()) == 2 * d * B * H


@pytest.mark.parametrize("k,C,NW,radius", [
    (32, 200, 7, 1),      # d = 32 > 31
    (8, 31, 1, 1),        # C < 4d
    (2, 65, 2, 1),        # C > 32 NW
    (1, 40, 2, 8),        # radius 8
])
def test_fused_band_source_refuses_what_it_cannot_serve(k, C, NW, radius,
                                                        tmp_path_factory):
    lib = _library(tmp_path_factory.getbasetemp())
    x = torch.zeros((4, NW), dtype=torch.int32)
    assert lib.gol_seam_band(x.data_ptr(), x.clone().data_ptr(), 1, 4, NW,
                             C, radius, k, rule_table(LIFE), None) == 1


def _stepper(C, K):
    def inner(src, k, dst):
        return cuda_bit_step(src, LIFE, "periodic", k, out=dst, col_limit=C)

    return seam.make_seam_stepper(inner, LIFE, C, K)


@pytest.mark.parametrize("H,C,K,steps,passes", [
    (48, 60, 4, 10, 3),       # passes of 4, 4 and 2
    (40, 50, 2, 6, 3),        # the band 4 d = 8 columns wide
])
def test_default_stepper_fuses_the_band_and_counts_each_pass(
        monkeypatch, H, C, K, steps, passes):
    """Each pass launches the kernel and then ``fused_band`` once, on the
    pass's input and output, and the grid equals the three plain pieces
    composed here around the same kernel and the oracle.  The launcher is
    stubbed by a recorder around the plain version."""
    calls = []
    real = seam.fused_band

    def launcher(src, out, rule, width, k, handle=None):
        calls.append((tuple(src.shape), width, k))
        return real(src, out, rule, width, k, handle)

    monkeypatch.setattr(seam, "fused_band", launcher)
    grid = init_packed(H, -(-C // 32) * 32, 9, col_limit=C, device="cpu")
    fused, _ = _stepper(C, K)(grid.clone(), steps, None)
    depths = [K] * (steps // K) + ([steps % K] if steps % K else [])
    assert len(depths) == passes
    assert calls == [(tuple(grid.shape), C, k) for k in depths]
    pieces = grid.clone()
    for k in depths:
        out = cuda_bit_step(pieces, LIFE, "periodic", k, col_limit=C)
        band = seam.evolve_band(seam.extract_band(pieces, C, k), LIFE, k)
        pieces = seam.stitch_band(out, band, C, k)
    assert fused.equal(pieces)
    want = evolve_np(unpack(grid)[:, :C].numpy(), steps, LIFE, "periodic")
    np.testing.assert_array_equal(unpack(fused)[:, :C].numpy(), want)


def test_padded_engine_steps_by_the_fused_band(monkeypatch):
    """A periodic padded engine (K1, 1.5 words a row) and its batch: one
    ``fused_band`` call a pass, the boards equal to the oracle's."""
    calls = []
    real = seam.fused_band

    def launcher(src, out, rule, width, k, handle=None):
        calls.append((src.dim(), width, k))
        return real(src, out, rule, width, k, handle)

    cfg = GolConfig(rows=40, cols=48, steps=0, comm_every=3, seed=4)
    eng = backend.build_engine(cfg, device="cpu")
    assert eng.seam
    eng.warm_up(boards=2)
    monkeypatch.setattr(seam, "fused_band", launcher)
    got = eng.fetch(eng.step(eng.init_grid(), 7))
    batch = eng.step_batched(eng.stack_grids(
        [eng.init_grid(seed=s) for s in (5, 6)]), 7)
    assert calls == [(d, 48, k) for d in (2, 3) for k in (3, 3, 1)]
    np.testing.assert_array_equal(
        got, evolve_np(init_tile_np(40, 48, 4), 7, LIFE, "periodic"))
    for b, s in zip(eng.fetch_batched(batch), (5, 6)):
        np.testing.assert_array_equal(
            b, evolve_np(init_tile_np(40, 48, s), 7, LIFE, "periodic"))
