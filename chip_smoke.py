#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mpi_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases; any failure exits non-zero before the result line:

0. the card: name and power limit from ``nvidia-smi``; no CUDA, no run;
1. build kernel K2 (``mpi_tpu_torch/csrc/stencil.cu``) with nvcc into the
   common library, and K1 and K3 once per rule, in parallel nvcc processes
   (K1 for every rule of phase 2, K3 one library for each radius 2..7);
   report each kernel's registers and spills (ptxas; none may spill), K1's
   tile and the CTAs that share an SM at each depth, and count the
   instructions of K1's, K2's and K3's row loops in the built SASS
   (``cuobjdump``), per word-generation (K1, K3) and per cell-generation
   (K2); then time the common build and one per-rule build of each kernel
   alone, twice each;
2. each kernel against its plain PyTorch version, exact (``torch.equal``):
   K1 over gens x boundaries x rules x ragged shapes and random rules,
   every depth 1..16, shapes around its tile's edges (1, 2, 29-33, 61-65
   and 119-129 words a row; 1-3 and 127-130 rows), grids that cross the
   torus seam in both axes, dead grids larger than two tiles each way
   (edge and interior CTAs, aligned and unaligned rows), and at 65536² at
   the main path's depths; K2 over radii 1, 2, 3, 5, 7 x
   depths with gens x r <= 16 x boundaries x ragged widths (grids below the
   neighbourhood too, a birth-on-0 rule, random rules), and at 16384²
   (Bosco, gens 1 and 3); K3 over radii 2..7 x gens 1..⌊8/r⌋ x boundaries
   x ragged shapes (one word per row, small H, random rules), and at 65536²
   (Bosco gens 1, R2 gens 4), its distinct rules built first, together.
   The modes this slice added: K1 and K3 with ``col_limit`` (pads of 1, 24
   and 31 bits at 1, 2, 31 or 127-130 words a row, a ghost word over the
   pad, every depth, both boundaries, and 65000² at the padded paths'
   depths), K1-K3 on a board axis (1, 2, 7 and 32 boards, ragged rows and
   words, rows that do and do not move in 16-byte pieces, padded boards;
   each batch one launch), and K2 stepping the seam band, whose middle
   columns must equal ``evolve_band``'s; and K1, K3 and K2 at a dead
   boundary and gens 1 on the stripes of sparse stepping (the tiles of a
   rung side by side with their halos: the plans of the sparse paths and
   CLI cases below, and narrow ones);
3. the main paths, each kernel's launch counter reset just before and
   required above 0 just after, each whole final grid equal to the plain
   version's from the same init: ``run_cuda`` at 65536² for Life (comm_every
   8, K1), for Bosco (comm_every 1, K3) and for R2,B10-13,S8-12 (comm_every
   4, K3), at 16384² for Bosco (comm_every 3, K2), at 65000² (a width of
   2031.25 words) for Life (periodic, comm_every 8: K1 with ``col_limit``
   and the seam band) and Bosco (dead, comm_every 1: K3 with
   ``col_limit``), and ``step_batched`` on 32 boards of 4096² (Life,
   comm_every 8, one K1 launch a pass, then depth-1 ``step_batched_units``),
   each ~250-280 ms of stepping, so that a stray delay of 2 ms on the
   machine stays under 1% of the window; 16384² Bosco at comm_every 4 (20
   cells of halo: K2 in passes of 3), whose final grid must equal the
   comm_every-3 path's; and the sparse Life engine (``sparse_tile`` 128)
   at 65536² on the reference's quiescent board with 64 gliders, 2001
   generations, held against the dense K1 engine and the plain version,
   and on the reference's 35% soup, 200 generations, held against the
   dense K1 engine.  Then the CLI at 512² (Life at comm_every 4 and
   Bosco, both boundaries; Bosco at comm_every 4 on K2; Life with
   ``--sparse 32``), at 500x500 (Life at comm_every 3 and Bosco at 1 on
   the padded K1 and K3, with the seam band when periodic; Bosco at 2 on
   K2) and at 480x500 (Bosco with ``--sparse 20`` on K2), whose ``.gol``
   files must equal the serial oracle's byte for byte;
4. times (CUDA events after warm-up) of each kernel at its main paths'
   depths, with cell-updates/s, the plain version's time, the card's bound,
   and a library call where one exists (for K2, ``conv2d`` of the padded
   grid in float16: the counts only); K1's kept design against its
   variants (the rule from run-time masks, which the kernel evaluated
   before the rule was compiled in; words per lane; ghost words; rows per
   CTA; the tile load; the kernel without the padded-grid code) at gens 8,
   4, 2 and 1, in turns, each variant's output equal to the kept one's;
   K3's two horizontal sums (carry-save adders, doubling) at every radius,
   in turns; the padded paths' passes (K1 or K3 with ``col_limit``, the
   whole seam pass with the band on K2 and on ``evolve_band``, the band
   alone, and the same grids forced onto K2), in turns; and a pass over a
   batch in one launch against its boards in one launch each (K1, K3,
   K2), in turns, in ms per board-generation; the sparse engine against
   the dense K1 engine at comm_every 1 and 8 on the sparse paths' boards,
   in turns, in ms a generation, and K1's stripe step against its bound;
5. a ``torch.profiler`` trace of each main path's steady stepping: kernel
   time by name, launches equal to the trace's kernels of the path's
   kernel (the sparse path's follow its phases), the other kernels' time
   (the seam band; the sparse path's gathers, compares and write-backs),
   the device's idle share of the wall time, and no kernel build inside
   it;
6. the serve layer (``mpi_tpu_torch/serve``) on the card: a
   ``SessionManager`` creates 32 sessions of 4096² Life (comm_every 8; one
   cache miss, 31 hits that warm nothing), and 32 threads step them 8
   generations a request, coalesced into one K1 launch a round, whose
   boards must equal ``step_batched``'s on the same seeds and the plain
   version's; 8 sessions of 4096² Bosco on K3 (comm_every 1) and 8 on K2
   (comm_every 3) step through tickets of mixed depths, equal to the plain
   versions, with a state dir (checkpoint_every 64) from which a second
   manager restores every session bit for bit after the first is shut
   down, both stepping on equal; at 256², a transient injected fault
   retries, an injected delay past the deadline is a ``DeadlineError``
   with the session intact, and a tripped breaker degrades the session to
   the oracle with equal boards, while a real failure of the card's engine
   answers ``EngineUnavailableError`` with the session left on the card;
   8 threads step 8 sessions on one 4096² Life engine solo (no batcher),
   each board equal to the plain version's.  Outside those faults, no batched
   fallback, engine failure or degraded session, and no kernel build
   while serving.  A ``torch.profiler`` window of serving gives the
   device's idle share and the K1 time, which the layer's own step time
   (``batched_step_s``, and each session's ``steady_s`` when every round
   coalesced) must reach: the wait for the device truly waits.  The
   per-layer numbers: board-generations/s of serving against
   ``step_batched`` alone on the same boards, requests/s and the host's
   CPU ms a request;
7. observability on the card and the native backends on its host: 32
   sessions of 4096² Life (K1) and one each of 4096² Bosco on K3 and on K2
   (comm_every 3) on two managers, one without obs and one with a full
   ``Obs`` (telemetry unstarted, flight recorder, anomaly detector,
   device-memory sampler), served the same requests in turns (off, on,
   on, off: requests/s of each), their boards equal bit for bit; every
   engine's cost cards (one per warmed depth and batch, ``source``
   ``kernel_count``, K1's, K3's and K2's equal to their kernels' counts
   times the work) and the card's int32 roof from its properties, printed
   with its name and power limit; ``run_profile`` over about a second of
   the Life traffic, started half a second after the capture's first
   kernel, writes a Chrome trace whose K1 records equal the K1 launches
   counted in it (the trace rule of phases 5 and 6, one retake);
   ``read_device_memory`` reports memory in use; a ``cpp-par`` session
   equals a ``cuda`` session of its spec; and the CLI at 2048² with
   ``--backend cpp`` and ``--backend cpp-par --workers 8`` writes the
   board ``--backend cuda`` writes, read back with ``golio``, with the
   same master header but for ``cpp-par``'s tile count.

It prints JSON lines, the ``{"kernels": [...]}`` line second to last, and
as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import filecmp
import json
import os
import re
import subprocess
import sys
import shutil
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpi_tpu_torch import golio  # noqa: E402
from mpi_tpu_torch.backends import cuda as backend  # noqa: E402
from mpi_tpu_torch.backends.cpp import plan_tiles  # noqa: E402
from mpi_tpu_torch.backends.serial_np import evolve_np  # noqa: E402
from mpi_tpu_torch.cli import main as cli_main  # noqa: E402
from mpi_tpu_torch.config import WORD, GolConfig  # noqa: E402
from mpi_tpu_torch.interop import grid_from_numpy  # noqa: E402
from mpi_tpu_torch.models.rules import (  # noqa: E402
    BOSCO, DAY_AND_NIGHT, HIGHLIFE, LIFE, SEEDS, Rule, rule_from_name,
)
from mpi_tpu_torch.obs import Obs  # noqa: E402
from mpi_tpu_torch.obs.cost import (  # noqa: E402
    device_roof_ops_per_s, roof_ops_per_s,
)
from mpi_tpu_torch.obs.devmem import read_device_memory  # noqa: E402
from mpi_tpu_torch.obs.profile import capturing, run_profile  # noqa: E402
from mpi_tpu_torch.ops import _build, activity  # noqa: E402
from mpi_tpu_torch.ops.bitlife import (  # noqa: E402
    bit_step, init_packed, pack, population, word_ops,
)
from mpi_tpu_torch.ops.bitltl import (  # noqa: E402
    ltl_step, ltl_word_ops, ltl_word_ops_lower,
)
from mpi_tpu_torch.ops.cuda_bitlife import (  # noqa: E402
    bit_step_plain, cuda_bit_step,
)
from mpi_tpu_torch.ops.cuda_bitlife import launch as bit_launch  # noqa: E402
from mpi_tpu_torch.ops.cuda_bitltl import (  # noqa: E402
    cuda_ltl_step, ltl_step_plain, max_gens,
)
from mpi_tpu_torch.ops.cuda_bitltl import launch as ltl_launch  # noqa: E402
from mpi_tpu_torch.ops.ltl_codegen import (  # noqa: E402
    lop3_count, rule_key, rule_program,
)
from mpi_tpu_torch.ops.cuda_stencil import (  # noqa: E402
    cuda_dense_step, dense_step_plain,
)
from mpi_tpu_torch.ops.stencil import (  # noqa: E402
    counts_from_padded, dense_cell_ops, pad_grid,
)
from mpi_tpu_torch.parallel import seam  # noqa: E402
from mpi_tpu_torch.serve import (  # noqa: E402
    DeadlineError, EngineCache, EngineUnavailableError, SessionManager,
)
from mpi_tpu_torch.utils.hashinit import init_dense, init_tile_np  # noqa: E402
from mpi_tpu_torch.utils.segmenting import segmented_evolve  # noqa: E402
from mpi_tpu_torch.utils.timing import PhaseTimer  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of
# HBM, and 67 TFLOP/s float32 outside the tensor cores, which is 132 SMs x
# 128 lanes x 2 (an FMA) x 1.98 GHz.  A Hopper SM has 64 int32 lanes, so
# the int32 rate is a quarter of that figure, in instructions per second.
# K1's and K3's work is counted in those instructions (LOP3 and SHF):
# ``word_ops`` exactly for K1's compiled form; ``ltl_word_ops_lower`` and
# ``ltl_word_ops`` from below and above for K3's function, the bound
# taking the lower count.  K2's least work: sliding window sums need about 6 per
# cell-generation whatever r is (a three-input add to slide each of the
# vertical and horizontal windows, the centre, the rule's test, the
# result), and every sum fits a byte (<= 225), so four cells share one
# 32-bit instruction.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
K2_CELL_OPS = 6 / 4

SEED = 1
FLAGSHIP = 65536         # K1 and K3 main paths: 512 MiB packed
PADDED = 65000           # the padded paths: 2032 words a row, 24 bits pad
PADDED_WORDS = -(-PADDED // 32)
MAIN_GENS = 8            # K1's main path: comm_every 8
MAIN_STEPS = 1500        # 187 passes of 8 and a remainder pass of 4
MAIN_DEPTHS = (1, MAIN_STEPS % MAIN_GENS, MAIN_GENS)  # warm-up, remainder, K
R2 = rule_from_name("R2,B10-13,S8-12")
# (label, rule, comm_every, steps) of K3's main paths at 65536²
LTL_PATHS = (("bosco", BOSCO, 1, 200), ("r2", R2, 4, 450))
DENSE = 16384            # K2's main path: 256 MiB of cells
DENSE_PATH = ("bosco", BOSCO, 3, 1201)
# (label, kernel, engine, rule, comm_every, steps, boundary) at PADDED²:
# K1 with the seam band, K3 padded on a dead grid
PADDED_PATHS = (("padded_life", "K1", "bit", LIFE, 8, 1500, "periodic"),
                ("padded_bosco", "K3", "ltl", BOSCO, 1, 200, "dead"))
# (rows, steps) of a strip of the padded Life path at its full width, held
# against the plain dense step on the real width (no seam code): 12 passes
# of 8 and one of 4, as the path's last
SEAM_STRIP = (1024, 100)
# (label, boards, size, rule, comm_every, steps, depth-1 units after):
# 2 MiB a board, 64 MiB a batch buffer, above the H100's 50 MB of L2
BATCH_PATH = ("batched_life", 32, 4096, LIFE, 8, 6000, 100)

# the sparse Life path at FLAGSHIP² on SPARSE_T² tiles (512 x 512): the
# reference's quiescent board (bench.py:2018-2034: one blinker in each of
# 1% of the tiles, packed into a square block) plus SPARSE_GLIDERS gliders,
# some of which cross the periodic seam; an odd number of generations (one
# that settles the all-ones start, then the rest in one dispatch), so that a
# stepper that did nothing fails against the period-2 blinkers
SPARSE_T = 128
SPARSE_ACTIVE = 0.01
SPARSE_GLIDERS = 64
SPARSE_STEPS = 2001
# the reference's soup (bench.py:2040): 35% live, every tile busy
SOUP = (0.35, 200)
SPARSE_TIMED = 400     # generations a timed dispatch (50 gathers of 8)
# 16384² Bosco at comm_every 4: 20 cells of halo, K2 in passes of 3, whose
# final grid must equal DENSE_PATH's (comm_every 3)
DEEP_PATH = ("deep_bosco", BOSCO, 4, 1201)
GLIDER = ((0, 1, 0), (0, 0, 1), (1, 1, 1))  # moves down and right

# each kernel's wrapper, whose ``launches`` the main paths read
KERNELS = {kid: wrapper for kid, wrapper, _ in backend.KERNELS.values()}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase0_card() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    return card


def _spills(resources) -> list:
    return [r for r in resources if r.get("spill_stores") or
            r.get("spill_loads")]


def phase1_build() -> None:
    t0 = time.perf_counter()
    lib = _build.load_library()
    seconds = time.perf_counter() - t0
    resources = _build.kernel_resources(_build.library_path())
    k1_rules = list({rule_key(c[1]): c[1] for c in _k1_cases()}.values())
    t0 = time.perf_counter()
    k1_libs = _build.build_rules("bit", k1_rules)
    k1_seconds = time.perf_counter() - t0
    k1_resources = {rule_key(r): _build.kernel_resources(p)
                    for r, p in zip(k1_rules, k1_libs)}
    t0 = time.perf_counter()
    ltl_libs = _build.build_rules("ltl", list(LTL_RULES.values()))
    ltl_seconds = time.perf_counter() - t0
    ltl_resources = {r: _build.kernel_resources(p)
                     for r, p in zip(LTL_RULES, ltl_libs)}
    k1 = _build.load_rule_library("bit", LIFE)
    words_per_lane, owned_words = ctypes.c_int(), ctypes.c_int()
    rows = {g: k1.gol_bit_tile(g, ctypes.byref(words_per_lane),
                               ctypes.byref(owned_words))
            for g in (1, 4, 8, 16)}
    words_per_lane, owned_words = words_per_lane.value, owned_words.value
    registers = sorted({v[0].get("registers") for v in k1_resources.values()
                        if v})
    emit({"phase": "build", "kernels": ["K1", "K2", "K3"],
          "sources": [p.name for p in _build.sources()], "seconds": seconds,
          "library": os.path.relpath(lib._name, ROOT),
          "ptxas": resources,
          "k1_rules": len(k1_rules),
          "k1_parallel_build_seconds": k1_seconds,
          "k1_tile": {"words_per_lane": words_per_lane,
                      "owned_words": owned_words, "rows_by_gens": rows},
          "k1_ctas_per_sm": {g: k1.gol_bit_ctas_per_sm(g)
                             for g in (1, 4, 8, 16)},
          "k1_registers": registers,
          "k1_ptxas_life": k1_resources[rule_key(LIFE)],
          "k3_rules": {r: rule_key(rule) for r, rule in LTL_RULES.items()},
          "k3_parallel_build_seconds": ltl_seconds,
          "k3_hsum": _build.LTL_HSUM,
          "k3_ptxas": ltl_resources})
    # K2 at r 1..7 in the common library (for full grids and for grids
    # narrower than a tile), one kernel in each library of K1 (one per rule)
    # and of K3 (r 2..7)
    per_rule = list(k1_resources.values()) + list(ltl_resources.values())
    if len(resources) != 14 or any(len(v) != 1 for v in per_rule):
        fail(f"expected 14 kernels in the common library and one in each "
             f"per-rule library, got {resources}, {k1_resources} and "
             f"{ltl_resources}")
    spilled = _spills(resources + sum(per_rule, []))
    if spilled:
        fail(f"kernels spill: {spilled}")
    _sass_loops(lib._name, k1._name, words_per_lane,
                str(ltl_libs[list(LTL_RULES).index(5)]))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        emit({"phase": "build_seconds", **_build_seconds(Path(d))})


def _build_seconds(d: Path) -> dict:
    """Seconds to build, into fresh directories under ``d``, twice each:
    the common library, one K1 library (Life) alone, and one K3 library
    (Bosco) alone."""
    out = {"common": [], "k1_one_rule": [], "k3_one_rule": []}
    home = _build.BUILD_DIR
    try:
        for rep in range(2):
            t0 = time.perf_counter()
            _build.build(d / f"common{rep}.so")
            out["common"].append(time.perf_counter() - t0)
            for key, kind, rule in (("k1_one_rule", "bit", LIFE),
                                    ("k3_one_rule", "ltl", BOSCO)):
                _build.BUILD_DIR = d / f"{kind}{rep}"
                t0 = time.perf_counter()
                _build.build_rules(kind, [rule])
                out[key].append(time.perf_counter() - t0)
    finally:
        _build.BUILD_DIR = home
    return out


def _sass_functions(library: str) -> dict:
    """Each kernel's SASS in the built library, by its short name (e.g.
    ``ltl_step_kernel<5>``): a list of (address, opcode, backward-branch
    target or None)."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    dump = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, timeout=300)
    if dump.returncode != 0:
        fail(f"cuobjdump failed: {dump.stderr.strip()}")
    out = {}
    for f in dump.stdout.split("Function : ")[1:]:
        k = re.search(r"\d([a-z_]+_kernel)(?:ILi(\d+)E)?", f.splitlines()[0])
        if not k:
            continue
        code = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]*)([^;]*);", f):
            addr, op = int(m[1], 16), m[2]
            t = re.search(r"0x([0-9a-f]+)\s*$", m[3]) if op == "BRA" else None
            code.append((addr, op, int(t[1], 16)
                         if t and int(t[1], 16) < addr else None))
        out[k[1] + (f"<{k[2]}>" if k[2] else "")] = code
    return out


def _inner_loops(code) -> list:
    """The bodies of the innermost loops (a backward branch with no other
    inside it), as lists of opcodes."""
    loops = []
    for end, _, start in code:
        if start is None:
            continue
        body = [(a, op, b) for a, op, b in code if start <= a <= end]
        if all(b is None for a, _, b in body if a != end):
            loops.append([op.split(".")[0] for _, op, _ in body])
    return loops


def _row_loop(code, mark: str, marker: str) -> dict:
    """The innermost loop of ``code`` with the most ``mark`` opcodes, which
    in K2 (PRMT) and K3 (SHFL) is the row loop, with the rows it steps per
    iteration: the count of its ``marker`` opcode, which each row issues
    once."""
    body = max(_inner_loops(code), key=lambda b: b.count(mark), default=[])
    rows = body.count(marker)
    if not body.count(mark) or not rows:
        fail(f"no row loop with {mark} and {marker} found in the SASS; "
             f"innermost loops: {[Counter(b).most_common(6) for b in _inner_loops(code)]}")
    return {"instructions": len(body), "rows_per_iteration": rows,
            "by_opcode": dict(Counter(body).most_common(10))}


def _sass_loops(library: str, k1_library: str, k1_words_per_lane: int,
                ltl_library: str) -> None:
    """Instructions per unit of work as the card runs them, counted
    statically in the innermost loops of the built SASS (a store that a
    predicate skips still counts).

    K1 for Life: every innermost loop that shuffles is a row loop; each
    row it steps loads the lane's words once from shared memory (one LDS),
    so its LDS count is its rows per iteration, whatever the unrolling,
    the shuffles per row or the words per lane.  The loops that store to
    shared memory are the in-tile generations, masked and bare; the one
    that stores to device memory (STG) is the last generation.  K2 at
    r = 5: the row loop steps 16 cells (four words) of one thread per row,
    one STS each.  K3 for Bosco: the row loop steps one word of one lane
    per row, one STG each (a predicate picks it or the shared store)."""
    k1 = []
    k1_code = _sass_functions(k1_library).get("bit_step_kernel", [])
    for body in _inner_loops(k1_code):
        rows = body.count("LDS")
        if body.count("SHFL") and rows:
            words = rows * k1_words_per_lane
            k1.append({"rows_per_iteration": rows,
                       "words_per_iteration": words,
                       "stores_to_device": "STG" in body,
                       "instructions_per_word": len(body) / words,
                       "lop3_shf_per_word":
                           (body.count("LOP3") + body.count("SHF")) / words,
                       "by_opcode_per_word": {
                           k: v / words
                           for k, v in Counter(body).most_common()}})
    in_tile = [loop for loop in k1 if not loop["stores_to_device"]]
    if not in_tile or len(in_tile) == len(k1):
        fail(f"K1's row loops (in-tile and last generation) not found in "
             f"its SASS; innermost loops: "
             f"{[Counter(b).most_common(6) for b in _inner_loops(k1_code)]}")
    steady = min(in_tile, key=lambda loop: loop["instructions_per_word"])
    emit({"phase": "sass", "kernel": "K1", "function": "bit_step_kernel",
          "rule": rule_key(LIFE), "row_loops": k1,
          "instructions_per_word_generation": steady["instructions_per_word"],
          "lop3_shf_per_word_generation": steady["lop3_shf_per_word"],
          "compiled_form_word_ops": word_ops(LIFE)})
    funcs = _sass_functions(library)
    if "dense_step_kernel<5>" not in funcs:
        fail("dense_step_kernel<5> not found in the SASS")
    k2 = _row_loop(funcs["dense_step_kernel<5>"], "PRMT", "STS")
    emit({"phase": "sass", "kernel": "K2", "function": "dense_step_kernel<5>",
          "row_loop": k2, "instructions_per_cell_generation":
              k2["instructions"] / (16 * k2["rows_per_iteration"])})
    k3_funcs = _sass_functions(ltl_library)
    if "ltl_step_kernel" not in k3_funcs:
        fail(f"ltl_step_kernel not found in {ltl_library}")
    k3 = _row_loop(k3_funcs["ltl_step_kernel"], "SHFL", "STG")
    prog = rule_program(BOSCO)
    emit({"phase": "sass", "kernel": "K3", "function": "ltl_step_kernel",
          "rule": rule_key(BOSCO), "hsum": _build.LTL_HSUM[5],
          "row_loop": k3, "instructions_per_word_generation":
              k3["instructions"] / k3["rows_per_iteration"],
          "rule_gates": len(prog.ops), "rule_lop3": lop3_count(prog)})


# -- phase 2: each kernel against its plain version -------------------------

def _compare(kernel, plain, x, rule, boundary, gens, **kw) -> int:
    """The largest |kernel - plain| over the cells, which are 0 or 1: 0
    when ``torch.equal`` holds, else 1 (and the case is named).  ``kw``:
    ``col_limit`` for K1 and K3."""
    got = kernel(x, rule, boundary, gens, **kw)
    want = plain(x, rule, boundary, gens, **kw)
    if torch.equal(got, want):
        return 0
    bad = int((got != want).sum().item())
    print(f"chip_smoke: {kernel.__name__} != plain: {tuple(x.shape)} "
          f"{rule.name} r={rule.radius} {boundary} gens={gens} {kw}: {bad} "
          f"elements differ", file=sys.stderr, flush=True)
    return 1


def _random_rule(rng, radius: int) -> Rule:
    n = (2 * radius + 1) ** 2
    birth = np.flatnonzero(rng.random(n) < 0.3)
    survive = np.flatnonzero(rng.random(n) < 0.4)
    return Rule("fuzz", frozenset(birth[birth > 0].tolist()),
                frozenset(survive.tolist()), radius)


def _words(rng, shape):
    return grid_from_numpy(rng.integers(0, 2**32, size=shape, dtype=np.uint32),
                           "cuda")


def _cells(rng, shape):
    return torch.from_numpy(rng.integers(0, 2, size=shape,
                                         dtype=np.uint8)).cuda()


def _k1_cases() -> list:
    """K1's small cases as (shape in rows and words, rule, boundary, gens),
    the same in every call: phase 1 builds their rules together, phase 2
    runs them."""
    rng = np.random.default_rng(SEED + 1)
    b0 = rule_from_name("B0/S8")
    both = ("periodic", "dead")
    cases = []
    for shape in [(1000, 96), (7, 33), (2048, 128), (1, 1), (130, 31)]:
        for rule in (LIFE, HIGHLIFE, SEEDS, DAY_AND_NIGHT, b0):
            for boundary in both:
                for gens in ([1] if 0 in rule.birth else [1, 2, 8, 9, 16]):
                    cases.append((shape, rule, boundary, gens))
    for _ in range(60):  # random rules, shapes, depths and boundaries
        birth, survive = (int(v) for v in rng.integers(0, 512, size=2))
        rule = Rule("fuzz", frozenset(c for c in range(9) if birth >> c & 1),
                    frozenset(c for c in range(9) if survive >> c & 1))
        gens = 1 if 0 in rule.birth else int(rng.integers(1, 17))
        shape = (int(rng.integers(1, 300)), int(rng.integers(1, 70)))
        cases.append((shape, rule, both[int(rng.integers(0, 2))], gens))
    # every depth, on a grid of two tile rows of CTAs whose last is ragged
    for gens in range(1, 17):
        for boundary in both:
            cases.append(((200, 130), LIFE, boundary, gens))
    # words a row around the tile's edges (a CTA writes 120 of its 128),
    # where rows stop being 16-byte aligned, and very narrow grids; rows
    # around one tile's 128: each wraps the torus seam inside one tile
    widths = [1, 2, *range(29, 34), *range(61, 66), *range(119, 130), 240, 241]
    for i, nw in enumerate(widths):
        rows = (1, 2, 3, 127, 128, 129, 130)[i % 7]
        for boundary in both:
            for gens in (1, 5, 16):
                cases.append(((rows, nw), HIGHLIFE, boundary, gens))
    for rows in (1, 2, 3, 127, 128, 129, 130):
        for boundary in both:
            cases.append(((rows, 7), DAY_AND_NIGHT, boundary, 16))
    # the shallowest passes write 64 rows a CTA
    for rows in (63, 64, 65, 66):
        for boundary in both:
            for gens in (1, 2):
                cases.append(((rows, 127), SEEDS, boundary, gens))
    # larger than two tiles each way: interior CTAs run the bare loop, edge
    # CTAs of a dead grid the masked one; 400 words a row move in 16-byte
    # pieces, 401 and 402 word by word
    for nw in (400, 401, 402):
        for rule in (LIFE, DAY_AND_NIGHT):
            for boundary in both:
                for gens in (1, 3, 8, 16):
                    cases.append(((400, nw), rule, boundary, gens))
    return cases


def _k1_exact(rng) -> tuple:
    cases = _k1_cases()
    err = 0
    for shape, rule, boundary, gens in cases:
        err = max(err, _compare(cuda_bit_step, bit_step_plain,
                                _words(rng, shape), rule, boundary, gens))
    # a view whose rows are not 16-byte aligned goes word by word
    base = _words(rng, (301, 124)).reshape(-1)
    x = base[3:3 + 300 * 124].view(300, 124)
    n = len(cases)
    for boundary in ("periodic", "dead"):
        err = max(err, _compare(cuda_bit_step, bit_step_plain, x, LIFE,
                                boundary, 8))
        n += 1
    x = init_packed(FLAGSHIP, FLAGSHIP, SEED, device="cuda")
    for gens in MAIN_DEPTHS:
        for boundary in ("periodic", "dead"):
            err = max(err, _compare(cuda_bit_step, bit_step_plain, x, LIFE,
                                    boundary, gens))
            n += 1
    del x
    padded = _padded_exact(rng, cuda_bit_step, bit_step_plain,
                           _k1_pad_cases())
    batched = _batched_exact(rng, "K1", cuda_bit_step, bit_step_plain,
                             _k1_batch_cases())
    return n, err, {"padded": padded, "batched": batched}


PAD_BITS = (1, 24, 31)   # pad bits of the last word of a padded row
BATCH = (1, 2, 7, 32)    # boards in one launch


def _k1_pad_cases() -> list:
    """K1 with ``col_limit``: (rows, words, rule, boundary, gens,
    col_limit).  Pads of 1, 24 and 31 bits at 1, 2 and 127-130 words a row
    (at 127 the first CTA's right ghost word is the padded word; on a
    periodic grid every CTA's left ghost of word 0 is), every depth at 1,
    127 and 129 words, and the padded flagship (65000 cells, 2032 words) at
    the main path's depths."""
    rules = (LIFE, SEEDS, DAY_AND_NIGHT, HIGHLIFE)
    cases = []
    for i, nw in enumerate((1, 2, 127, 128, 129, 130)):
        depths = range(1, 17) if nw in (1, 127, 129) else (1, 2, 8, 16)
        for pad in PAD_BITS:
            for boundary in ("periodic", "dead"):
                for gens in depths:
                    rule = rules[(i + gens) % len(rules)]
                    if gens > 1 and 0 in rule.birth:
                        rule = LIFE
                    cases.append((130, nw, rule, boundary, gens,
                                  WORD * nw - pad))
    for gens in MAIN_DEPTHS:
        for boundary in ("periodic", "dead"):
            cases.append((PADDED, PADDED_WORDS, LIFE, boundary, gens, PADDED))
    return cases


def _k1_batch_cases() -> list:
    """K1 on a board axis: (B, rows, words, rule, boundary, gens,
    col_limit).  Rows a multiple of 4 words move in 16-byte pieces (every
    board's base stays aligned), others word by word; ragged rows and
    words, one word a row, padded boards."""
    cases = []
    for B in BATCH:
        for rows, nw in ((70, 128), (129, 131), (33, 4), (5, 1)):
            for boundary in ("periodic", "dead"):
                for gens in (1, 3, 8):
                    cases.append((B, rows, nw, LIFE, boundary, gens, None))
                cases.append((B, rows, nw, HIGHLIFE, boundary, 5,
                              WORD * nw - 24))
    return cases


def _padded_exact(rng, kernel, plain, cases) -> dict:
    err = 0
    for rows, nw, rule, boundary, gens, col_limit in cases:
        x = _words(rng, (rows, nw))
        err = max(err, _compare(kernel, plain, x, rule, boundary, gens,
                                col_limit=col_limit))
    torch.cuda.empty_cache()
    return {"cases": len(cases), "max_abs_err": err}


def _batched_exact(rng, kid, kernel, plain, cases) -> dict:
    """Each batch against the plain version; one launch for the batch."""
    err = 0
    for B, rows, n, rule, boundary, gens, col_limit in cases:
        x = (_words(rng, (B, rows, n)) if kernel is not cuda_dense_step
             else _cells(rng, (B, rows, n)))
        kw = {} if col_limit is None else {"col_limit": col_limit}
        before = kernel.launches
        err = max(err, _compare(kernel, plain, x, rule, boundary, gens, **kw))
        if kernel.launches != before + 1:
            fail(f"{kid} took {kernel.launches - before} launches for a "
                 f"batch of {B}")
    return {"cases": len(cases), "max_abs_err": err}


DENSE_RULES = {1: LIFE, 2: R2, 3: rule_from_name("R3,B20-25,S18-30"),
               5: BOSCO, 7: rule_from_name("R7,B80-100,S75-119")}


def _k2_exact(rng) -> tuple:
    cases = err = 0
    # widths off 32 and 128, and grids below the neighbourhood (periodic
    # wraps count cells more than once)
    shapes = [(300, 333), (37, 100), (129, 257), (3, 2), (1, 1)]
    for r, named in DENSE_RULES.items():
        top = 16 // r
        for rule in (named, _random_rule(rng, r)):
            for shape in shapes:
                x = _cells(rng, shape)
                for boundary in ("periodic", "dead"):
                    for gens in sorted({1, 2, top - 1, top} - {0}):
                        err = max(err, _compare(cuda_dense_step,
                                                dense_step_plain, x, rule,
                                                boundary, gens))
                        cases += 1
    b0 = Rule("b0", frozenset({0, 3}), frozenset({2, 3}), 2)
    for shape in [(40, 33), (5, 3)]:
        for boundary in ("periodic", "dead"):
            err = max(err, _compare(cuda_dense_step, dense_step_plain,
                                    _cells(rng, shape), b0, boundary, 1))
            cases += 1
    for _ in range(40):  # random rules, radii, shapes, depths, boundaries
        r = int(rng.integers(1, 8))
        shape = (int(rng.integers(1, 400)), int(rng.integers(1, 400)))
        boundary = ("periodic", "dead")[int(rng.integers(0, 2))]
        err = max(err, _compare(cuda_dense_step, dense_step_plain,
                                _cells(rng, shape), _random_rule(rng, r),
                                boundary, int(rng.integers(1, 16 // r + 1))))
        cases += 1
    x = init_dense(DENSE, DENSE, SEED, device="cuda")
    for gens in (1, DENSE_PATH[2]):
        for boundary in ("periodic", "dead"):
            err = max(err, _compare(cuda_dense_step, dense_step_plain, x,
                                    BOSCO, boundary, gens))
            cases += 1
    del x
    batch = [(B, rows, cols, rule, boundary, gens, None)
             for B in BATCH
             for rows, cols in ((70, 333), (129, 256), (3, 2))
             for boundary in ("periodic", "dead")
             for rule, gens in ((LIFE, 1), (LIFE, 8), (BOSCO, 1), (BOSCO, 3))]
    batched = _batched_exact(rng, "K2", cuda_dense_step, dense_step_plain,
                             batch)
    return cases, err, {"batched": batched, "seam_band": _band_exact(rng)}


def _band_exact(rng) -> dict:
    """K2 stepping a seam band (periodic strip of 4d columns, d = k r)
    against ``evolve_band``: their middle 2d columns, one board and three,
    at every pass depth of K1 and K3 the seam serves, and at the full
    height of the padded Life path's passes (its depth and its last)."""
    rules = ([(LIFE, k) for k in range(1, 17)]
             + [(rule, k) for r, rule in LTL_RULES.items()
                for k in range(1, max_gens(r) + 1)])
    cases = [(rule, k, (130, 4 * k * rule.radius)) for rule, k in rules]
    cases += [(rule, k, (3, 130, 4 * k * rule.radius)) for rule, k in rules]
    _, _, _, rule, k, steps, _ = PADDED_PATHS[0]
    cases += [(rule, g, (PADDED, 4 * g * rule.radius))
              for g in sorted({k, steps % k} - {0})]
    err = 0
    for rule, k, shape in cases:
        d = k * rule.radius
        band = _cells(rng, shape)
        got = seam.step_band(band, rule, k)[..., d:3 * d]
        want = seam.evolve_band(band, rule, k)[..., d:3 * d]
        if not torch.equal(got, want):
            err = 1
            print(f"chip_smoke: K2 band != evolve_band: {shape} "
                  f"{rule.name} k={k}", file=sys.stderr, flush=True)
    return {"cases": len(cases), "max_abs_err": err}


LTL_RULES = {2: R2, 3: DENSE_RULES[3], 4: rule_from_name("R4,B30-40,S25-50"),
             5: BOSCO, 6: rule_from_name("R6,B50-70,S40-90"),
             7: DENSE_RULES[7]}


def _k3_exact(rng) -> tuple:
    cases = []  # (grid, rule, boundary, gens)
    # (rows, words): ragged, one word per row, small H
    shapes = [(300, 70), (130, 31), (5, 1), (1, 1), (64, 3)]
    for r, named in LTL_RULES.items():
        for rule in (named, _random_rule(rng, r)):
            for shape in shapes:
                x = _words(rng, shape)
                for boundary in ("periodic", "dead"):
                    for gens in range(1, max_gens(r) + 1):
                        cases.append((x, rule, boundary, gens))
    for _ in range(30):  # random rules, radii, shapes, depths, boundaries
        r = int(rng.integers(2, 8))
        shape = (int(rng.integers(1, 300)), int(rng.integers(1, 70)))
        boundary = ("periodic", "dead")[int(rng.integers(0, 2))]
        cases.append((_words(rng, shape), _random_rule(rng, r), boundary,
                      int(rng.integers(1, max_gens(r) + 1))))
    x = init_packed(FLAGSHIP, FLAGSHIP, SEED, device="cuda")
    for _, rule, gens, _ in LTL_PATHS:
        for boundary in ("periodic", "dead"):
            cases.append((x, rule, boundary, gens))
    # every distinct rule's library, in parallel nvcc processes
    rules = list({rule_key(c[1]): c[1] for c in cases}.values())
    t0 = time.perf_counter()
    libs = _build.build_rules("ltl", rules)
    extra = {"rules": len(rules), "build_seconds": time.perf_counter() - t0}
    spilled = _spills(sum((_build.kernel_resources(p) for p in libs), []))
    if spilled:
        fail(f"K3 libraries spill: {spilled}")
    err = 0
    for x, rule, boundary, gens in cases:
        err = max(err, _compare(cuda_ltl_step, ltl_step_plain, x, rule,
                                boundary, gens))
    n = len(cases)
    del x, cases
    pad = [(70, nw, rule, boundary, gens, WORD * nw - p)
           for nw in (1, 2, 31, 127, 130) for p in PAD_BITS
           for r, rule in LTL_RULES.items()
           for boundary in ("periodic", "dead")
           for gens in range(1, max_gens(r) + 1)]
    pad += [(PADDED, PADDED_WORDS, BOSCO, boundary, 1, PADDED)
            for boundary in ("periodic", "dead")]
    extra["padded"] = _padded_exact(rng, cuda_ltl_step, ltl_step_plain, pad)
    batch = [(B, rows, nw, rule, boundary, gens, col_limit)
             for B in BATCH
             for rows, nw in ((70, 31), (129, 33), (5, 1))
             for boundary in ("periodic", "dead")
             for rule, gens in ((R2, 1), (R2, 4), (BOSCO, 1))
             for col_limit in (None, WORD * nw - 24)]
    extra["batched"] = _batched_exact(rng, "K3", cuda_ltl_step,
                                      ltl_step_plain, batch)
    return n, err, extra


def _stripe_plans() -> list:
    """(kernel, rule, plan) of the sparse stripes: the plans of the sparse
    paths and CLI cases of phase 3 (Life at FLAGSHIP² and 512² on K1,
    Bosco at 480 x 500 on K2) and narrow ones (Highlife's one owned word
    and two halo words a tile; Bosco at T 128 with a two-word halo and at
    T 32 with one; R2; K2 at T 16 and 8)."""
    def plan(kid, rule, rows, cols, T, periodic=True):
        packed = kid != "K2"
        return (kid, rule, activity.make_plan(
            rows=rows, cols_units=cols // WORD if packed else cols,
            tile_px=T, radius=rule.radius, periodic=periodic, packed=packed))
    return [plan("K1", LIFE, FLAGSHIP, FLAGSHIP, SPARSE_T),
            plan("K1", LIFE, 512, 512, 32),
            plan("K1", HIGHLIFE, 64, 128, 32),
            plan("K3", BOSCO, 1024, 1024, 128),
            plan("K3", BOSCO, 256, 256, 32, periodic=False),
            plan("K3", R2, 256, 256, 32),
            plan("K2", BOSCO, 480, 500, 20, periodic=False),
            plan("K2", BOSCO, 48, 48, 16),
            plan("K2", LIFE, 128, 128, 8)]


def _stripe_exact(rng) -> dict:
    """Each kernel at a dead boundary and gens 1 on the stripes of
    ``_stripe_plans``, at every rung and at 1-3, 5 and 7 tiles (stripes of
    K1 and K3 whose rows do and do not move in 16-byte pieces), against its
    plain version."""
    wrappers = {"K1": (cuda_bit_step, bit_step_plain),
                "K2": (cuda_dense_step, dense_step_plain),
                "K3": (cuda_ltl_step, ltl_step_plain)}
    out = {kid: {"cases": 0, "max_abs_err": 0, "shapes": []}
           for kid in wrappers}
    for kid, rule, plan in _stripe_plans():
        kernel, plain = wrappers[kid]
        for K in sorted(set(plan.capacities) | {1, 2, 3, 5, 7}):
            shape = plan.stripe_shape(K)
            x = _cells(rng, shape) if kid == "K2" else _words(rng, shape)
            o = out[kid]
            o["max_abs_err"] = max(o["max_abs_err"], _compare(
                kernel, plain, x, rule, "dead", 1))
            o["cases"] += 1
            o["shapes"].append(list(shape))
    return out


def phase2_exact() -> dict:
    rng = np.random.default_rng(SEED)
    errs = {}
    t0 = time.perf_counter()
    stripes = _stripe_exact(rng)
    emit({"phase": "stripe_vs_plain", "boundary": "dead", "gens": 1,
          "seconds": time.perf_counter() - t0, **stripes})
    for kid, check in (("K1", _k1_exact), ("K2", _k2_exact),
                       ("K3", _k3_exact)):
        t0 = time.perf_counter()
        cases, err, extra = check(rng)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        emit({"phase": "kernel_vs_plain", "kernel": kid, "cases": cases,
              "max_abs_err": err, "seconds": time.perf_counter() - t0,
              **extra})
        # the new modes' cases count in the kernel's error
        errs[kid] = max([err, stripes[kid]["max_abs_err"]]
                        + [v["max_abs_err"] for v in extra.values()
                           if isinstance(v, dict)])
    if any(errs.values()):
        fail(f"a kernel disagrees with its plain version (tolerance: exact): "
             f"{errs}")
    return errs


# -- phase 3: the main paths -------------------------------------------------

def _plain_final(kind, rows, cols, rule, steps, boundary="periodic",
                 comm_every=1):
    """The plain version's grid after ``steps`` generations from the same
    hash init, on the card: the kernel's plain version generation by
    generation, at the padded width with the pad zeroed after each one
    and, on a periodic padded grid, the seam band stepped by
    ``evolve_band`` and stitched after each pass of ``comm_every``."""
    if kind == "dense":
        g = init_dense(rows, cols, SEED, device="cuda")
        for _ in range(steps):
            g = dense_step_plain(g, rule, boundary)
        return g
    cols_eff = -(-cols // WORD) * WORD
    col_limit = cols if cols_eff != cols else None
    g = init_packed(rows, cols_eff, SEED, col_limit=col_limit, device="cuda")
    plain = bit_step_plain if kind == "bit" else ltl_step_plain

    def one_pass(src, k, dst):
        for _ in range(k):
            src = plain(src, rule, boundary, 1, col_limit=col_limit)
        return src

    if col_limit and boundary == "periodic":
        evolve = seam.make_seam_stepper(one_pass, rule, cols, comm_every,
                                        band=seam.evolve_band)
    else:
        evolve = segmented_evolve(one_pass, comm_every)
    return evolve(g, steps, None)[0]


def _blocks_differ(final: np.ndarray, g: torch.Tensor, packed: bool) -> int:
    """Blocks of 2048 rows where the host grid ``final`` differs from the
    device grid ``g`` (packed again on the card, at ``g``'s padded width,
    when ``g`` is packed)."""
    block, differ = 2048, 0
    pad = g.shape[-1] * WORD - final.shape[-1] if packed else 0
    for r0 in range(0, final.shape[0], block):
        cells = torch.from_numpy(final[r0:r0 + block]).cuda()
        if packed:
            cells = pack(torch.nn.functional.pad(cells, (0, pad)))
        differ += not torch.equal(cells, g[..., r0:r0 + block, :])
    return differ


def _drive(label, kid, kind, shape, rule, comm_every, steps,
           boundary="periodic") -> tuple:
    """``run_cuda`` on one main path with the kernels' launch counters reset
    just before; its whole final grid must equal the plain version's.
    Returns the path kernel's launches and the final grid."""
    rows, cols = shape
    cfg = GolConfig(rows=rows, cols=cols, steps=steps, seed=SEED, rule=rule,
                    comm_every=comm_every, boundary=boundary)
    plan = backend.plan_engine(cfg)
    if plan[0] != kind:
        fail(f"the {label} path routes to {plan[0]}, not {kind}")
    timer = PhaseTimer()
    for k in KERNELS.values():
        k.launches = 0
    final = backend.run_cuda(cfg, timer=timer)
    launches = {k: w.launches for k, w in KERNELS.items()}
    if launches[kid] == 0:
        fail(f"the {label} main path launched {kid} no time: {launches}")
    if final.shape != (rows, cols) or final.dtype != np.uint8:
        fail(f"run_cuda returned {final.shape} {final.dtype}")
    pop = int(final.sum(dtype=np.int64))
    g = _plain_final(kind, rows, cols, rule, steps, boundary, comm_every)
    plain_pop = (int(g.sum(dtype=torch.int64).item()) if kind == "dense"
                 else population(g))
    differ = _blocks_differ(final, g, kind != "dense")
    del g
    torch.cuda.empty_cache()
    if pop != plain_pop or differ:
        fail(f"{label} main path population {pop} vs plain {plain_pop}; "
             f"{differ} blocks of 2048 rows differ from the plain grid")
    emit({"phase": "main_path", "path": label, "kernel": kid,
          "grid": [rows, cols], "cols_eff": plan[1], "pad_bits": plan[2],
          "seam": plan[2] > 0 and boundary == "periodic",
          "boundary": boundary, "rule": str(rule), "steps": steps,
          "comm_every": comm_every, "launches": launches,
          "grid_equal_to_plain": True, "population": pop,
          "plain_population": plain_pop,
          "setup_s": timer.setup_us / 1e6, "steady_s": timer.nosetup_us / 1e6,
          "cell_updates_per_s": timer.cells_per_sec(rows, cols, steps)})
    return launches[kid], final


def _drive_strip() -> None:
    """``run_cuda`` on ``SEAM_STRIP``: the padded periodic Life path's
    route (K1 with ``col_limit``, the seam band on K2) at its full width
    and fewer rows, against ``dense_step_plain`` generation by generation
    on the real width, a plain version that uses none of the pad or seam
    code that ``_plain_final`` shares with the engine."""
    rows, steps = SEAM_STRIP
    label, _, kind, rule, k, _, boundary = PADDED_PATHS[0]
    cfg = GolConfig(rows=rows, cols=PADDED, steps=steps, seed=SEED,
                    rule=rule, comm_every=k, boundary=boundary)
    plan = backend.plan_engine(cfg)
    if plan[0] != kind or not plan[2]:
        fail(f"the {label} strip routes to {plan}, not padded {kind}")
    for w in KERNELS.values():
        w.launches = 0
    final = backend.run_cuda(cfg)
    launches = {kid: w.launches for kid, w in KERNELS.items()}
    if not (launches["K1"] and launches["K2"]):
        fail(f"the {label} strip launched {launches}: K1 and the band's K2 "
             f"expected")
    g = init_dense(rows, PADDED, SEED, device="cuda")
    for _ in range(steps):
        g = dense_step_plain(g, rule, boundary)
    equal = torch.equal(torch.from_numpy(final).cuda(), g)
    del g
    torch.cuda.empty_cache()
    if not equal:
        fail(f"the {label} strip ({rows} x {PADDED}, {steps} gens) differs "
             f"from dense_step_plain's")
    emit({"phase": "seam_strip", "path": label, "grid": [rows, PADDED],
          "cols_eff": plan[1], "pad_bits": plan[2], "rule": str(rule),
          "steps": steps, "comm_every": k, "launches": launches,
          "equal_to_dense_step_plain": True})


def _drive_batched() -> int:
    """The batched path: ``BATCH_PATH``'s boards stepped by
    ``step_batched`` (passes of comm_every), then a ``step_batched_units``
    stretch at depth 1, K1's launch counter reset just before; one launch
    per pass for the whole batch, and every board equal to the plain
    version's."""
    label, B, size, rule, k, steps, units = BATCH_PATH
    cfg = GolConfig(rows=size, cols=size, steps=0, seed=SEED, rule=rule,
                    comm_every=k)
    engine = backend.build_engine(cfg)
    seeds = [SEED + b for b in range(B)]
    grids = engine.init_grids(seeds=seeds)
    engine.warm_up(boards=B)
    engine.sync()
    for w in KERNELS.values():
        w.launches = 0
    t0 = time.perf_counter()
    grids = engine.step_batched(grids, steps)
    engine.sync()
    t1 = time.perf_counter()
    grids = engine.step_batched_units(grids, units)
    engine.sync()
    t2 = time.perf_counter()
    launches = {kid: w.launches for kid, w in KERNELS.items()}
    passes = -(-steps // k) + units
    if launches != {"K1": passes, "K2": 0, "K3": 0}:
        fail(f"the batched path launched {launches}, expected {passes} K1 "
             f"launches (one a pass for {B} boards)")
    pops = engine.population_batched(grids)
    want = torch.stack([init_packed(size, size, s, device="cuda")
                        for s in seeds])
    for _ in range(steps + units):
        want = bit_step_plain(want, rule, "periodic", 1)
    want_pops = [population(w) for w in want]
    if not torch.equal(grids, want) or pops != want_pops:
        fail(f"the batched path's boards differ from the plain version's "
             f"(populations {pops[:4]}... vs {want_pops[:4]}...)")
    del want, grids
    torch.cuda.empty_cache()
    cells = B * size * size
    emit({"phase": "main_path", "path": label, "kernel": "K1",
          "boards": B, "grid": [size, size], "rule": str(rule),
          "steps": steps, "comm_every": k, "units_after": units,
          "launches": launches, "grid_equal_to_plain": True,
          "populations_first_4": pops[:4],
          "step_batched_s": t1 - t0,
          "cell_updates_per_s": cells * steps / (t1 - t0),
          "step_batched_units_s": t2 - t1,
          "units_cell_updates_per_s": cells * units / (t2 - t1)})
    return launches["K1"]


def _sparse_board() -> torch.Tensor:
    """The sparse Life path's board at FLAGSHIP², packed on the card: the
    reference's ``quiescent_board(SPARSE_ACTIVE)`` on SPARSE_T² tiles (a
    horizontal blinker at the middle of each of the first k tiles of a
    square block, row by row) and an 8 x 8 lattice of gliders, each 300
    cells short of a lattice corner, so that they cross tile edges and the
    last row and column of them the periodic seam (SPARSE_GLIDERS)."""
    N, T = FLAGSHIP, SPARSE_T
    k = int(round(SPARSE_ACTIVE * (N // T) ** 2))
    side = int(np.ceil(np.sqrt(max(k, 1))))
    grid = torch.zeros((N, N // WORD), dtype=torch.int32, device="cuda")
    p = torch.arange(k, device="cuda")
    rows, first = (p // side) * T + T // 2, (p % side) * T + T // 2 - 1
    for dc in range(3):  # cells first .. first + 2 of each row
        c = first + dc
        grid.view(-1).index_put_(
            (rows * (N // WORD) + c // WORD,),
            torch.ones_like(c, dtype=torch.int32) << (c % WORD).int(),
            accumulate=True)
    lattice = N // 8
    for a in range(8):
        for b in range(8):
            r0, c0 = (a + 1) * lattice - 300, (b + 1) * lattice - 300
            if a == b == 7:  # else it wraps both seams into the blinkers
                c0 -= lattice // 2
            for dr, row in enumerate(GLIDER):
                for dc, cell in enumerate(row):
                    if cell:
                        c = c0 + dc
                        grid[r0 + dr, c // WORD] |= 1 << (c % WORD)
    return grid


def _soup_board() -> torch.Tensor:
    """The reference's soup at FLAGSHIP²: each cell live with probability
    SOUP[0], drawn on the card from SEED and packed 4096 rows at a time."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grid = torch.empty((FLAGSHIP, FLAGSHIP // WORD), dtype=torch.int32,
                       device="cuda")
    for r0 in range(0, FLAGSHIP, 4096):
        cells = torch.rand((4096, FLAGSHIP), generator=gen, device="cuda")
        grid[r0:r0 + 4096] = pack((cells < SOUP[0]).to(torch.uint8))
    return grid


def _sparse_engine():
    cfg = GolConfig(rows=FLAGSHIP, cols=FLAGSHIP, steps=0, seed=SEED,
                    sparse_tile=SPARSE_T)
    engine = backend.build_engine(cfg)
    if engine.kind != "bit" or engine.sparse_plan is None:
        fail(f"the sparse Life path planned {engine.kind}, "
             f"{engine.sparse_plan}")
    return engine


def _dense_engine(comm_every: int):
    return backend.build_engine(GolConfig(rows=FLAGSHIP, cols=FLAGSHIP,
                                          steps=0, seed=SEED,
                                          comm_every=comm_every))


def _drive_sparse(label: str, board: torch.Tensor, steps: int,
                  plain: bool) -> int:
    """The sparse Life engine from ``board``: one generation (the probe that
    settles the all-ones start), then ``steps - 1`` in one dispatch, K1's
    counter reset just before.  The whole final grid must equal the dense
    K1 engine's (comm_every 8) and, when ``plain``, the plain version's,
    generation by generation."""
    engine = _sparse_engine()
    state = activity.initial_state(board.clone(), engine.sparse_plan)
    engine.warm_up()
    engine.sync()
    evolve = engine._evolve
    for w in KERNELS.values():
        w.launches = 0
    t0 = time.perf_counter()
    state = engine.step(state, 1)
    settled = engine.sparse_stats(state)
    phases0, reads0 = Counter(evolve.phases), evolve.reads
    t1 = time.perf_counter()
    state = engine.step(state, steps - 1)
    engine.sync()
    t2 = time.perf_counter()
    launches = {kid: w.launches for kid, w in KERNELS.items()}
    if launches["K1"] == 0 or launches["K2"] or launches["K3"]:
        fail(f"the {label} path launched {launches}: K1 alone expected")
    stats = engine.sparse_stats(state)
    pop = engine.population(state)
    dense = _dense_engine(MAIN_GENS)
    dense.warm_up()
    g = dense.step(board.clone(), steps)
    equal_dense = torch.equal(g, state.grid)
    del g, dense
    equal_plain = None
    if plain:
        g = board
        for _ in range(steps):
            g = bit_step_plain(g, LIFE, "periodic", 1)
        equal_plain = torch.equal(g, state.grid)
        del g
    del state
    torch.cuda.empty_cache()
    if not equal_dense or equal_plain is False:
        fail(f"the {label} path's final grid differs from the dense K1 "
             f"engine's ({equal_dense}) or the plain version's "
             f"({equal_plain})")
    emit({"phase": "main_path", "path": label, "kernel": "K1",
          "grid": [FLAGSHIP, FLAGSHIP], "sparse_tile": SPARSE_T,
          "plan": engine.sparse_plan.__dict__, "steps": steps,
          "launches": launches, "equal_to_dense_k1": equal_dense,
          "equal_to_plain": equal_plain, "population": pop,
          "stats_after_settle": settled, "stats_final": stats,
          "phases": {" ".join(map(str, k)): v for k, v in
                     (evolve.phases - phases0).items()},
          "host_reads": evolve.reads - reads0,
          "settle_s": t1 - t0, "steady_s": t2 - t1,
          "ms_per_generation": (t2 - t1) * 1e3 / (steps - 1),
          "cell_updates_per_s": FLAGSHIP ** 2 * (steps - 1) / (t2 - t1)})
    return launches["K1"]


def _drive_deep(final_k3: np.ndarray) -> int:
    """``run_cuda`` on DEEP_PATH: comm_every 4 at r 5 runs K2 passes of 3,
    so its final grid must equal DENSE_PATH's (comm_every 3)."""
    label, rule, k, steps = DEEP_PATH
    cfg = GolConfig(rows=DENSE, cols=DENSE, steps=steps, seed=SEED,
                    rule=rule, comm_every=k)
    if (backend.select_engine(cfg), backend.pass_depth(cfg)) != ("dense", 3):
        fail(f"the {label} path plans {backend.select_engine(cfg)} at "
             f"depth {backend.pass_depth(cfg)}")
    for w in KERNELS.values():
        w.launches = 0
    timer = PhaseTimer()
    final = backend.run_cuda(cfg, timer=timer)
    launches = {kid: w.launches for kid, w in KERNELS.items()}
    # a pass of 3 (and a remainder of 1) for 1201 generations, and the
    # warm-up's one launch at each depth
    want = -(-steps // 3) + 2
    if launches != {"K1": 0, "K2": want, "K3": 0}:
        fail(f"the {label} path launched {launches}, expected {want} K2")
    if not np.array_equal(final, final_k3):
        fail(f"the {label} path's final grid differs from the comm_every-3 "
             f"path's")
    emit({"phase": "main_path", "path": label, "kernel": "K2",
          "grid": [DENSE, DENSE], "rule": str(rule), "steps": steps,
          "comm_every": k, "pass_depth": 3, "launches": launches,
          "equal_to_comm_every_3": True,
          "population": int(final.sum(dtype=np.int64)),
          "setup_s": timer.setup_us / 1e6, "steady_s": timer.nosetup_us / 1e6,
          "cell_updates_per_s": timer.cells_per_sec(DENSE, DENSE, steps)})
    return launches["K2"]


def _cli_cases(d: str) -> None:
    """The CLI against the serial oracle: every ``.gol`` file byte for
    byte, and the kernel the run should take launched."""
    # 500 is not a whole number of words: Life at comm_every 3 and Bosco
    # at 1 take K1 and K3 padded (dead) and with the seam band (periodic);
    # Bosco at 2 stays on K2, at 4 (20 cells of halo) in K2 passes of 3;
    # sparse runs on K1 (Life) and, at a width that is not whole words, K2
    cases = [(512, 512, "life", ["--comm-every", "4"], "K1"),
             (512, 512, "bosco", ["--comm-every", "1"], "K3"),
             (500, 500, "life", ["--comm-every", "3"], "K1"),
             (500, 500, "bosco", ["--comm-every", "1"], "K3"),
             (500, 500, "bosco", ["--comm-every", "2"], "K2"),
             (512, 512, "bosco", ["--comm-every", "4"], "K2"),
             (512, 512, "life", ["--sparse", "32"], "K1"),
             (480, 500, "bosco", ["--sparse", "20"], "K2")]
    for rows, cols, rule, extra, kid in cases:
        for boundary in ("periodic", "dead"):
            common = [str(rows), str(cols), "10", "30", "--save", "--seed",
                      "5", "--rule", rule, "--boundary", boundary, "--quiet",
                      "--name", "n"]
            tag = f"{rows}x{cols}-{rule}-{'-'.join(extra)}-{boundary}"
            cu, ser = os.path.join(d, f"cu-{tag}"), os.path.join(d, f"se-{tag}")
            KERNELS[kid].launches = 0
            rc = (cli_main(common + ["--out-dir", cu] + extra),
                  cli_main(common + ["--out-dir", ser, "--backend", "serial"]))
            if rc != (0, 0):
                fail(f"CLI exit codes {rc} ({tag})")
            if KERNELS[kid].launches == 0:
                fail(f"the CLI run {tag} launched {kid} no time")
            names = sorted(f for f in os.listdir(ser) if f.endswith(".gol"))
            _, mismatch, errors = filecmp.cmpfiles(ser, cu, names, shallow=False)
            if len(names) != 5 or mismatch or errors:
                fail(f"CLI .gol files differ from the serial oracle ({tag}): "
                     f"{mismatch + errors}")
    emit({"phase": "cli", "cases": [f"{h}x{w} {r} {' '.join(e)} ({k})"
                                    for h, w, r, e, k in cases],
          "boundaries": ["periodic", "dead"],
          "gol_files_identical_to_serial": True})


def phase3_main_paths() -> dict:
    square = (FLAGSHIP, FLAGSHIP)
    launches = {"K1": _drive("life", "K1", "bit", square, LIFE, MAIN_GENS,
                             MAIN_STEPS)[0]}
    launches["K3"] = {label: _drive(label, "K3", "ltl", square, rule, k, n)[0]
                      for label, rule, k, n in LTL_PATHS}
    label, rule, k, n = DENSE_PATH
    launches["K2"], final_k3 = _drive(label, "K2", "dense", (DENSE, DENSE),
                                      rule, k, n)
    launches[DEEP_PATH[0]] = _drive_deep(final_k3)
    del final_k3
    for label, kid, kind, rule, k, n, boundary in PADDED_PATHS:
        launches[label] = _drive(label, kid, kind, (PADDED, PADDED), rule, k,
                                 n, boundary)[0]
    _drive_strip()
    launches[BATCH_PATH[0]] = _drive_batched()
    launches["sparse_life"] = _drive_sparse("sparse_life", _sparse_board(),
                                            SPARSE_STEPS, plain=True)
    launches["sparse_soup"] = _drive_sparse("sparse_soup", _soup_board(),
                                            SOUP[1], plain=False)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        _cli_cases(d)
    return launches


# -- phase 4: times ----------------------------------------------------------

def _events_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ping_pong(fn, x):
    """A callable that runs ``fn(src, dst)`` once, alternating two buffers
    as the engine does, starting from a copy of ``x``."""
    bufs = [x.clone(), torch.empty_like(x)]

    def one():
        fn(bufs[0], bufs[1])
        bufs.reverse()
    return one


def _pass_ms(kernel, x, rule, gens, reps=20) -> float:
    """ms per pass, ping-ponging as the engine does: each pass reads the
    last output."""
    one_pass = _ping_pong(
        lambda a, b: kernel(a, rule, "periodic", gens, out=b), x)
    for _ in range(3):
        one_pass()
    return _events_ms(one_pass, reps)


def _plain_ms(plain, x, rule, gens, boundary="periodic", **kw) -> float:
    plain(x, rule, boundary, gens, **kw)  # warm the allocator
    return _events_ms(lambda: plain(x, rule, boundary, gens, **kw), 2)


def _row(card, kid, grid, rule, gens, ms, plain_ms, t_bytes, t_ops, **extra):
    cells = grid[0] * grid[1]
    row = {"phase": "times", "card": card, "kernel": kid, "grid": grid,
           "rule": str(rule), "gens": gens, "ms": ms,
           "cell_updates_per_s": cells * gens / (ms / 1e3),
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes_ms": t_bytes, "operations_ms": t_ops, **extra}
    emit(row)
    return row


# K1's variants by the macros that select them in csrc/bitlife.cu; "kept"
# is the design every wrapper and main path runs ("no_col_limit" is it
# without the code for padded grids, which an unpadded pass must not pay
# for).  "as_before" puts
# together what the kernel did before its redesign: the rule from run-time
# masks, one word a lane, the end lanes zeroing their shuffled sums, every
# CTA masking every word.
K1_VARIANTS = {
    "kept": None,
    "rule_gates": {"K1_RULE_GATES": 1},
    "rule_masks": {"K1_RULE_MASKS": 1},
    "as_before": {"K1_RULE_MASKS": 1, "K1_WPL": 1, "K1_ZERO_GHOSTS": 1,
                  "K1_EDGE_TESTS": 1},
    "words_per_lane_1": {"K1_WPL": 1},
    "words_per_lane_2": {"K1_WPL": 2},
    "ghost_lanes": {"K1_GHOST": 4},
    "ghost_lanes_through_registers": {"K1_GHOST": 4, "K1_CP_ASYNC": 0},
    "load_through_registers": {"K1_CP_ASYNC": 0},
    "zero_ghosts": {"K1_ZERO_GHOSTS": 1},
    "edge_tests": {"K1_EDGE_TESTS": 1},
    "ghost_lanes_rows_128": {"K1_GHOST": 4, "K1_ROWS": 128},
    "rows_64": {"K1_ROWS": 64},
    "rows_128": {"K1_ROWS": 128},
    "rows_192": {"K1_ROWS": 192},
    "no_col_limit": {"K1_COL_LIMIT": 0},
}


def _k1_turns(card: str, x: torch.Tensor) -> None:
    """K1's kept design and its variants on the 65536² grid at gens 8, 4,
    2 and 1, in turns: every variant once in order and once in reverse, so
    each is timed early and late (for two, that is old, new, new, old).
    Each variant's output must equal the kept design's."""
    names = list(K1_VARIANTS)
    t0 = time.perf_counter()
    paths = _build.build_rules("bit", [LIFE] * len(names),
                               list(K1_VARIANTS.values()))
    build_s = time.perf_counter() - t0
    libs = {n: _build.load_rule_library("bit", LIFE, K1_VARIANTS[n])
            for n in names}
    for n in names:
        if (K1_VARIANTS[n] or {}).get("K1_RULE_MASKS"):
            err = libs[n].gol_bit_set_masks(LIFE.birth_mask,
                                            LIFE.survive_mask)
            if err:
                fail(f"gol_bit_set_masks failed for {n}: CUDA error {err}")
    emit({"phase": "k1_variants", "card": card, "rule": rule_key(LIFE),
          "defines": K1_VARIANTS, "build_seconds_all_variants": build_s,
          "ptxas": {n: _build.kernel_resources(p)
                    for n, p in zip(names, paths)},
          "ctas_per_sm": {n: {g: libs[n].gol_bit_ctas_per_sm(g)
                              for g in (1, 4, 8)} for n in names}})
    out, want = torch.empty_like(x), torch.empty_like(x)
    for gens in sorted({2, *MAIN_DEPTHS}, reverse=True):
        bit_launch(libs["kept"], x, want, "periodic", gens)
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            def one_pass(lib=libs[n]):
                bit_launch(lib, x, out, "periodic", gens)
            for _ in range(3):
                one_pass()
            ms[n].append(_events_ms(one_pass, 10))
            if not torch.equal(out, want):
                fail(f"K1 variant {n} differs from the kept design at gens "
                     f"{gens}")
        emit({"phase": "k1_turns", "card": card, "rule": rule_key(LIFE),
              "gens": gens, "grid": [FLAGSHIP, FLAGSHIP], "ms": ms,
              "fastest": min(names, key=lambda n: sum(ms[n]))})


def _hsum_turns(card: str, x: torch.Tensor) -> None:
    """K3's two horizontal sums (0: carry-save adders over the 2r+1
    shifted copies; 1: doubling window sums) at every radius's deepest
    pass and at the main paths' depths, in turns (0, 1, 1, 0), ms per
    pass on the 65536² grid."""
    configs = [(rule, max_gens(r)) for r, rule in LTL_RULES.items()]
    configs += [(rule, g) for _, rule, k, n in LTL_PATHS
                for g in sorted({k, n % k} - {0})
                if (rule, g) not in configs]
    t0 = time.perf_counter()
    for form in (0, 1):
        _build.build_rules("ltl", [rule for rule, _ in configs],
                           {"LTL_HSUM": form})
    build_s = time.perf_counter() - t0
    out = torch.empty_like(x)
    for rule, gens in configs:
        libs = [_build.load_rule_library("ltl", rule, {"LTL_HSUM": form})
                for form in (0, 1)]
        ms = {0: [], 1: []}
        for form in (0, 1, 1, 0):
            def one_pass(lib=libs[form]):
                ltl_launch(lib, x, out, rule, "periodic", gens)
            for _ in range(3):
                one_pass()
            ms[form].append(_events_ms(one_pass, 10))
        best = min((0, 1), key=lambda f: sum(ms[f]))
        emit({"phase": "k3_hsum", "card": card, "rule": rule_key(rule),
              "gens": gens, "grid": [FLAGSHIP, FLAGSHIP],
              "ms_carry_save": ms[0], "ms_doubling": ms[1],
              "faster": best, "kept": _build.LTL_HSUM[rule.radius],
              "build_seconds_both_forms_all_rules": build_s})


def _turns(fns: dict, reps: int = 10) -> dict:
    """ms per call of each of ``fns`` (name -> callable), in turns: every
    one in order, then in reverse, each warmed up three times first."""
    ms = {n: [] for n in fns}
    for n in list(fns) + list(fns)[::-1]:
        for _ in range(3):
            fns[n]()
        ms[n].append(_events_ms(fns[n], reps))
    return ms


def _seam_pass(rule, C, k, band):
    """A callable (src, dst) running one pass of the padded periodic engine
    (K1 with ``col_limit``, the band stepped by ``band`` and stitched)."""
    evolve = seam.make_seam_stepper(
        lambda src, g, dst: cuda_bit_step(src, rule, "periodic", g, out=dst,
                                          col_limit=C),
        rule, C, k, band=band)
    return lambda src, dst: evolve(src, k, dst)


def _padded_times(card: str, rows: dict) -> None:
    """The padded paths at PADDED², in turns: Life's gens-8 pass as K1 with
    ``col_limit`` alone, as the engine runs it (with the seam band on K2),
    with the band on ``evolve_band`` instead, and forced onto K2 (the route
    before this PR, uint8 cells, periodic); the band alone on K2 and on
    ``evolve_band``; the dead Bosco pass on K3 with ``col_limit`` against
    K2."""
    C, k = PADDED, PADDED_PATHS[0][4]
    x = init_packed(PADDED, PADDED_WORDS * WORD, SEED, col_limit=C,
                    device="cuda")
    words = x.numel()
    dense = init_dense(PADDED, PADDED, SEED, device="cuda")
    d = k * LIFE.radius
    band = _cells(np.random.default_rng(SEED), (PADDED, 4 * d))
    life = _turns({
        "k1_col_limit": _ping_pong(
            lambda a, b: cuda_bit_step(a, LIFE, "periodic", k, out=b,
                                       col_limit=C), x),
        "engine_pass_k2_band": _ping_pong(
            _seam_pass(LIFE, C, k, seam.step_band), x),
        "engine_pass_evolve_band": _ping_pong(
            _seam_pass(LIFE, C, k, seam.evolve_band), x),
        "band_k2": lambda: seam.step_band(band, LIFE, k),
        "band_evolve_band": lambda: seam.evolve_band(band, LIFE, k),
        "k2_forced": _ping_pong(
            lambda a, b: cuda_dense_step(a, LIFE, "periodic", k, out=b),
            dense),
    })
    mean = {n: sum(v) / len(v) for n, v in life.items()}
    emit({"phase": "padded_times", "card": card, "path": "padded_life",
          "grid": [PADDED, PADDED], "cols_eff": PADDED_WORDS * WORD,
          "gens": k, "ms": life,
          "seam_share_of_engine_pass":
              1 - mean["k1_col_limit"] / mean["engine_pass_k2_band"],
          "band_kept": "k2" if mean["band_k2"] <= mean["band_evolve_band"]
          else "evolve_band",
          "k2_forced_over_engine_pass":
              mean["k2_forced"] / mean["engine_pass_k2_band"]})
    if mean["band_k2"] > mean["band_evolve_band"]:
        fail("K2 steps the seam band slower than evolve_band: keep the "
             "faster (parallel/seam.py:step_band)")
    rows["K1", "padded"] = _row(
        card, "K1", [PADDED, PADDED], LIFE, k, mean["k1_col_limit"],
        _plain_ms(bit_step_plain, x, LIFE, k, col_limit=C),
        8 * words / HBM_BYTES_PER_S * 1e3,
        k * words * word_ops(LIFE) / INT32_OPS_PER_S * 1e3,
        mode="col_limit", col_limit=C, library_ms=None)
    # the band on K2: 2 B per cell of the strip per pass, K2's operations
    cells = band.numel()
    rows["K2", "band"] = _row(
        card, "K2", list(band.shape), LIFE, k, mean["band_k2"],
        mean["band_evolve_band"], 2 * cells / HBM_BYTES_PER_S * 1e3,
        k * cells * K2_CELL_OPS / INT32_OPS_PER_S * 1e3, mode="seam_band",
        ops_per_cell=K2_CELL_OPS, library_ms=None,
        plain_note="evolve_band, timed in the turns above")
    bosco = _turns({
        "k3_col_limit": _ping_pong(
            lambda a, b: cuda_ltl_step(a, BOSCO, "dead", 1, out=b,
                                       col_limit=C), x),
        "k2_forced": _ping_pong(
            lambda a, b: cuda_dense_step(a, BOSCO, "dead", 1, out=b), dense),
    })
    mean = {n: sum(v) / len(v) for n, v in bosco.items()}
    emit({"phase": "padded_times", "card": card, "path": "padded_bosco",
          "grid": [PADDED, PADDED], "boundary": "dead", "gens": 1,
          "ms": bosco,
          "k2_forced_over_k3": mean["k2_forced"] / mean["k3_col_limit"]})
    rows["K3", "padded"] = _row(
        card, "K3", [PADDED, PADDED], BOSCO, 1, mean["k3_col_limit"],
        _plain_ms(ltl_step_plain, x, BOSCO, 1, boundary="dead",
                  col_limit=C),
        8 * words / HBM_BYTES_PER_S * 1e3,
        words * ltl_word_ops_lower(BOSCO) / INT32_OPS_PER_S * 1e3,
        mode="col_limit", col_limit=C, boundary="dead", library_ms=None)
    del x, dense, band
    torch.cuda.empty_cache()


def _batched_times(card: str, rows: dict) -> None:
    """A pass over a batch in one launch against the same boards in one
    launch each (BATCH_PATH's 32 boards of 4096²), in turns: K1 at gens 8
    and 1, K3 (Bosco, gens 1), and K2 on 16 boards (Bosco, gens 3: the
    cells of its 16384² path)."""
    _, B, size, _, k, _, _ = BATCH_PATH
    x = torch.stack([init_packed(size, size, SEED + b, device="cuda")
                     for b in range(B)])
    cells = torch.stack([init_dense(size, size, SEED + b, device="cuda")
                         for b in range(B // 2)])
    out = {}
    for kid, wrapper, grids, rule, gens in (
            ("K1", cuda_bit_step, x, LIFE, k),
            ("K1", cuda_bit_step, x, LIFE, 1),
            ("K3", cuda_ltl_step, x, BOSCO, 1),
            ("K2", cuda_dense_step, cells, BOSCO, DENSE_PATH[2])):
        o = torch.empty_like(grids)

        def batched(w=wrapper, g=grids, r=rule, n=gens):
            w(g, r, "periodic", n, out=o)

        def solo(w=wrapper, g=grids, r=rule, n=gens):
            for b in range(g.shape[0]):
                w(g[b], r, "periodic", n, out=o[b])

        before = wrapper.launches
        batched()
        if wrapper.launches != before + 1:
            fail(f"a batched {kid} pass took {wrapper.launches - before} "
                 f"launches")
        ms = _turns({"batched": batched, "solo": solo}, reps=10)
        mean = {n: sum(v) / len(v) for n, v in ms.items()}
        n_boards = grids.shape[0]
        emit({"phase": "batched_times", "card": card, "kernel": kid,
              "boards": n_boards, "grid": [size, size], "rule": str(rule),
              "gens": gens, "ms_per_pass": ms,
              "ms_per_board_generation": {
                  n: v / (n_boards * gens) for n, v in mean.items()},
              "solo_over_batched": mean["solo"] / mean["batched"]})
        out[kid, gens] = mean["batched"]
        n = grids.numel()
        if kid == "K2":
            t_bytes = 2 * n / HBM_BYTES_PER_S * 1e3
            t_ops = gens * n * K2_CELL_OPS / INT32_OPS_PER_S * 1e3
            plain = dense_step_plain
        else:
            t_bytes = 8 * n / HBM_BYTES_PER_S * 1e3
            ops = word_ops(LIFE) if kid == "K1" else ltl_word_ops_lower(rule)
            t_ops = gens * n * ops / INT32_OPS_PER_S * 1e3
            plain = bit_step_plain if kid == "K1" else ltl_step_plain
        if (kid, gens) != ("K1", 1):
            rows[kid, "batched"] = _row(
                card, kid, [n_boards, size, size], rule, gens,
                mean["batched"], _plain_ms(plain, grids, rule, gens),
                t_bytes, t_ops, mode="boards", library_ms=None)
    del x, cells
    torch.cuda.empty_cache()


def _sparse_times(card: str, rows: dict) -> None:
    """The sparse Life engine against the dense K1 engine at comm_every 1
    and 8 on the same boards (the sparse path's and the soup), SPARSE_TIMED
    generations a dispatch, in turns, in ms a generation (CUDA events
    around each dispatch: with the host's reads inside, the device's whole
    span, idle time included); and the stripe step (K1, dead, gens 1, at
    the top rung of the sparse path's plan and at its lower) against its
    bound."""
    n = SPARSE_TIMED
    for label, make in (("sparse_life", _sparse_board),
                        ("sparse_soup", _soup_board)):
        board = make()
        sparse = _sparse_engine()
        engines = {"sparse": sparse, "dense_1": _dense_engine(1),
                   "dense_8": _dense_engine(MAIN_GENS)}
        states = {"sparse": sparse.step(
            activity.initial_state(board.clone(), sparse.sparse_plan), 1)}
        for name in ("dense_1", "dense_8"):
            states[name] = board.clone()
        del board
        for e in engines.values():
            e.warm_up()

        def runner(name):
            def run():
                states[name] = engines[name].step(states[name], n)
            return run

        reads = sparse._evolve.reads
        ms = _turns({name: runner(name) for name in engines}, reps=1)
        per_gen = {name: sum(v) / len(v) / n for name, v in ms.items()}
        emit({"phase": "sparse_times", "card": card, "path": label,
              "grid": [FLAGSHIP, FLAGSHIP], "sparse_tile": SPARSE_T,
              "generations_a_dispatch": n, "ms_per_dispatch": ms,
              "ms_per_generation": per_gen,
              "dense_1_over_sparse": per_gen["dense_1"] / per_gen["sparse"],
              "dense_8_over_sparse": per_gen["dense_8"] / per_gen["sparse"],
              "stats": sparse.sparse_stats(states["sparse"]),
              "host_reads_per_dispatch":
                  (sparse._evolve.reads - reads) / len(ms["sparse"]) / 4})
        rows[label] = per_gen
        del states, engines, sparse
        torch.cuda.empty_cache()
    plan = _stripe_plans()[0][2]
    for K in plan.capacities:
        shape = plan.stripe_shape(K)
        x = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, 2**32, size=shape, dtype=np.uint32).view(np.int32)).cuda()
        one = _ping_pong(lambda a, b: cuda_bit_step(a, LIFE, "dead", 1, out=b),
                         x)
        for _ in range(3):
            one()
        words = x.numel()
        rows["K1", "stripe", K] = _row(
            card, "K1", [shape[0], shape[1] * WORD], LIFE, 1,
            _events_ms(one, 50),
            _plain_ms(bit_step_plain, x, LIFE, 1, boundary="dead"),
            8 * words / HBM_BYTES_PER_S * 1e3,
            words * word_ops(LIFE) / INT32_OPS_PER_S * 1e3,
            mode=f"sparse stripe, {K} tiles, dead", library_ms=None)
        del x


def phase4_times(card: str) -> dict:
    rows = {}
    x = init_packed(FLAGSHIP, FLAGSHIP, SEED, device="cuda")
    words = x.numel()
    for gens in MAIN_DEPTHS:  # K1: 8 B per word per pass; word_ops per gen
        rows["K1", gens] = _row(
            card, "K1", [FLAGSHIP, FLAGSHIP], LIFE, gens,
            _pass_ms(cuda_bit_step, x, LIFE, gens),
            _plain_ms(bit_step_plain, x, LIFE, gens),
            8 * words / HBM_BYTES_PER_S * 1e3,
            gens * words * word_ops(LIFE) / INT32_OPS_PER_S * 1e3,
            word_ops=word_ops(LIFE), library_ms=None,
            library_note="no single PyTorch call computes a Life generation")
    for label, rule, k, n in LTL_PATHS:  # K3: as K1, from below and above
        lower, upper = ltl_word_ops_lower(rule), ltl_word_ops(rule)
        for gens in sorted({k, n % k} - {0}):
            t_bytes = 8 * words / HBM_BYTES_PER_S * 1e3
            rows["K3", label, gens] = _row(
                card, "K3", [FLAGSHIP, FLAGSHIP], rule, gens,
                _pass_ms(cuda_ltl_step, x, rule, gens, reps=10),
                _plain_ms(ltl_step_plain, x, rule, gens),
                t_bytes, gens * words * lower / INT32_OPS_PER_S * 1e3,
                word_ops_lower=lower, word_ops_upper=upper,
                bound_ms_upper_count=max(
                    t_bytes, gens * words * upper / INT32_OPS_PER_S * 1e3),
                library_ms=None,
                library_note="no single PyTorch call computes a "
                             "Larger-than-Life generation")
    _k1_turns(card, x)
    _hsum_turns(card, x)
    del x
    torch.cuda.empty_cache()

    label, rule, k, n = DENSE_PATH
    x = init_dense(DENSE, DENSE, SEED, device="cuda")
    cells, r = x.numel(), rule.radius
    # the counts alone, as one library call: a (2r+1)² box of ones over the
    # pre-padded grid in float16 (exact: counts <= 225 < 2048)
    padded = pad_grid(x, r, "periodic")
    box = torch.ones((1, 1, 2 * r + 1, 2 * r + 1), dtype=torch.half,
                     device="cuda")
    conv_in = padded.half()[None, None]
    conv = lambda: torch.nn.functional.conv2d(conv_in, box)  # noqa: E731
    # let cuDNN time its algorithms for this shape and keep the fastest
    torch.backends.cudnn.benchmark = True
    if not torch.equal((conv()[0, 0] - x.half()).to(torch.uint8),
                       counts_from_padded(padded, r)):
        fail("conv2d's counts differ from the plain counts")
    library_ms = _events_ms(conv, 10)
    torch.backends.cudnn.benchmark = False
    del padded, conv_in
    for gens in sorted({k, n % k} - {0}):  # K2: 2 B per cell per pass
        rows["K2", gens] = _row(
            card, "K2", [DENSE, DENSE], rule, gens,
            _pass_ms(cuda_dense_step, x, rule, gens, reps=10),
            _plain_ms(dense_step_plain, x, rule, gens),
            2 * cells / HBM_BYTES_PER_S * 1e3,
            gens * cells * K2_CELL_OPS / INT32_OPS_PER_S * 1e3,
            ops_per_cell=K2_CELL_OPS, library_ms=library_ms,
            library_note="conv2d of the padded grid, float16, (2r+1)² ones: "
                         "one generation's counts only (centre included), "
                         "no rule")
    del x
    torch.cuda.empty_cache()
    _padded_times(card, rows)
    _batched_times(card, rows)
    _sparse_times(card, rows)
    return rows


# -- phase 5: traces ---------------------------------------------------------

# the CUDA kernels of each wrapper, as their names appear in a trace
KERNEL_NAMES = {"K1": ("bit_step_kernel",),
                "K2": ("dense_step_kernel", "dense_narrow_kernel"),
                "K3": ("ltl_step_kernel",)}


def _trace_holds_launches(label: str, attempt):
    """The one trace rule of phases 5, 6 and 7: a traced window holds
    exactly the kernel launches the wrappers counted in it.  ``attempt()``
    traces the window once and returns ``(counted, in_trace, result)``,
    dicts of kernel id -> launches counted and kernel records in the
    trace.  More records than launches fail at once (a kernel ran
    uncounted); fewer take the window once more — the profiler drops a
    kernel's record now and then (one of 200 on one path of a whole run),
    while a launch that the code counts and does not make would be missing
    again — and fail the second time.  Returns ``(result, takes, lost)``,
    ``lost`` the records missing on a retaken attempt."""
    lost = []
    for take in (1, 2):
        counted, in_trace, result = attempt()
        if any(in_trace.get(kid, 0) > n for kid, n in counted.items()):
            fail(f"the {label} trace holds {in_trace} kernels for "
                 f"{counted} counted launches: a kernel ran uncounted")
        if all(in_trace.get(kid, 0) == n for kid, n in counted.items()):
            return result, take, lost
        lost.append({kid: n - in_trace.get(kid, 0)
                     for kid, n in counted.items()})
        print(f"chip_smoke: the {label} trace lost {lost[-1]} kernel "
              f"records; tracing again", file=sys.stderr, flush=True)
    fail(f"the {label} trace holds {in_trace} kernels for {counted} "
         f"counted launches, twice")


def _trace(card, label, size, rule, comm_every, steps,
           boundary="periodic", boards=0, board=None) -> None:
    """The steady stepping of ``run_cuda``'s engine on one main path (or of
    ``step_batched`` on a batch of ``boards``, or of the sparse Life engine
    from ``board()`` once its first generation has settled the map) under
    ``torch.profiler``, inside a ``steady`` host range opened once the
    profiler has seen one kernel: the device is busy for the union of its
    kernel intervals in that range, and idle for the rest of it.  Host
    operations that run before the first kernel say what delays it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    if board is not None:
        engine = _sparse_engine()
        grid = engine.step(activity.initial_state(board(), engine.sparse_plan),
                           1)
    else:
        cfg = GolConfig(rows=size, cols=size, steps=steps, seed=SEED,
                        rule=rule, comm_every=comm_every, boundary=boundary)
        engine = backend.build_engine(cfg)
        grid = (engine.init_grids(seeds=range(SEED, SEED + boards)) if boards
                else engine.init_grid())
    engine.warm_up(boards=boards)
    engine.sync()
    # one launch a pass of the path's kernel, and of K2 for the seam band;
    # the sparse path's launches follow its phases: its kernel's alone
    passes = -(-steps // engine.depth)
    expected = {kid: 0 for kid in KERNELS}
    expected[engine.kernel_id] = passes
    if engine.seam:
        expected["K2"] = passes
    reads = engine._evolve.reads if board is not None else 0
    unprofiled_ms = None
    if board is not None:
        # the profiler's own host cost per operation lengthens a host-bound
        # window: time one window without it too
        t0 = time.perf_counter()
        grid = engine.step(grid, steps)
        engine.sync()
        unprofiled_ms = (time.perf_counter() - t0) * 1e3

    def attempt():
        nonlocal grid
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the profiler's first kernel
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            before = {kid: w.launches for kid, w in KERNELS.items()}
            builds = _build.builds
            with record_function("steady"):
                if boards:
                    grid = engine.step_batched(grid, steps)
                else:
                    grid = engine.step(grid, steps)
                engine.sync()
        counted = {kid: w.launches - before[kid]
                   for kid, w in KERNELS.items()}
        if board is not None:
            expected[engine.kernel_id] = max(1, counted[engine.kernel_id])
        if counted != expected:
            fail(f"the {label} path launched {counted}, expected {expected} "
                 f"(one a pass)")
        if _build.builds != builds:
            fail(f"the {label} path built a kernel while it stepped")
        events = prof.events()
        # every counted launch is a kernel in the trace, and no kernel of
        # K1-K3 ran uncounted: the whole profile holds none outside the
        # range, so it is counted whole, free of the clocks' offset
        in_trace = {kid: sum(1 for e in events
                             if e.device_type == DeviceType.CUDA
                             and any(n in e.name for n in names))
                    for kid, names in KERNEL_NAMES.items()}
        return counted, in_trace, (events, counted, in_trace)

    (events, counted, in_trace), _, lost = _trace_holds_launches(label,
                                                                  attempt)
    launches = counted[engine.kernel_id]
    del grid
    torch.cuda.empty_cache()
    # the host's range: the profiler also puts a copy of it on the device's
    # timeline, spanning only the kernels
    steady = next(e.time_range for e in events if e.name == "steady"
                  and e.device_type == DeviceType.CPU)
    # every kernel that ends inside the range (the profiler's device clock
    # is aligned to the host's to within about a millisecond, so the first
    # kernel launched in the range may seem to start before it), clipped
    # to the range
    spans = sorted((max(e.time_range.start, steady.start), e.time_range.end,
                    e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.name != "steady"
                   and e.time_range.end > steady.start)
    wall_us = steady.end - steady.start
    busy_us, end, by_name, gaps = 0.0, float("-inf"), {}, []
    for start, stop, name in spans:
        if end > float("-inf"):
            gaps.append(max(0.0, start - end))
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        count, us = by_name.get(name, (0, 0.0))
        by_name[name] = (count + 1, us + stop - start)
    first = spans[0][0] if spans else steady.end
    early = sorted(((e.time_range.end - e.time_range.start, e.name)
                    for e in events if e.device_type == DeviceType.CPU
                    and e.name != "steady"
                    and steady.start <= e.time_range.start < first),
                   reverse=True)[:5]
    own = KERNEL_NAMES[engine.kernel_id][0]
    traced = sum(c for n, (c, _) in by_name.items() if own in n)
    emit({"phase": "trace", "card": card, "path": label,
          "kernel": engine.kernel_id, "grid": [size, size], "boards": boards,
          "boundary": boundary, "pad_bits": engine.pad_bits,
          "seam": engine.seam,
          # device time of every other kernel (the seam band's on K2 and
          # its extract and stitch), by the same union
          "other_kernels_ms": sum(us for n, (_, us) in by_name.items()
                                  if own not in n) / 1e3,
          "steps": steps, "comm_every": comm_every,
          "pass_depth": engine.depth, "launches": launches,
          "sparse_tile": board is not None and SPARSE_T,
          # host reads of the active count over both attempts (sparse path)
          "host_reads": (engine._evolve.reads - reads
                         if board is not None else 0),
          # the path kernel's launches the trace holds in its window, and
          # every kernel's launches, counted and in the whole trace
          "traced_launches": traced,
          "launches_by_kernel": counted, "kernels_in_trace": in_trace,
          "records_lost_on_retried_attempts": lost,
          "builds_in_window": 0,
          "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
          # None when the profiler recorded no device activity
          "idle_share": 1 - busy_us / wall_us if spans else None,
          # the sparse path: a window of the same steps without the
          # profiler, and the idle share its device time implies there
          "unprofiled_wall_ms": unprofiled_ms,
          "idle_share_unprofiled": (1 - busy_us / 1e3 / unprofiled_ms
                                    if unprofiled_ms else None),
          # where the idle time lies: before the first kernel, between
          # kernels (and the largest such gap), after the last
          "first_kernel_after_ms": (first - steady.start) / 1e3,
          "gaps_between_kernels_ms": sum(gaps) / 1e3,
          "largest_gap_ms": max(gaps, default=0.0) / 1e3,
          "after_last_kernel_ms": (steady.end - end) / 1e3 if spans else None,
          "host_ops_before_first_kernel": [
              {"name": n, "ms": us / 1e3} for us, n in early],
          "kernels": [{"name": n, "count": c, "ms": us / 1e3}
                      for n, (c, us) in sorted(by_name.items())]})


def phase5_traces(card: str) -> None:
    _trace(card, "life", FLAGSHIP, LIFE, MAIN_GENS, MAIN_STEPS)
    for label, rule, k, n in LTL_PATHS:
        _trace(card, label, FLAGSHIP, rule, k, n)
    label, rule, k, n = DENSE_PATH
    _trace(card, label, DENSE, rule, k, n)
    for label, _, _, rule, k, n, boundary in PADDED_PATHS:
        _trace(card, label, PADDED, rule, k, n, boundary)
    label, B, size, rule, k, n, _ = BATCH_PATH
    _trace(card, label, size, rule, k, n, boards=B)
    label, rule, k, n = DEEP_PATH
    _trace(card, label, DENSE, rule, k, n)
    _trace(card, "sparse_life", FLAGSHIP, LIFE, 1, SPARSE_STEPS - 1,
           board=_sparse_board)


# -- phase 6: the serve layer --------------------------------------------------

# (sessions, size, comm_every, generations a request, rounds timed, rounds
# traced): the batched path's 32 boards of 4096² Life (64 MiB), one K1
# pass a request, coalesced into one launch a round
SERVE_LIFE = (32, 4096, 8, 8, 100, 20)
# (sessions per engine, size, ticket depths, cycles): 4096² Bosco on K3
# (comm_every 1) and on K2 (comm_every 3); the depths rotate by session so
# every round mixes them, and 5 cycles pass checkpoint_every
SERVE_LTL = (8, 4096, (1, 2, 5, 8), 5)
SERVE_CHECKPOINT_EVERY = 64
# (sessions, size, generations a request, rounds): solo steps (no batcher)
# of sessions that share one 4096² Life engine, one thread each
SERVE_SOLO = (8, 4096, 8, 25)
SERVE_FAULT_SIZE = 256


def _reset_launches() -> None:
    for w in KERNELS.values():
        w.launches = 0


def _launches() -> dict:
    return {kid: w.launches for kid, w in KERNELS.items()}


def _serve_rounds(mgr, sids, rounds: int, n: int) -> float:
    """``rounds`` requests of ``n`` generations from one thread a session,
    all started together; the wall seconds."""
    errors, barrier = [], threading.Barrier(len(sids))

    def run(sid):
        try:
            barrier.wait()
            for _ in range(rounds):
                mgr.step(sid, n)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(s,)) for s in sids]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"serving failed: {errors[:3]}")
    return wall


def _no_faults(mgr, label: str) -> None:
    batch = mgr.stats().get("batch", {})
    counts = {"batched_fallbacks": batch.get("batched_fallbacks", 0),
              "async_batched_fallbacks": mgr.dispatcher.batched_fallbacks,
              "engine_failures": mgr.engine_failures,
              "degraded_total": mgr.degraded_total}
    if any(counts.values()):
        fail(f"the {label} serving fell back or failed: {counts}")


def _serve_trace(fn):
    """Run ``fn`` under ``torch.profiler`` inside a ``serve`` range: the
    range's wall ms, the union of its kernels' intervals (busy ms), and the
    count and summed ms of K1's kernels in the whole trace.  Only ``fn``
    launches K1 there, and the profiler places a kernel up to milliseconds
    before its launch (phase 7's ``kernel_placement``), so a K1 kernel that
    ``fn`` launched at once can sit before the range's start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        with record_function("serve"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    window = next(e.time_range for e in events if e.name == "serve"
                  and e.device_type == DeviceType.CPU)
    spans = sorted((max(e.time_range.start, window.start), e.time_range.end,
                    e.name) for e in events
                   if e.device_type == DeviceType.CUDA and e.name != "serve"
                   and e.time_range.end > window.start)
    busy, end = 0.0, float("-inf")
    for start, stop, _ in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    k1 = [e.time_range.end - e.time_range.start for e in events
          if e.device_type == DeviceType.CUDA
          and KERNEL_NAMES["K1"][0] in e.name]
    return {"wall_ms": (window.end - window.start) / 1e3,
            "busy_ms": busy / 1e3, "k1_kernels": len(k1),
            "k1_ms": sum(k1) / 1e3}


def _serve_life(card: str, times: dict) -> None:
    """Part 1 (coalesced Life sessions on K1), part 5 (the wait truly
    waits) and part 6 (the per-layer numbers)."""
    B, size, k, n, rounds, traced = SERVE_LIFE
    mgr = SessionManager(EngineCache(), batch_max=B)
    spec = {"rows": size, "cols": size, "rule": "life", "comm_every": k,
            "segments": [1, k]}
    infos = [mgr.create(dict(spec, seed=SEED + b)) for b in range(B)]
    if [i["cache_hit"] for i in infos] != [False] + [True] * (B - 1):
        fail("the Life sessions' creates were not one miss and hits")
    if {i["engine_compiles"] for i in infos} != {infos[0]["engine_compiles"]}:
        fail("a cache hit compiled")
    sids = [i["id"] for i in infos]
    engine = mgr.get(sids[0]).engine
    _serve_rounds(mgr, sids, 1, n)      # warms the (n, B) batched step
    builds = _build.builds

    def steps_and_warmups(st0, c0):
        # a step is one K1 launch (one pass); a batch width met for the
        # first time (a round that split) warms its depth once: one more
        st1 = mgr.batcher.stats()
        return (st1["coalesced_calls"] - st0["coalesced_calls"]
                + st1["solo_steps"] - st0["solo_steps"],
                engine.compile_count - c0, st1)

    st0, c0 = mgr.batcher.stats(), engine.compile_count
    steady0 = [mgr.get(s).steady_s for s in sids]
    _reset_launches()
    cpu0 = time.process_time()
    wall = _serve_rounds(mgr, sids, rounds, n)
    cpu = time.process_time() - cpu0
    launches = _launches()
    calls, warmups, st1 = steps_and_warmups(st0, c0)
    if launches != {"K1": calls + warmups, "K2": 0, "K3": 0} or not calls:
        fail(f"coalesced serving launched {launches} for {calls} steps and "
             f"{warmups} warm-ups (one K1 launch each)")
    boards = st1["batched_boards"] - st0["batched_boards"]
    # part 5: the layer's own step time against the kernels' own, in a
    # trace that holds every counted K1 launch (phase 5's rule: one more
    # take when the profiler lost a record, never a looser count)
    steady_after_rounds = [mgr.get(s).steady_s for s in sids]

    def attempt():
        s0, c0 = mgr.batcher.stats(), engine.compile_count
        steady1 = [mgr.get(s).steady_s for s in sids]
        _reset_launches()
        trace = _serve_trace(lambda: _serve_rounds(mgr, sids, traced, n))
        traced_launches = _launches()["K1"]
        traced_calls, traced_warmups, s1 = steps_and_warmups(s0, c0)
        if _build.builds != builds:
            fail("a kernel was built while the sessions were served")
        if traced_launches != traced_calls + traced_warmups:
            fail(f"the traced serving counted {traced_launches} K1 launches "
                 f"for {traced_calls} steps and {traced_warmups} warm-ups")
        return ({"K1": traced_launches}, {"K1": trace["k1_kernels"]},
                (s0, s1, steady1, trace, traced_launches, traced_calls))

    (s0, s1, steady1, trace, traced_launches, traced_calls), takes, _ = \
        _trace_holds_launches("serve", attempt)
    layer_s = (s1["batched_step_s"] - s0["batched_step_s"]
               + s1["solo_step_s"] - s0["solo_step_s"])
    steady = [mgr.get(s).steady_s - t for s, t in zip(sids, steady1)]
    whole = (s1["coalesced_calls"] - s0["coalesced_calls"] == traced
             and s1["batched_boards"] - s0["batched_boards"] == B * traced)
    if layer_s * 1e3 < trace["k1_ms"]:
        fail(f"the serve layer's step time {layer_s * 1e3} ms is below its "
             f"K1 kernels' {trace['k1_ms']} ms: the wait did not wait")
    if whole and min(steady) * 1e3 < trace["k1_ms"]:
        fail(f"a session's steady_s ({min(steady) * 1e3} ms) is below the "
             f"K1 kernels it waited for ({trace['k1_ms']} ms)")
    _no_faults(mgr, "Life")
    total = n * (1 + rounds + traced * takes)
    if any(mgr.get(s).generation != total for s in sids):
        fail("a Life session lost a step")
    # step_batched alone on the same boards, same generations: the
    # boards must equal the sessions', and the plain version's (two)
    ref = engine.init_grids(seeds=[SEED + b for b in range(B)])
    engine.sync()
    t0 = time.perf_counter()
    ref = engine.step_batched(ref, total)
    engine.sync()
    alone_s = time.perf_counter() - t0
    got = torch.stack([mgr.get(s).grid for s in sids])
    if not torch.equal(got, ref):
        fail("the served Life boards differ from step_batched's")
    plain = torch.stack([init_packed(size, size, SEED + b, device="cuda")
                         for b in (0, B - 1)])
    plain = bit_step_plain(plain, LIFE, "periodic", 1)
    for _ in range(total - 1):
        plain = bit_step_plain(plain, LIFE, "periodic", 1)
    if not (torch.equal(got[0], plain[0]) and torch.equal(got[-1], plain[1])):
        fail("the served Life boards differ from the plain version's")
    phase4_ms = times["K1", "batched"]["ms"]
    emit({"phase": "serve", "part": "coalesced_life", "card": card,
          "kernel": "K1", "sessions": B, "grid": [size, size],
          "comm_every": k, "generations_a_request": n, "rounds": rounds,
          "cache": mgr.cache.stats(),
          "engine_compiles": engine.compile_count,
          "engine_batched_compiles": engine.batched_compile_count,
          "compile_wall_s": engine.compile_wall_s,
          "launches": launches, "steps": calls, "warmups": warmups,
          "avg_occupancy": boards / max(1, st1["coalesced_calls"]
                                        - st0["coalesced_calls"]),
          "solo_steps": st1["solo_steps"] - st0["solo_steps"],
          "boards_equal_to_step_batched_and_plain": True,
          "builds_while_serving": 0,
          "serving_wall_s": wall,
          "serving_board_generations_per_s": B * n * rounds / wall,
          "step_batched_board_generations_per_s": B * total / alone_s,
          "requests_per_s": B * rounds / wall,
          "host_cpu_ms_per_request": cpu * 1e3 / (B * rounds),
          "steady_s_over_rounds": {"min": min(s - t for s, t in
                                              zip(steady_after_rounds, steady0)),
                                   "max": max(s - t for s, t in
                                              zip(steady_after_rounds, steady0))},
          "phase4_k1_batched_ms_per_pass": phase4_ms,
          "min_steady_over_phase4_kernel_time":
              min(s - t for s, t in zip(steady_after_rounds, steady0)) * 1e3
              / (rounds * phase4_ms)})
    emit({"phase": "serve", "part": "trace", "card": card, "rounds": traced,
          "takes": takes,
          "every_round_coalesced": whole, "k1_launches": traced_launches,
          "steps": traced_calls, **trace,
          "idle_share": 1 - trace["busy_ms"] / trace["wall_ms"],
          "layer_step_ms": layer_s * 1e3,
          "min_session_steady_ms": min(steady) * 1e3,
          "layer_step_over_k1_ms": layer_s * 1e3 / trace["k1_ms"]})
    mgr.shutdown()
    del ref, got, plain
    torch.cuda.empty_cache()


def _serve_solo_threads(card: str) -> None:
    """Sessions sharing one engine step solo (``batching=False``) from one
    thread each: their launches interleave on the engine's ping-pong spare,
    and every board must equal the plain version's."""
    B, size, n, rounds = SERVE_SOLO
    mgr = SessionManager(EngineCache(), batching=False)
    sids = [mgr.create({"rows": size, "cols": size, "rule": "life",
                        "comm_every": n, "segments": [n],
                        "seed": SEED + b})["id"] for b in range(B)]
    engine = mgr.get(sids[0]).engine
    if any(mgr.get(s).engine is not engine for s in sids):
        fail("the solo Life sessions do not share one engine")
    _reset_launches()
    wall = _serve_rounds(mgr, sids, rounds, n)
    launches = _launches()
    if (launches != {"K1": B * rounds, "K2": 0, "K3": 0}
            or engine.batched_step_calls):
        fail(f"{B * rounds} solo steps launched {launches} "
             f"({engine.batched_step_calls} batched steps)")
    _no_faults(mgr, "solo Life")
    got = torch.stack([mgr.get(s).grid for s in sids])
    plain = torch.stack([init_packed(size, size, SEED + b, device="cuda")
                         for b in range(B)])
    for _ in range(n * rounds):
        plain = bit_step_plain(plain, LIFE, "periodic", 1)
    if not torch.equal(got, plain):
        bad = [b for b in range(B) if not torch.equal(got[b], plain[b])]
        fail(f"the solo boards {bad} stepped from {B} threads on one "
             f"engine differ from the plain version's")
    emit({"phase": "serve", "part": "solo_threads", "card": card,
          "kernel": "K1", "sessions": B, "threads": B, "grid": [size, size],
          "generations_a_request": n, "rounds": rounds,
          "launches": launches, "serving_wall_s": wall,
          "boards_equal_to_plain": True})
    mgr.shutdown()
    del got, plain
    torch.cuda.empty_cache()


def _ltl_plain(kid: str, size: int, seeds, gens: int) -> torch.Tensor:
    """The plain version's boards of 4096² Bosco after ``gens``
    generations: packed words stepped by K3's plain version, or cells by
    K2's."""
    if kid == "K3":
        x = torch.stack([init_packed(size, size, s, device="cuda")
                         for s in seeds])
        for _ in range(gens):
            x = ltl_step_plain(x, BOSCO, "periodic", 1)
        return x
    x = torch.stack([init_dense(size, size, s, device="cuda") for s in seeds])
    for g in [3] * (gens // 3) + [gens % 3] * bool(gens % 3):
        x = dense_step_plain(x, BOSCO, "periodic", g)
    return x


def _ltl_sessions(mgr, per: int, size: int) -> dict:
    """``per`` sessions of Bosco at ``size``² on K3 (comm_every 1) and
    ``per`` on K2 (comm_every 3), seeds SEED, SEED + 1, ...: kernel -> sids."""
    sids = {kid: [mgr.create({"rows": size, "cols": size, "rule": "bosco",
                              "comm_every": k, "seed": SEED + i})["id"]
                  for i in range(per)] for kid, k in (("K3", 1), ("K2", 3))}
    for kid, ids in sids.items():
        if mgr.get(ids[0]).engine.kernel_id != kid:
            fail(f"the Bosco sessions meant for {kid} took another engine")
    return sids


def _ticket_cycle(mgr, sids: list, depths) -> None:
    """One ticket of each depth for every session, the depths rotated by
    session so every round mixes them; waits for all."""
    out = [mgr.step_async(sid, d) for i, sid in enumerate(sids)
           for d in depths[i % len(depths):] + depths[:i % len(depths)]]
    for t in out:
        r = mgr.ticket_result(t["ticket"], wait=True, timeout_s=600)
        if r["status"] != "done":
            fail(f"a ticket did not finish: {r}")


def _serve_ltl(card: str, state_dir: str) -> None:
    """Part 2 (LtL sessions through tickets on K3 and K2, with no state
    dir: the serving alone) and part 3 (the same with a state dir, then
    a restore)."""
    per, size, depths, cycles = SERVE_LTL
    mgr = SessionManager(EngineCache())
    sids = _ltl_sessions(mgr, per, size)
    every = sids["K3"] + sids["K2"]
    _ticket_cycle(mgr, every, depths)   # warms the batch widths a cycle meets
    engines = [mgr.get(ids[0]).engine for ids in sids.values()]
    builds = _build.builds
    st0 = mgr.dispatcher.stats()
    c0 = sum(e.compile_count for e in engines)
    _reset_launches()
    t0 = time.perf_counter()
    for _ in range(cycles - 1):
        _ticket_cycle(mgr, every, depths)
    wall = time.perf_counter() - t0
    launches = _launches()
    st1 = mgr.dispatcher.stats()
    # one launch a unit round of a chain, and one a batch width warmed
    unit_rounds = st1["unit_rounds"] - st0["unit_rounds"]
    warmups = sum(e.compile_count for e in engines) - c0
    if (launches["K1"] or not launches["K3"] or not launches["K2"]
            or launches["K3"] + launches["K2"] != unit_rounds + warmups
            or st1["solo_tickets"] != st0["solo_tickets"]):
        fail(f"the ticket rounds launched {launches} for {unit_rounds} "
             f"unit rounds and {warmups} warm-ups")
    if _build.builds != builds:
        fail("a kernel was built while the tickets were served")
    _no_faults(mgr, "ticket")
    gens = cycles * sum(depths)
    for kid, ids in sids.items():
        want = _ltl_plain(kid, size, [SEED + i for i in range(per)], gens)
        if not torch.equal(torch.stack([mgr.get(s).grid for s in ids]),
                           want):
            fail(f"the {kid} ticket sessions' boards differ from the plain "
                 f"version's")
    del want
    emit({"phase": "serve", "part": "tickets", "card": card,
          "sessions": {kid: per for kid in sids}, "grid": [size, size],
          "rule": "bosco", "comm_every": {"K3": 1, "K2": 3},
          "depths": list(depths), "cycles": cycles, "generations": gens,
          "launches": launches, "unit_rounds": unit_rounds,
          "warmups": warmups, "rounds": st1["group_dispatches"]
          - st0["group_dispatches"], "max_occupancy": st1["max_occupancy"],
          "wall_s": wall, "board_generations_per_s":
              2 * per * (cycles - 1) * sum(depths) / wall,
          "boards_equal_to_plain": True, "builds_while_serving": 0})
    # part 3: the same tickets with a state dir; a second manager restores
    # from a copy of it, so the first can step on without writing into the
    # second's records
    durable = SessionManager(EngineCache(), state_dir=state_dir,
                             checkpoint_every=SERVE_CHECKPOINT_EVERY)
    if _ltl_sessions(durable, per, size) != sids:
        fail("the durable manager's session ids differ")
    t0 = time.perf_counter()
    for _ in range(cycles):
        _ticket_cycle(durable, every, depths)
    durable_s = time.perf_counter() - t0
    for sid in every:
        if not torch.equal(durable.get(sid).grid, mgr.get(sid).grid):
            fail(f"session {sid} with a state dir differs from without")
    mgr.shutdown()
    durable.shutdown()
    _no_faults(durable, "durable ticket")
    copy = state_dir + "_restored"
    shutil.copytree(state_dir, copy)
    t0 = time.perf_counter()
    restored = SessionManager(EngineCache(), state_dir=copy,
                              checkpoint_every=SERVE_CHECKPOINT_EVERY)
    restore_s = time.perf_counter() - t0
    snaps = [rec.get("snapshot") for rec in restored.store.load_records()]
    if (restored.restored_sessions != len(every) or restored.restore_errors
            or not all(snaps)):
        fail(f"restored {restored.restored_sessions} of {len(every)} "
             f"sessions ({restored.restore_errors} errors, "
             f"{sum(map(bool, snaps))} snapshots)")
    for sid in every:
        if not torch.equal(restored.get(sid).grid, durable.get(sid).grid):
            fail(f"restored session {sid} differs from the one it restores")
    for m in (durable, restored):
        for sid in every:
            m.step(sid, 3)
    for sid in every:
        if not torch.equal(restored.get(sid).grid, durable.get(sid).grid):
            fail(f"restored session {sid} and its original diverged")
    _no_faults(restored, "restored")
    store = durable.store.stats()
    emit({"phase": "serve", "part": "restore", "card": card,
          "sessions": len(every), "checkpoint_every": SERVE_CHECKPOINT_EVERY,
          "durable_cycles": cycles, "durable_wall_s": durable_s,
          "durable_board_generations_per_s":
              2 * per * cycles * sum(depths) / durable_s,
          "store": {k: store[k] for k in ("writes", "write_s",
                                          "snapshot_writes",
                                          "journal_appends", "bytes_full",
                                          "bytes_delta", "compactions")},
          "snapshot_generations": sorted({s["generation"] for s in snaps}),
          "restored_generation": gens, "restore_s": restore_s,
          "bit_identical": True, "equal_after_3_more": True})
    restored.shutdown()
    torch.cuda.empty_cache()


def _serve_faults(card: str) -> None:
    """Part 4: injected faults at 256²."""
    size, n = SERVE_FAULT_SIZE, 8
    spec = {"rows": size, "cols": size, "comm_every": n, "segments": [n]}

    def oracle(seed, gens):
        return evolve_np(init_tile_np(size, size, seed), gens, LIFE,
                         "periodic")

    def board(mgr, sid):
        return mgr.snapshot_array(sid)[0]

    out = {}
    mgr = SessionManager(faults="step:1:raise", step_retries=2,
                         retry_backoff_s=0.001, batching=False)
    sid = mgr.create(dict(spec, seed=7))["id"]
    if (mgr.step(sid, n)["generation"] != n or mgr.engine_failures != 1
            or not np.array_equal(board(mgr, sid), oracle(7, n))):
        fail("a transient fault did not retry to the oracle's board")
    out["transient"] = {"engine_failures": mgr.engine_failures}
    mgr.shutdown()

    mgr = SessionManager(faults="step:1:delay:2.0", request_timeout_s=0.5,
                         step_retries=0, batching=False)
    sid = mgr.create(dict(spec, seed=8))["id"]
    try:
        mgr.step(sid, n)
        fail("a step delayed past its deadline returned")
    except DeadlineError:
        pass
    mgr.shutdown()                      # joins the abandoned worker
    gen = mgr.get(sid).generation       # the late step commits
    mgr.step(sid, n)
    if not np.array_equal(board(mgr, sid), oracle(8, gen + n)):
        fail("the session behind a missed deadline lost its board")
    out["deadline"] = {"watchdog_timeouts": mgr.watchdog_timeouts,
                       "generation_after": gen + n}

    mgr = SessionManager(EngineCache(breaker_threshold=3,
                                     breaker_cooldown_s=600.0),
                         faults="step:1-3:raise", step_retries=2,
                         retry_backoff_s=0.001, batching=False)
    sid = mgr.create(dict(spec, seed=9))["id"]
    mgr.step(sid, n)
    s = mgr.get(sid)
    if not (s.degraded and s.engine is None and mgr.degraded_total == 1):
        fail("the breaker did not degrade the session")
    mgr.step(sid, n)
    if not np.array_equal(board(mgr, sid), oracle(9, 2 * n)):
        fail("the degraded session's board differs from the oracle's")
    out["breaker"] = {"trips": mgr.cache.breaker_stats()["trips"],
                      "degraded_total": mgr.degraded_total}
    mgr.shutdown()

    # a real failure of a card engine (here its fault hook raising before
    # any launch) opens the breaker and never moves the session to the CPU
    mgr = SessionManager(EngineCache(breaker_threshold=3,
                                     breaker_cooldown_s=600.0),
                         step_retries=2, retry_backoff_s=0.001,
                         batching=False)
    sid = mgr.create(dict(spec, seed=10))["id"]
    s = mgr.get(sid)

    def broken(site):
        raise RuntimeError(f"{site} dispatch failed")

    s.engine.fault_hook = broken
    try:
        mgr.step(sid, n)
        fail("a step of a failing card engine returned")
    except EngineUnavailableError:
        pass
    if (mgr.get(sid) is not s or s.degraded or s.engine is None
            or mgr.degraded_total or s.grid.device.type != "cuda"):
        fail("a real engine failure moved the card session to the CPU")
    try:
        mgr.create(dict(spec, seed=11))
        fail("a create on the failed card plan returned a session")
    except EngineUnavailableError:
        pass
    out["card_failure"] = {"engine_failures": mgr.engine_failures,
                           "degraded_total": mgr.degraded_total}
    mgr.shutdown()
    emit({"phase": "serve", "part": "faults", "card": card,
          "grid": [size, size], **out, "boards_equal_to_oracle": True})


def phase6_serve(card: str, times: dict) -> None:
    _serve_life(card, times)
    _serve_solo_threads(card)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        _serve_ltl(card, os.path.join(d, "state"))
    _serve_faults(card)


# -- phase 7: observability and the native backends ---------------------------

# (sessions, size, comm_every, generations a request, rounds a turn): the
# Life sessions of each manager (obs off, obs on), 32 boards of 4096² as
# in phase 6, beside one 4096² Bosco session on K3 and one on K2
OBS_LIFE = (32, 4096, 8, 8, 20)
OBS_LTL_SIZE = 4096
# run_profile's capture, the wait inside it before the traffic starts, and
# the traffic.  Inside the capture the profiler's first kernel comes first
# (phases 5 and 6 launch one too): the record of the first kernel launched
# in a capture can be missing from the trace, and the counted traffic must
# not hold it.  The counted launches also lie half a second from either
# edge of the capture, as the trace places a kernel up to milliseconds
# off the host call that launched it, before it or after
OBS_PROFILE_S, OBS_LEAD_S, OBS_TRAFFIC_S = 2.0, 0.5, 1.0
# (size, generations, cpp-par workers) of the native backends' runs
NATIVE = (2048, 20, 8)


def _obs_sessions(mgr) -> dict:
    """The sessions of phase 7 on ``mgr``: 32 of Life (K1), one of Bosco on
    K3 (comm_every 1) and one on K2 (comm_every 3)."""
    B, size, k, _, _ = OBS_LIFE
    life = [mgr.create({"rows": size, "cols": size, "rule": "life",
                        "comm_every": k, "segments": [1, k],
                        "seed": SEED + b})["id"] for b in range(B)]
    ltl = {kid: mgr.create({"rows": OBS_LTL_SIZE, "cols": OBS_LTL_SIZE,
                            "rule": "bosco", "comm_every": ce,
                            "seed": SEED})["id"]
           for kid, ce in (("K3", 1), ("K2", 3))}
    for kid, sid in [("K1", life[0]), *ltl.items()]:
        if mgr.get(sid).engine.kernel_id != kid:
            fail(f"a phase 7 session meant for {kid} took another engine")
    return {"life": life, **ltl}


def _obs_traffic(mgr, sids: dict, rounds: int) -> float:
    """``rounds`` coalesced Life rounds (the wall seconds, the requests/s
    measure), then one step of each Bosco session (K3 two generations, K2
    three)."""
    wall = _serve_rounds(mgr, sids["life"], rounds, OBS_LIFE[3])
    mgr.step(sids["K3"], 2)
    mgr.step(sids["K2"], 3)
    return wall


def _kernel_placement(events: list, kernels: list) -> dict:
    """Where a Chrome trace puts its kernels against the host calls that
    launched them (paired by ``correlation``), in µs from the trace's
    first event: the kernel's start less its launch's (least, median,
    most: negative means the device's clock, as converted, runs early),
    the first launch and the last kernel's end, and every launch call
    whose kernel the trace lacks."""
    t0 = min(e["ts"] for e in events if "ts" in e)
    start = {e["args"]["correlation"]: e["ts"] for e in kernels
             if "correlation" in e.get("args", {})}
    calls = [e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "LaunchKernel" in e.get("name", "")]
    offsets = sorted(start[c] - e["ts"] for e in calls
                     if (c := e.get("args", {}).get("correlation")) in start)
    return {"kernel_minus_launch_us": (
                [offsets[0], offsets[len(offsets) // 2], offsets[-1]]
                if offsets else None),
            "first_launch_us": min((e["ts"] - t0 for e in calls),
                                   default=None),
            "last_kernel_end_us": max((e["ts"] + e.get("dur", 0) - t0
                                       for e in kernels), default=None),
            "trace_span_us": max(e["ts"] for e in events if "ts" in e) - t0,
            "launches_without_kernel": [
                {"name": e["name"], "at_us": e["ts"] - t0}
                for e in calls if e.get("args", {}).get("correlation")
                not in start]}


def _obs_profile(mgr, sids: dict, logdir: str) -> dict:
    """One ``run_profile`` capture over about a second of Life traffic,
    started ``OBS_LEAD_S`` after the capture's first kernel: the K1
    launches counted inside the capture against the K1 kernel records of
    the Chrome trace it wrote (the trace rule), and where the trace placed
    its kernels."""
    n = OBS_LIFE[3]

    def attempt():
        out = {}
        t = threading.Thread(
            target=lambda: out.update(run_profile(logdir, OBS_PROFILE_S)))
        t.start()
        if not capturing.wait(60):
            fail("run_profile's capture did not start")
        # the profiler's first kernel
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(OBS_LEAD_S)
        _reset_launches()
        t0, rounds = time.perf_counter(), 0
        while time.perf_counter() - t0 < OBS_TRAFFIC_S:
            _serve_rounds(mgr, sids["life"], 1, n)
            rounds += 1
        torch.cuda.synchronize()
        counted = _launches()
        if not capturing.is_set():
            fail("the profiled traffic outlasted run_profile's capture")
        t.join(120)
        if t.is_alive() or not out.get("ok"):
            fail(f"run_profile failed: {out}")
        with open(out["path"]) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        in_trace = {kid: sum(1 for e in kernels
                             if any(nm in e.get("name", "") for nm in names))
                    for kid, names in KERNEL_NAMES.items()}
        if counted["K2"] or counted["K3"] or not counted["K1"]:
            fail(f"the profiled Life traffic launched {counted}")
        placement = _kernel_placement(events, kernels)
        if placement["launches_without_kernel"]:
            print(f"chip_smoke: run_profile's launches without a kernel "
                  f"record: {placement}", file=sys.stderr, flush=True)
        return ({"K1": counted["K1"]}, {"K1": in_trace["K1"]},
                {"rounds": rounds, "k1_launches": counted["K1"],
                 "trace_kernels": in_trace, "trace_events": len(events),
                 "trace_bytes": os.path.getsize(out["path"]),
                 "capture_s": out["seconds"], "lead_s": OBS_LEAD_S,
                 "kernel_placement": placement})

    result, takes, lost = _trace_holds_launches("run_profile", attempt)
    return {**result, "takes": takes, "records_lost_on_retaken": lost}


def _check_cards(engines: dict) -> dict:
    """Every engine holds a card for each (depth, B) it warmed, from its
    kernel's count; K1's, K3's and K2's equal their counts times the work."""
    B, size, k, _, _ = OBS_LIFE
    out = {}
    for kid, eng in engines.items():
        cards = {(c.depth, c.batch): c for c in eng.cost_cards()}
        warmed = {(n, 0) for n in eng._compiled} | set(eng._compiled_batched)
        if not cards or set(cards) != warmed:
            fail(f"{kid}'s cost cards {sorted(cards)} are not its warmed "
                 f"steps {sorted(warmed)}")
        if any(c.source != "kernel_count" or c.flops <= 0
               or c.bytes_accessed <= 0 for c in cards.values()):
            fail(f"{kid} has a cost card without its kernel's counts")
        out[kid] = [c.as_dict() for c in cards.values()]
    words = size * size // WORD
    batched = max(c.batch for c in engines["K1"].cost_cards())
    want = {"K1": [((k, 0), word_ops(LIFE) * words * k),
                   ((k, batched), word_ops(LIFE) * words * k * batched)],
            "K3": [((1, 0), ltl_word_ops(BOSCO) * OBS_LTL_SIZE ** 2 // WORD)],
            "K2": [((3, 0), dense_cell_ops(5) * OBS_LTL_SIZE ** 2 * 3)]}
    for kid, keys in want.items():
        for key, ops in keys:
            card = engines[kid].cost_card(*key)
            if card is None or card.flops != ops:
                fail(f"{kid}'s {key} card counts {card and card.flops} "
                     f"instructions, its kernel's count gives {ops}")
    return out


def phase7_obs(card: str) -> None:
    """Observability on the card, then the native backends on its host."""
    B, size, k, n, rounds = OBS_LIFE
    off = SessionManager(EngineCache(), batch_max=B)
    obs = Obs()
    on = SessionManager(EngineCache(), batch_max=B, obs=obs)
    obs.arm_telemetry(manager=on, start=False)
    obs.arm_flight(manager=on, anomaly=True)
    sids = {"off": _obs_sessions(off), "on": _obs_sessions(on)}
    if sids["off"] != sids["on"]:
        fail("the obs-on and obs-off managers' session ids differ")
    sids = sids["on"]
    for mgr in (off, on):
        _obs_traffic(mgr, sids, 1)      # warms the (n, B) batched step
    builds = _build.builds
    # turns: off, on, on, off; the obs-on run is this phase's own path,
    # its counts set to 0 just before and read just after
    walls = {"off": [], "on": []}
    for label in ("off", "on", "on", "off"):
        mgr = on if label == "on" else off
        _reset_launches()
        walls[label].append(_obs_traffic(mgr, sids, rounds))
        launches = _launches()
        if not all(launches.values()):
            fail(f"the obs-{label} traffic launched {launches}")
        if label == "on":
            on_launches = launches
    if _build.builds != builds:
        fail("a kernel was built while phase 7 served")
    for label, mgr in (("off", off), ("on", on)):
        _no_faults(mgr, f"obs-{label}")
    requests = B * rounds
    rps = {label: [requests / w for w in ws] for label, ws in walls.items()}
    emit({"phase": "obs", "part": "requests_per_s", "card": card,
          "sessions": B, "grid": [size, size], "comm_every": k,
          "generations_a_request": n, "rounds_a_turn": rounds,
          "turns": ["off", "on", "on", "off"],
          "requests_per_s": rps,
          "on_over_off": (sum(rps["on"]) / len(rps["on"]))
          / (sum(rps["off"]) / len(rps["off"])),
          "launches_obs_on": on_launches})
    # the same requests on both managers: the boards, bit for bit
    every = sids["life"] + [sids["K3"], sids["K2"]]
    for sid in every:
        a, b = off.get(sid), on.get(sid)
        if a.generation != b.generation or not torch.equal(a.grid, b.grid):
            fail(f"session {sid} with obs on differs from obs off")
    engines = {kid: on.get(sid).engine for kid, sid in
               (("K1", sids["life"][0]), ("K3", sids["K3"]),
                ("K2", sids["K2"]))}
    cards = _check_cards(engines)
    roof = roof_ops_per_s()
    props = torch.cuda.get_device_properties(0)
    if roof is None or roof != device_roof_ops_per_s():
        fail(f"no roof from the card's properties: {roof}")
    usage = on.usage()
    rooflines = {row["signature"]: row.get("roofline")
                 for row in usage["signatures"]}
    life_row = rooflines.get(engines["K1"].sig_label)
    if life_row is None:
        fail("the usage readout has no roofline for the Life signature")
    emit({"phase": "obs", "part": "cost_cards", "card": card,
          "roof_ops_per_s": roof, "sm_count": props.multi_processor_count,
          "int32_lanes_per_sm": 64,
          "clock_hz": roof / (props.multi_processor_count * 64),
          "cards": cards, "rooflines": rooflines,
          "usage_totals": usage["totals"]})
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        prof = _obs_profile(on, sids, d)
    obs.telemetry.sample_once()         # the devmem sample and the anomaly
    mem = read_device_memory()
    if not mem.get(("cuda:0", "in_use")) or not obs.devmem.memory_total():
        fail(f"read_device_memory reports no memory in use: {mem}")
    stats = on.stats()["obs"]
    if stats["flight"]["recorded"] <= 0 or on.slo()["evals"] < 1:
        fail(f"the flight recorder or SLO engine saw nothing: {stats}")
    emit({"phase": "obs", "part": "profile_devmem", "card": card, **prof,
          "device_memory": {f"{dev}/{kind}": v
                            for (dev, kind), v in sorted(mem.items())},
          "obs_stats": stats, "health_slo": on.health().get("slo")})
    # a cpp-par session of the same spec as a cuda one: equal boards
    nsize, ngens, workers = NATIVE
    spec = {"rows": nsize, "cols": nsize, "seed": SEED}
    pair = {b: on.create(dict(spec, backend=b))["id"]
            for b in ("cuda", "cpp-par")}
    for sid in pair.values():
        on.step(sid, ngens)
    if not np.array_equal(on.snapshot_array(pair["cuda"])[0],
                          on.snapshot_array(pair["cpp-par"])[0]):
        fail("a cpp-par session differs from the cuda session of its spec")
    if on.get(pair["cpp-par"]).engine is not None:
        fail("the cpp-par session holds an engine")
    off.shutdown()
    on.shutdown()
    obs.close()
    torch.cuda.empty_cache()
    _native_cli(card)


def _native_cli(card: str) -> None:
    """The CLI's native backends on the card's host against ``--backend
    cuda``: equal boards read back with ``golio``, equal master headers but
    for ``cpp-par``'s tile count."""
    size, gens, workers = NATIVE
    runs = (("cuda", []), ("cpp", []),
            ("cpp-par", ["--workers", str(workers)]))
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        for b, extra in runs:
            name = b.replace("-", "_")
            t0 = time.perf_counter()
            rc = cli_main([str(size), str(size), str(gens), str(gens),
                           "--backend", b, *extra, "--save", "--name", name,
                           "--seed", str(SEED), "--out-dir", d, "--quiet"])
            if rc != 0:
                fail(f"the CLI with --backend {b} exited {rc}")
            out[b] = {"wall_s": time.perf_counter() - t0,
                      "header": golio.read_master(golio.master_path(d, name)),
                      "grids": [golio.load_snapshot(d, name, it)
                                for it in (0, gens)]}
        tiles = plan_tiles((size, size), workers, 1)
        for b in ("cpp", "cpp-par"):
            if not all(np.array_equal(x, y) for x, y in
                       zip(out[b]["grids"], out["cuda"]["grids"])):
                fail(f"--backend {b} wrote another board than --backend cuda")
        head = out["cuda"]["header"]
        if out["cpp"]["header"] != head:
            fail(f"the cpp and cuda headers differ: {out['cpp']['header']} "
                 f"{head}")
        par = out["cpp-par"]["header"]
        if (par[4] != tiles[0] * tiles[1] or par[4] == head[4]
                or par[:4] != head[:4]):
            fail(f"the cpp-par header {par} is not the cuda header with "
                 f"{tiles} tiles")
    emit({"phase": "obs", "part": "native_cli", "card": card,
          "grid": [size, size], "generations": gens, "workers": workers,
          "tiles": list(tiles),
          "headers": {b: list(r["header"]) for b, r in out.items()},
          "wall_s": {b: r["wall_s"] for b, r in out.items()},
          "boards_equal": True})


def main() -> int:
    card = phase0_card()
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    phase1_build()
    lap("build")
    errs = phase2_exact()
    lap("kernel_vs_plain")
    launches = phase3_main_paths()
    lap("main_paths")
    times = phase4_times(card)
    lap("times")
    phase5_traces(card)
    lap("traces")
    phase6_serve(card, times)
    lap("serve")
    phase7_obs(card)
    lap("obs_native")
    emit({"phase": "seconds", **seconds})
    k1 = times["K1", MAIN_GENS]
    k2 = times["K2", DENSE_PATH[2]]
    k3 = times["K3", LTL_PATHS[0][0], LTL_PATHS[0][2]]
    print(card, flush=True)
    emit({"kernels": [
        {"name": "K1 bit_step", "route": "cuda",
         "source": "mpi_tpu_torch/csrc/bitlife.cu",
         "replaces": "mpi_tpu/ops/pallas_bitlife.py:351",
         "launches": launches["K1"], "max_abs_err": errs["K1"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None},
        {"name": "K2 dense_step", "route": "cuda",
         "source": "mpi_tpu_torch/csrc/stencil.cu",
         "replaces": "mpi_tpu/ops/pallas_stencil.py:285",
         "launches": launches["K2"], "max_abs_err": errs["K2"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"]},
        {"name": "K3 ltl_step", "route": "cuda",
         "source": "mpi_tpu_torch/csrc/bitltl.cu",
         "replaces": "mpi_tpu/ops/pallas_bitltl.py:264",
         "launches": launches["K3"][LTL_PATHS[0][0]],
         "max_abs_err": errs["K3"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
