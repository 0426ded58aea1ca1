"""CUDA backend: hash init → K-generation kernel passes → snapshot hooks,
on one device, or on a device mesh (``build_mesh_engine``,
``backends/cuda_mesh.py``).

The single-device paths of ``mpi_tpu.backends.tpu``: ``plan_pad_width``
and ``select_engine`` pick the width and the kernel, ``build_engine``
checks the plan and prints its notes, ``Engine`` holds the stepper,
``run_cuda`` is the one-shot run the CLI calls.  Three engines:

* ``"bit"``: radius 1, packed int32 words, kernel K1
  (``ops/cuda_bitlife.py``);
* ``"ltl"``: radius 2..7 with comm_every <= ⌊8/r⌋, packed words on bit
  planes, kernel K3 (``ops/cuda_bitltl.py``);
* ``"dense"``: any other rule and depth, and the widths the pad plan
  leaves alone, uint8 cells, kernel K2 (``ops/cuda_stencil.py``).  Where
  comm_every x r exceeds K2's 16-cell halo it runs passes of ⌊16/r⌋
  generations (``pass_depth``): on one device every comm_every gives the
  same grid.

A width that is not a whole number of 32-cell words rides the packed
engines at the padded width (``plan_pad_width``, the reference's
pad-to-32 plan): the kernels zero the pad after every generation
(``col_limit``), init writes only the real columns, and every fetch crops
to them.  A periodic padded grid wraps through the pad, so the seam
columns are recomputed on a thin dense band and stitched over each pass's
output (``parallel/seam.py``); where the band cannot serve, the run stays
on K2 with the reference's note.

Batches: ``Engine.step_batched`` steps a stacked (B, ...) batch of boards
of one configuration with one kernel launch per pass for the whole batch
(the kernels' board axis), padded and seam engines included.

Serving (``mpi_tpu_torch/serve``): many sessions share one engine, so the
engine carries the reference's serve surfaces: ``ensure_compiled`` and
``ensure_compiled_batched`` (warm a step's pass depths once, counted in
``compile_count``), ``block_until_ready`` (the wait for the launches that
produce a grid), ``fetch_window`` and ``write_window`` (one region, on the
device), ``shard_snapshots`` (one tile) and ``fault_hook``.

Sparse stepping (``sparse_tile``): the engine steps a
``ops/activity.py:SparseState`` (the grid and its tile map), gathering
the active tiles into a stripe stepped by the engine's own kernel at a
dead boundary, and falling back to the engine's dense pass when the board
is busy.  The host decides each phase from the active count, one read per
gather and per probe, and ``step_batched`` steps each board's phases in
turn.  A radius > 1 rule at a width that is not whole words takes K2 at
the real width there, as the reference does off the TPU: the packed
engines would pad it, and no sparse engine runs on a padded width.

Kernel build and warm-up count as setup, as compilation does in the
reference; the segment loop is the timed steady state.

Entry points run on the GPU unless the caller passes ``device="cpu"``,
which runs the plain PyTorch version of the kernel; without CUDA and
without that request they raise.
"""

from __future__ import annotations

import functools
import sys
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from mpi_tpu_torch.config import WORD, ConfigError, GolConfig, plan_segments
from mpi_tpu_torch.interop import dense_from_numpy
from mpi_tpu_torch.ops import (
    activity, bitlife, cuda_bitlife, cuda_bitltl, cuda_stencil,
)
from mpi_tpu_torch.ops.activity import SparseState
from mpi_tpu_torch.parallel import seam
from mpi_tpu_torch.utils.hashinit import init_dense
from mpi_tpu_torch.utils.segmenting import segment_depths, segmented_evolve
from mpi_tpu_torch.utils.timing import PhaseTimer

# snapshot_cb(iteration, [(pid, tile, first_row, first_col), ...])
SnapshotCb = Callable[[int, List[Tuple[int, np.ndarray, int, int]]], None]

# words per host transfer in fetch(): bounds the unpacked block on the device
_FETCH_WORDS = 1 << 22

# engine -> (kernel id, its wrapper, its refusal)
KERNELS = {
    "bit": ("K1", cuda_bitlife.cuda_bit_step, cuda_bitlife.refusal),
    "ltl": ("K3", cuda_bitltl.cuda_ltl_step, cuda_bitltl.refusal),
    "dense": ("K2", cuda_stencil.cuda_dense_step, cuda_stencil.refusal),
}


# engine -> the macros of its kernel's build with a given CTA tile
BLOCK_DEFINES = {"bit": cuda_bitlife.block_defines,
                 "ltl": cuda_bitltl.block_defines,
                 "dense": cuda_stencil.block_defines}


def check_blocks(config: GolConfig, kind: str, device: torch.device,
                 blocks) -> None:
    """Raise :class:`ConfigError` unless the CTA tile ``blocks`` ([rows,
    words a lane] for K1, [rows] for K3, [rows, cols] for K2) can run
    ``config`` on engine ``kind``: a tile is never quietly ignored, so the
    host backends and the CPU (whose plain versions have no tile) refuse
    one.  K2's is screened at the deepest pass the engine launches
    (``deepest_pass``)."""
    if config.backend != "cuda":
        raise ConfigError(f"blocks {list(blocks)}: backend "
                          f"{config.backend!r} runs no kernel of the card")
    if device.type != "cuda":
        raise ConfigError(f"blocks {list(blocks)}: a CTA tile needs the "
                          f"card; the plain versions on the CPU have none")
    vals = [int(v) for v in blocks]
    if kind == "bit":
        ok = len(vals) == 2 and cuda_bitlife.blocks_ok(
            vals[0], vals[1], config.rows)
        want = (f"[rows, words a lane], rows in "
                f"{cuda_bitlife.BLOCK_ROWS}, words in "
                f"{cuda_bitlife.BLOCK_WPL}, within "
                f"{cuda_bitlife.SMEM_OPTIN_BYTES} bytes of shared memory")
    elif kind == "ltl":
        ok = len(vals) == 1 and cuda_bitltl.blocks_ok(
            vals[0], config.rule.radius, config.rows)
        want = (f"[rows], rows in {cuda_bitltl.BLOCK_ROWS}, within the "
                f"kernel's shared memory")
    else:
        depth = deepest_pass(config, kind)
        ok = len(vals) == 2 and cuda_stencil.blocks_ok(
            vals[0], vals[1], config.rule.radius, depth, config.rows)
        want = (f"[rows, cols], rows in {cuda_stencil.BLOCK_ROWS}, cols in "
                f"{cuda_stencil.BLOCK_COLS}, within "
                f"{cuda_stencil.SMEM_OPTIN_BYTES} bytes of shared memory "
                f"at passes of {depth} generations of radius "
                f"{config.rule.radius}")
    if not ok:
        raise ConfigError(f"blocks {vals}: kernel {KERNELS[kind][0]} takes "
                          f"{want}")


def _tile_note(kernel_id: str, blocks, seam_band: bool) -> str:
    """The note ``build_engine`` prints for a CTA tile."""
    note = f"kernel {kernel_id} built with CTA tile {[int(v) for v in blocks]}"
    if seam_band:
        note += (" (the seam band keeps K2's default build: the tile is "
                 "the engine's kernel's)")
    return note


def plan_pad_width(config: GolConfig, mj: int = 1) -> Tuple[int, int]:
    """(cols_padded, pad_bits): the reference's pad-to-32 plan
    (``mpi_tpu.backends.tpu.plan_pad_width``) over ``mj`` shard columns.
    A shard width that is not a whole number of words is padded with
    trailing dead columns to the next word per shard, so the run takes the
    packed kernels; a periodic width pads only where the seam band serves
    it (``seam_serves(cols, comm_every x r)``), else it keeps its width and
    K2.  The reference's stretch of the padded width to 4096 cells at
    comm_every 1 is a TPU lane contract that the port's kernels do not
    have, so it is left out (as the reference leaves it off the TPU)."""
    shard = config.cols // mj
    if shard % WORD == 0:
        return config.cols, 0
    if config.boundary == "periodic" and not seam.seam_serves(
            config.cols, config.comm_every * config.rule.radius):
        return config.cols, 0
    padded = -(-shard // WORD) * WORD * mj
    return padded, padded - config.cols


def mesh_dims(config: GolConfig) -> Tuple[int, int]:
    """The (mi, mj) mesh ``config`` asks for: (1, 1) without one."""
    return tuple(config.mesh_shape) if config.mesh_shape else (1, 1)


def plan_mesh_engine(config: GolConfig, mi: int, mj: int):
    """(engine, cols_eff, pad_bits, notes) on a mesh of more than one
    shard: the reference's choice (``mpi_tpu.backends.tpu.build_engine``
    with ``select_ltl_mode``'s mesh branches): the pad plan over ``mj``
    shard columns, then the SWAR stepper (K1) for radius 1 on whole words a
    shard, the bit-sliced stepper (K3) for radius >= 2 on whole words a
    shard when comm_every x r <= 31, else the dense stepper (K2) at the
    real width, with the reference's notes."""
    r = config.rule.radius
    cols_eff, pad_bits = plan_pad_width(config, mj)
    aligned = (cols_eff // mj) % WORD == 0
    if r == 1 and aligned:
        return "bit", cols_eff, pad_bits, ()
    if r == 1:
        # a periodic width the seam band cannot serve
        return "dense", config.cols, 0, (
            f"non-word-aligned periodic width {config.cols}/{mj} cols per "
            f"shard: dense engine (seam stitching needs comm_every*radius "
            f"<= 31 and width >= {4 * config.comm_every * r})",)
    if not aligned:
        note = (f"radius-{r} rule on non-word-aligned shard width "
                f"({config.cols}/{mj} cols per shard), {config.boundary}: "
                f"dense engine")
        if config.boundary == "periodic":
            note += (f" (seam stitching needs comm_every*radius <= 31 and "
                     f"width >= {4 * config.comm_every * r})")
        return "dense", config.cols, 0, (note,)
    if config.comm_every * r > 31:
        return "dense", config.cols, 0, (
            f"comm_every {config.comm_every} x radius {r} > 31 exceeds the "
            f"one-ghost-word halo: dense engine (~3.6x slower at r=5; use "
            f"comm_every <= {31 // r} to keep the bit-sliced engine)",)
    return "ltl", cols_eff, pad_bits, ()


def plan_engine(config: GolConfig) -> Tuple[str, int, int, Tuple[str, ...]]:
    """(engine, cols_eff, pad_bits, notes): the reference's single-device
    choice (``mpi_tpu.backends.tpu.build_engine``: the pad plan, then K1
    for radius 1 on a width of whole words, the fused bit-sliced kernel for
    radius >= 2 when comm_every <= ⌊8/r⌋, else the dense kernel), without
    the TPU's lane and VMEM conditions, which the port's kernels do not
    have.  Where the reference would take a 1x1-mesh stepper, the port
    takes K2 at the real width.  The notes say why a non-word-aligned
    width stays on K2, in the reference's words.  With ``sparse_tile``
    set, a radius > 1 rule at a width that is not whole words stays on K2
    at the real width, as the reference's engine does off the TPU, with a
    note: padded, it could not run sparse."""
    r = config.rule.radius
    if config.sparse_tile and r > 1 and config.cols % WORD:
        return "dense", config.cols, 0, (
            f"sparse_tile {config.sparse_tile} on a radius-{r} rule at a "
            f"width of {config.cols} cells, not whole words: dense engine "
            f"at the real width (the packed engines would pad it, and "
            f"sparse stepping does not run on a padded width)",)
    cols_eff, pad_bits = plan_pad_width(config)
    if cols_eff % WORD == 0:
        if r == 1:
            return "bit", cols_eff, pad_bits, ()
        if config.comm_every <= cuda_bitltl.max_gens(r):
            return "ltl", cols_eff, pad_bits, ()
        return "dense", config.cols, 0, ()
    # the pad plan declined: a periodic width the seam band cannot serve
    seam_note = (f"seam stitching needs comm_every*radius <= 31 and width "
                 f">= {4 * config.comm_every * r}")
    if r == 1:
        note = (f"non-word-aligned periodic width {config.cols}/1 cols per "
                f"shard: dense engine ({seam_note})")
    else:
        note = (f"radius-{r} rule on non-word-aligned shard width "
                f"({config.cols}/1 cols per shard), {config.boundary}: "
                f"dense engine ({seam_note})")
    return "dense", config.cols, 0, (note,)


def select_engine(config: GolConfig) -> str:
    """``"bit"``, ``"ltl"`` or ``"dense"``: the engine ``plan_engine`` picks
    (``plan_mesh_engine`` on a mesh of more than one shard)."""
    mi, mj = mesh_dims(config)
    if mi * mj > 1:
        return plan_mesh_engine(config, mi, mj)[0]
    return plan_engine(config)[0]


def pass_depth(config: GolConfig, kind: Optional[str] = None) -> int:
    """Generations per kernel pass on engine ``kind`` (the planned one when
    None): ``comm_every``, except on K2 where comm_every x r exceeds its
    halo (``cuda_stencil.MAX_DEPTH``): there ⌊16/r⌋, the deepest pass K2
    serves, which needs the fewest launches.  On one device every
    comm_every gives the same grid.  On a mesh a pass is one exchange:
    comm_every generations, which K2 runs in chunks of ⌊16/r⌋."""
    kind = kind or select_engine(config)
    mi, mj = mesh_dims(config)
    if kind == "dense" and mi * mj == 1:
        return min(config.comm_every,
                   cuda_stencil.MAX_DEPTH // config.rule.radius)
    return config.comm_every


def deepest_pass(config: GolConfig, kind: str) -> int:
    """Generations of the deepest pass engine ``kind`` launches for
    ``config``: ``pass_depth``, or a sparse engine's dense chunks where
    they are deeper (what a K2 tile's shared memory is screened at)."""
    depth = pass_depth(config, kind)
    if config.sparse_tile:
        depth = max(depth, sparse_dense_depth(kind, config.rule))
    return depth


def sparse_dense_depth(kind: str, rule) -> int:
    """Generations per pass of a sparse engine's unprobed dense chunks: the
    deepest of 8, 4, 2 and 1 that the engine's kernel serves for ``rule``
    (1 for a birth-on-0 rule).  Every chunk of ``activity.DENSE_CHUNKS``
    but the last is a multiple of it."""
    if 0 in rule.birth:
        return 1
    top = {"bit": cuda_bitlife.MAX_GENS,
           "ltl": cuda_bitltl.max_gens(rule.radius),
           "dense": cuda_stencil.MAX_DEPTH // rule.radius}[kind]
    return max(d for d in (8, 4, 2, 1) if d <= top)


def plan_sparse(config: GolConfig, kind: str, cols_eff: int,
                pad_bits: int) -> activity.TilePlan:
    """The tile plan of a sparse run, with the reference's refusals
    (``mpi_tpu.backends.tpu.build_engine``): on the packed engines the
    tile is a whole number of words, and no sparse run takes a padded
    width."""
    T = config.sparse_tile
    packed = kind != "dense"
    if packed and T % WORD != 0:
        raise ConfigError(
            f"sparse_tile {T} must be a multiple of {WORD} on the "
            f"packed engines (tiles are expressed in words); use a "
            f"multiple of {WORD} or a rule/width that takes the "
            f"dense engine")
    if pad_bits:
        raise ConfigError(
            f"sparse_tile on a pad-to-32 width ({config.cols} cols) "
            f"is unsupported; use a word-aligned width")
    return activity.make_plan(
        rows=config.rows, cols_units=cols_eff // WORD if packed else cols_eff,
        tile_px=T, radius=config.rule.radius,
        periodic=config.boundary == "periodic", packed=packed)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, the GPU when None; raises when CUDA is
    asked for and absent (there is no quiet fallback to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: mpi_tpu_torch runs on the GPU unless "
                "asked for the CPU (device='cpu', or --device cpu on the "
                "command line)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


class ServeSurface:
    """What the serve layer calls on an engine besides stepping, shared by
    :class:`Engine` and the mesh engine (``backends/cuda_mesh.py``), as
    the reference's one ``Engine`` carries it on every mesh: the warm-up
    of each step depth and batch width once (``compile_count``), the cost
    cards obs reads, chained depth-1 steps and the pinned batched
    stepper.  A subclass gives ``_warm_step(n, boards)`` (warm the
    launches a step of ``n`` generations makes, for a batch of ``boards``
    when > 0) and ``_batch_width(grids)`` (B of a stacked batch, None for
    one grid), and calls :meth:`_init_serving` in its ``__init__``."""

    def _init_serving(self) -> None:
        # the step depths and (depth, B) widths warmed, under one lock; the
        # hook a fault injector installs, called before a step takes a
        # buffer or launches; obs (mpi_tpu_torch.obs.Obs, set by the serve
        # layer): the first warm-up of each (depth, B) records its wall and
        # a cost card from the kernel's own counts (obs/cost.py); the
        # tune-cache plan build_engine applied (tune/), or None
        self._compile_lock = threading.Lock()
        self._compiled = set()
        self._compiled_batched = set()
        self.compile_count = 0
        self.batched_compile_count = 0
        self.compile_wall_s = 0.0
        self.step_calls = 0
        self.batched_step_calls = 0
        self.fault_hook = None
        self.sig_label = None
        self.obs = None
        self._cost_cards = {}
        self.tuned_plan = None

    def init_grids(self, seeds=None, initials=None):
        """A fresh stacked batch: one board per entry of ``seeds`` (hash
        init) or ``initials`` (uint8 grids)."""
        if initials is not None:
            boards = [self.init_grid(initial=i) for i in initials]
        else:
            boards = [self.init_grid(seed=s) for s in seeds]
        return self.stack_grids(boards)

    def ensure_compiled(self, grid, n: int) -> None:
        """Warm every launch that a step of ``n`` generations makes, once
        per ``n``: the first call for a new rule is where its kernel
        library is built.  Each first call counts in ``compile_count`` and
        its time in ``compile_wall_s`` (the serve layer charges it to
        setup); ``grid`` is the grid that will step, and is not read."""
        self._ensure(self._compiled, n, n, 0)

    def ensure_compiled_batched(self, grids, n: int) -> None:
        """:meth:`ensure_compiled` for a stacked batch, once per ``(n,
        B)``, counted in ``batched_compile_count`` too."""
        B = self._batch_width(grids)
        self._ensure(self._compiled_batched, (n, B), n, B)

    def _ensure(self, warmed: set, key, n: int, boards: int) -> None:
        if n <= 0 or key in warmed:
            return
        with self._compile_lock:
            if key in warmed:
                return
            t0 = time.perf_counter()
            self._warm_step(n, boards)
            self.sync()
            dt = time.perf_counter() - t0
            warmed.add(key)
            self.compile_count += 1
            self.batched_compile_count += bool(boards)
            self.compile_wall_s += dt
            if self.obs is not None:
                self.obs.compile_wall.observe(dt)
                if boards:
                    self.obs.event("compile", dt, t0, depth=n, B=boards)
                else:
                    self.obs.event("compile", dt, t0, depth=n)
                self._capture_cost_card(n, boards)

    def _capture_cost_card(self, depth: int, batch: int) -> None:
        """The (depth, B) cost card from the kernel's counts
        (``obs/cost.py``); the caller holds ``_compile_lock`` and checked
        ``self.obs``.  A card that cannot be built is dropped: metering
        never fails a step."""
        try:
            from mpi_tpu_torch.obs.cost import capture_card

            self._cost_cards[(depth, batch)] = capture_card(
                self, depth=depth, batch=batch)
        except Exception:  # noqa: BLE001 — metering must never break serving
            pass

    def cost_card(self, depth: int, batch: int = 0):
        """The captured card for the (depth, B) step, or None (no obs, or
        that step was not warmed with obs on)."""
        return self._cost_cards.get((depth, batch))

    def cost_cards(self) -> list:
        """Snapshot of every captured card."""
        with self._compile_lock:
            return list(self._cost_cards.values())

    def compile_segments(self, grid, segments) -> None:
        """:meth:`ensure_compiled` for every distinct segment length."""
        for n in sorted(set(segments)):
            self.ensure_compiled(grid, n)

    def step_units(self, grid, n: int):
        """``n`` chained depth-1 steps with no sync between them (the one
        depth every serve session warms); consumes ``grid``."""
        for _ in range(max(0, int(n))):
            grid = self.step(grid, 1)
        return grid

    def step_batched_units(self, grids, n: int):
        """Batched :meth:`step_units`: ``n`` chained depth-1 batched steps
        with no sync between them; consumes ``grids``."""
        for _ in range(max(0, int(n))):
            grids = self.step_batched(grids, 1)
        return grids

    def batched_stepper(self, B: int):
        """A ``step(grids, n)`` callable pinned to batch width ``B``; it
        raises on a batch of another width."""
        def step(grids, n):
            got = self._batch_width(grids)
            if got != B:
                raise ValueError(f"batched stepper built for B={B}, got {got}")
            return self.step_batched(grids, n)

        step.B = B
        step.engine = self
        return step


class Engine(ServeSurface):
    """The kernel stepper for one configuration on one device: packed
    int32 words (``bitpacked``, engines "bit" and "ltl") or uint8 cells
    (engine "dense").

    Grid state lives outside the engine: every method takes and returns
    it.  A grid is (rows, cols_eff / 32) words or (rows, cols) cells, a
    batch of boards the same with a leading board axis.  ``step`` and
    ``step_batched`` consume their input, as the reference's donated
    buffers do: the engine keeps the input as the spare buffer of its
    ping-pong pair, and the next step of that shape writes into it.
    Callers must replace their reference with the returned grid and never
    read the old one.  Each pass runs ``depth`` generations (``pass_depth``)
    and a shorter remainder.

    A padded engine (``pad_bits`` > 0) holds ``cols_eff`` columns of which
    the first ``config.cols`` are real (``col_limit``); the pad is always
    zero, so ``population`` is exact, and ``fetch`` and ``tiles`` crop to
    the real width.

    A sparse engine (``sparse_plan`` set) passes an
    ``ops/activity.py:SparseState`` where the others pass a grid: the grid
    and its [nti, ntj] tile map, both stacked on a board axis in a batch.
    ``raw_grid`` unwraps it; ``sparse_stats`` reads its active set.  Its
    ``step_batched`` steps the boards one after another, each with its own
    phases, so its launches are per board, not one a pass.

    ``notes`` are the planning notes ``build_engine`` printed.

    Sessions of the serve layer share one engine and step it from several
    threads.  Their grids never share a buffer: a buffer is the engine's
    spare only between the step that consumed it and the step that takes
    it (``dict.pop`` hands it to one caller), and every launch goes to the
    device's current stream in the order the steps made them, so a step
    that writes into a spare runs after the step that last read it."""

    def __init__(self, config: GolConfig, device: torch.device, kind: str,
                 depths=(1,), cols_eff: Optional[int] = None,
                 pad_bits: int = 0, notes=(), depth: Optional[int] = None,
                 sparse_plan: Optional[activity.TilePlan] = None,
                 blocks=None):
        self.config = config
        self.device = device
        self.kind = kind
        self.depths = sorted(set(depths)) or [1]
        self.depth = config.comm_every if depth is None else depth
        self.bitpacked = kind != "dense"
        self.kernel_id, self._kernel, _ = KERNELS[kind]
        # a CTA tile other than the default build's: every launch of the
        # engine goes to that build of its kernel
        self.blocks = None if blocks is None else [int(v) for v in blocks]
        if self.blocks is not None:
            self._kernel = functools.partial(
                self._kernel, defines=BLOCK_DEFINES[kind](self.blocks))
        self.cols_eff = config.cols if cols_eff is None else cols_eff
        self.pad_bits = pad_bits
        self.col_limit = config.cols if pad_bits else None
        self.notes = tuple(notes)
        self.sparse_plan = sparse_plan
        # the seam band repairs a periodic padded grid's wrap columns
        self.seam = pad_bits > 0 and config.boundary == "periodic"
        if self.seam:
            self._evolve = seam.make_seam_stepper(
                self._pass, config.rule, config.cols, config.comm_every,
                obs=self._obs)
        elif sparse_plan is not None:
            self._evolve = self._sparse_evolve(sparse_plan)
        else:
            self._evolve = segmented_evolve(self._pass, self.depth,
                                            obs=self._obs)
        # the spare buffer of the ping-pong pair, one for a solo grid (rank 2)
        # and one for a batch (rank 3), replaced when the shape changes; beside
        # each, the stream that last launched on it (both under one lock)
        self._spares = {}
        self._spare_streams = {}
        self._spare_lock = threading.Lock()
        self._init_serving()
        self.mi = self.mj = 1
        # every step consumes its input (the spare of the ping-pong pair),
        # the reference's donated buffer; flight records report it
        self.donates_input = True

    def _obs(self):
        """The obs handle the steppers' spans read at each pass: the serve
        layer sets ``obs`` after the engine is built."""
        return self.obs

    def _pass(self, src, k, dst):
        if self.bitpacked:
            return self._kernel(src, self.config.rule, self.config.boundary,
                                gens=k, out=dst, col_limit=self.col_limit)
        return self._kernel(src, self.config.rule, self.config.boundary,
                            gens=k, out=dst)

    def _stripe_step(self, stripe, out):
        """One generation of a sparse stripe: the engine's kernel at a dead
        boundary (the stripe's halo holds the tiles' neighbours)."""
        return self._kernel(stripe, self.config.rule, "dead", gens=1, out=out)

    def _sparse_evolve(self, plan: activity.TilePlan):
        return activity.make_sparse_evolve(
            self._pass, self._stripe_step, plan,
            sparse_dense_depth(self.kind, self.config.rule))

    def _shape(self) -> Tuple[int, int]:
        cols = self.cols_eff // WORD if self.bitpacked else self.config.cols
        return self.config.rows, cols

    def raw_grid(self, grid):
        """The grid tensor behind a step state: unwraps a sparse engine's
        ``SparseState``, identity on the others."""
        return grid.grid if self.sparse_plan is not None else grid

    def sparse_stats(self, grid) -> Optional[dict]:
        """The active set a sparse engine's state implies for its next step
        (``activity.activity_stats``: one small reduction, one host read);
        None on a dense engine."""
        if self.sparse_plan is None:
            return None
        return activity.activity_stats(grid, self.sparse_plan)

    def init_grid(self, initial=None, seed=None):
        """A fresh grid on the device: the hash init of ``seed`` (default
        config.seed), or the uint8 0/1 ``initial`` grid, or the grid a
        region loader ``initial(r0, r1, c0, c1)`` gives for the whole board
        (the restore path's); a padded grid's pad starts dead.  A sparse
        engine wraps it in a ``SparseState`` with every tile marked
        changed."""
        if callable(initial):
            initial = initial(0, self.config.rows, 0, self.config.cols)
        grid = self._init_raw(initial, seed)
        if self.sparse_plan is not None:
            return activity.initial_state(grid, self.sparse_plan)
        return grid

    def _init_raw(self, initial, seed) -> torch.Tensor:
        rows, cols = self.config.rows, self.config.cols
        if initial is not None:
            initial = np.asarray(initial, dtype=np.uint8)
            if initial.shape != (rows, cols):
                raise ConfigError(
                    f"initial grid is {initial.shape}, config asks for "
                    f"{(rows, cols)}")
            if not self.bitpacked:
                return dense_from_numpy(initial, self.device)
            if self.pad_bits:
                initial = np.pad(initial, ((0, 0), (0, self.pad_bits)))
            words = bitlife.pack_np(initial).view(np.int32)
            return torch.from_numpy(words).to(self.device)
        seed = self.config.seed if seed is None else seed
        if not self.bitpacked:
            return init_dense(rows, cols, seed, device=self.device)
        return bitlife.init_packed(rows, self.cols_eff, seed,
                                   col_limit=self.col_limit,
                                   device=self.device)

    def stack_grids(self, grids):
        """One (B, ...) batch from B grids (or sparse states) of this
        engine."""
        grids = list(grids)
        if self.sparse_plan is not None:
            return SparseState(torch.stack([g.grid for g in grids]),
                               torch.stack([g.changed for g in grids]))
        return torch.stack(grids)

    def unstack_grids(self, batched) -> list:
        """The B grids (or sparse states) of a stacked batch, each in
        buffers of its own."""
        if self.sparse_plan is not None:
            return [SparseState(g.clone(), c.clone()) for g, c in
                    zip(batched.grid.unbind(0), batched.changed.unbind(0))]
        return [b.clone() for b in batched.unbind(0)]

    def warm_up(self, boards: int = 0) -> None:
        """Build and load the kernel and launch it once at each pass depth
        of the run on a one-cell or one-word grid (and for a seam engine
        run the band's extraction and stitch on a one-row grid and its K2
        step at its height; for a sparse engine run every phase on a zero
        grid of 3 x 3 tiles, so that PyTorch's kernels for them are
        loaded), and allocate the spare buffer of the ping-pong pair (and
        of a batch of ``boards``), so the first timed pass pays no build,
        module load, first-launch setup, host-to-device copy or
        ``cudaMalloc``."""
        self._warm(self.depths, boards)

    def _warm(self, depths, boards: int) -> None:
        """:meth:`warm_up` at the pass ``depths`` given."""
        dtype = torch.int32 if self.bitpacked else torch.uint8
        rule = self.config.rule
        shape = self._shape()
        for k in depths:
            if self.device.type == "cuda":
                tiny = torch.zeros((1, 1), dtype=dtype, device=self.device)
                self._kernel(tiny, rule, self.config.boundary, gens=k)
            if self.seam:
                C, d = self.config.cols, k * rule.radius
                rows = [(1, shape[1])] + ([(1, 1, shape[1])] if boards else [])
                for row in rows:
                    tiny = torch.zeros(row, dtype=dtype, device=self.device)
                    seam.stitch_band(tiny, seam.extract_band(tiny, C, d), C, d)
                seam.step_band(torch.zeros((shape[0], 4 * d), dtype=torch.uint8,
                                           device=self.device), rule, k)
        if self.sparse_plan is not None:
            self._warm_sparse(dtype)
            boards = 0  # a sparse batch steps board by board
        for key in [shape] + ([(boards, *shape)] if boards else []):
            self._keep_spare(torch.empty(key, dtype=dtype, device=self.device))

    def _step_depths(self, n: int):
        """The pass depths a step of ``n`` generations launches (a sparse
        engine: its own, every phase)."""
        if self.sparse_plan is not None:
            return self.depths
        return sorted(segment_depths([n], self.depth))

    def _warm_step(self, n: int, boards: int) -> None:
        self._warm(self._step_depths(n), boards)

    def _batch_width(self, grids):
        raw = self.raw_grid(grids)
        return raw.shape[0] if raw.dim() == 3 else None

    def _warm_sparse(self, dtype) -> None:
        # 3 x 3 tiles of zeros: a dense chunk of 8 and the probe (every tile
        # starts changed), then a gather of plan.gens and one of 1 (the probe
        # found nothing changed)
        p = self.sparse_plan
        tiny = activity.make_plan(
            rows=3 * p.tile_r, cols_units=3 * p.tile_c, tile_px=p.tile_px,
            radius=self.config.rule.radius, periodic=p.periodic,
            packed=self.bitpacked)
        grid = torch.zeros((3 * p.tile_r, 3 * p.tile_c), dtype=dtype,
                           device=self.device)
        state, spare = activity.initial_state(grid, tiny), None
        evolve = self._sparse_evolve(tiny)
        for n in (activity.DENSE_CHUNKS[-2] + 1, tiny.gens + 1):
            state, spare = evolve(state, n, spare)

    def sync(self) -> None:
        """Wait for the device: closes every timed region."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def block_until_ready(self, grid):
        """Wait until the launches queued so far on this thread's stream,
        those that produce ``grid`` among them, have run; returns ``grid``.
        A no-op on the CPU, whose steps finish before they return."""
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            event.synchronize()
        return grid

    def _stream(self):
        """The stream this thread launches on (None on the CPU)."""
        if self.device.type == "cuda":
            return torch.cuda.current_stream(self.device)
        return None

    def _keep_spare(self, spare: torch.Tensor) -> None:
        stream = self._stream()
        with self._spare_lock:
            self._spares[spare.dim()] = spare
            self._spare_streams[spare.dim()] = stream

    def _take_spare(self, grid: torch.Tensor) -> torch.Tensor:
        # threads that share the engine (the serve layer's) each pop the
        # spare whole, and reuse it only on the stream that last launched
        # on it: launches still reading it run before the next writer's only
        # in one stream's order (the device's default stream, unless a
        # caller picks another)
        with self._spare_lock:
            spare = self._spares.pop(grid.dim(), None)
            stream = self._spare_streams.pop(grid.dim(), None)
        if (spare is None or stream != self._stream()
                or spare.shape != grid.shape
                or spare.device != grid.device
                or spare.data_ptr() == grid.data_ptr()):
            del spare  # freed before its replacement is allocated
            spare = torch.empty_like(grid)
        return spare

    def _advance(self, grid: torch.Tensor, n: int) -> torch.Tensor:
        grid, spare = self._evolve(grid, n, self._take_spare(grid))
        self._keep_spare(spare)
        return grid

    def _state(self, grid):
        if (self.sparse_plan is not None) != isinstance(grid, SparseState):
            raise TypeError("a sparse engine steps a SparseState and any "
                            "other engine a tensor; init_grid gives the "
                            "engine's kind")
        return grid

    def _advance_sparse(self, state: SparseState, n: int) -> SparseState:
        state, spare = self._evolve(state, n, self._take_spare(state.grid))
        self._keep_spare(spare)
        return state

    def step(self, grid, n: int):
        """Advance ``grid`` (a sparse engine's ``SparseState``) by ``n``
        generations; consumes ``grid``."""
        grid = self._state(grid)
        if n <= 0:
            return grid
        if self.fault_hook is not None:
            # before any buffer is taken or any launch made: an injected
            # failure leaves the caller's grid intact
            self.fault_hook("step")
        self.step_calls += 1
        if self.sparse_plan is not None:
            return self._advance_sparse(grid, n)
        return self._advance(grid, n)

    def step_batched(self, grids, n: int):
        """Advance every board of a stacked (B, ...) batch by ``n``
        generations, one kernel launch per pass for the whole batch (a
        sparse engine steps the boards in turn, each with its own phases);
        consumes ``grids``."""
        grids = self._state(grids)
        if n <= 0:
            return grids
        if self.raw_grid(grids).dim() != 3:
            raise ValueError(f"a batch is (B, rows, cols), got "
                             f"{tuple(self.raw_grid(grids).shape)}")
        if self.fault_hook is not None:
            self.fault_hook("batched")
        self.batched_step_calls += 1
        if self.sparse_plan is not None:
            return self._step_boards(grids, n)
        return self._advance(grids, n)

    def _step_boards(self, states: SparseState, n: int) -> SparseState:
        # each board steps in its batch's buffers; a result the dense phase
        # left in the private spare is copied back, and no view of the batch
        # is ever kept as the spare
        spare = self._take_spare(states.grid[0])
        for g, c in zip(states.grid.unbind(0), states.changed.unbind(0)):
            (new, changed), spare = self._evolve(SparseState(g, c), n, spare)
            if new.data_ptr() != g.data_ptr():
                g.copy_(new)
                spare = new
            c.copy_(changed)
        self._keep_spare(spare)
        return states

    def fetch(self, grid) -> np.ndarray:
        """The grid as a host uint8 0/1 array cropped to the real width,
        unpacked on the device a block of rows at a time."""
        return self._fetch(self.raw_grid(grid))

    def _fetch(self, grid: torch.Tensor) -> np.ndarray:
        if not self.bitpacked:
            return grid.cpu().numpy().copy()
        rows, nw = grid.shape
        cols = self.config.cols
        out = np.empty((rows, cols), dtype=np.uint8)
        step = max(1, _FETCH_WORDS // nw)
        for r0 in range(0, rows, step):
            cells = bitlife.unpack(grid[r0:r0 + step])[:, :cols]
            out[r0:r0 + step] = cells.cpu().numpy()
        return out

    def fetch_batched(self, grids) -> List[np.ndarray]:
        """Each board of a stacked batch as a host array (cropped to the
        real width)."""
        return [self._fetch(g) for g in self.raw_grid(grids)]

    def tiles(self, grid):
        """Snapshot tiles ``(pid, tile, r0, c0)``: one device, one tile."""
        return [(0, self.fetch(grid), 0, 0)]

    def shard_snapshots(self, grid):
        """``[(r0, c0, tile)]``: the checkpoint tiles, one for one device."""
        return [(0, 0, self.fetch(grid))]

    def _window(self, r0: int, c0: int, h: int, w: int):
        """(word or cell columns to slice, first cell column in the slice)
        of the window ``[r0, r0+h) x [c0, c0+w)``, which must lie on the
        board's real cells."""
        rows, cols = self.config.rows, self.config.cols
        if not (h > 0 and w > 0 and 0 <= r0 and r0 + h <= rows
                and 0 <= c0 and c0 + w <= cols):
            raise ValueError(f"window [{r0}:{r0 + h}, {c0}:{c0 + w}] is not "
                             f"on the {rows}x{cols} board")
        if not self.bitpacked:
            return slice(c0, c0 + w), 0
        w0 = c0 // WORD
        return slice(w0, -(-(c0 + w) // WORD)), c0 - w0 * WORD

    def fetch_window(self, grid, r0: int, c0: int, h: int, w: int,
                     shard_timer=None) -> np.ndarray:
        """The host window ``[r0, r0+h) x [c0, c0+w)`` of the board (uint8
        0/1), cropped on the device: only its rows, and on a packed grid
        the words it covers, are unpacked and cross to the host, in one
        transfer.  ``shard_timer(dt_s)`` is called once, with that
        transfer's time."""
        cols, off = self._window(r0, c0, h, w)
        block = self.raw_grid(grid)[r0:r0 + h, cols]
        if self.bitpacked:
            block = bitlife.unpack(block)[:, off:off + w]
        t0 = time.perf_counter()
        out = block.to("cpu", copy=True).numpy()
        if shard_timer is not None:
            shard_timer(time.perf_counter() - t0)
        return out

    def write_window(self, grid, r0: int, c0: int, patch):
        """``grid`` with the uint8 0/1 ``patch`` written at ``(r0, c0)``,
        in place on the device; on a packed grid the edge words are read,
        changed and written back, and the pad bits stay zero.  None on a
        sparse engine, whose tile map a partial edit would make stale:
        the caller re-inits the whole board."""
        if self.sparse_plan is not None:
            return None
        patch = np.asarray(patch, dtype=np.uint8)
        h, w = patch.shape
        cols, off = self._window(r0, c0, h, w)
        cells = torch.from_numpy(patch).to(self.device)
        if not self.bitpacked:
            grid[r0:r0 + h, cols] = cells
            return grid
        block = bitlife.unpack(grid[r0:r0 + h, cols])
        block[:, off:off + w] = cells
        grid[r0:r0 + h, cols] = bitlife.pack(block)
        return grid

    def population(self, grid) -> int:
        """Live cells, counted on the device (the pad is always dead)."""
        grid = self.raw_grid(grid)
        if not self.bitpacked:
            return int(grid.sum(dtype=torch.int64).item())
        return bitlife.population(grid)

    def population_batched(self, grids) -> List[int]:
        """Live cells of each board of a stacked batch: one reduction on
        the device, one host transfer of B counts."""
        grids = self.raw_grid(grids)
        cells = grids if not self.bitpacked else bitlife.popcount(grids)
        counts = cells.sum(dim=(1, 2), dtype=torch.int64)
        return [int(v) for v in counts.cpu()]


def build_engine(config: GolConfig, device=None, depths=None, tune=None,
                 blocks=None, mesh=None):
    """The engine for ``config`` on ``device`` (the GPU when None).
    ``depths``: the pass depths that will run (default 1 to the pass
    depth); each must be one the chosen kernel serves.  A sparse engine
    runs depth 1 and its dense chunks' depth, and its stripes at every
    rung.  Planning notes print to stderr and stay on ``Engine.notes``.

    ``mesh``: a ``parallel/mesh.py:Mesh`` to shard the grid over (its
    devices, not ``device``, hold the shards); without one,
    ``config.mesh_shape`` builds one on ``device``'s kind (every card, or
    the CPU's virtual devices).  A mesh of more than one shard gives a
    :class:`~mpi_tpu_torch.backends.cuda_mesh.MeshEngine`
    (:func:`build_mesh_engine`); (1, 1) is the one-device engine.

    ``tune``: an opt-in :class:`~mpi_tpu_torch.tune.TuneCache` (or its
    path): a winner cached for this (device, requested plan) replaces the
    requested knobs before planning and is kept on ``Engine.tuned_plan``;
    None never reads a cache.  ``blocks``: the CTA tile of K1 ([rows,
    words a lane]), K3 ([rows]) or K2 ([rows, cols]), a build variant of
    the engine's kernel, which every launch of the engine takes (the
    tuner probes them; a cached winner's arrives through ``tune``); the
    seam band of a padded periodic grid keeps K2's default build.  The
    CPU and the host backends raise :class:`ConfigError`."""
    if mesh is None and config.mesh_shape is not None \
            and tuple(config.mesh_shape) != (1, 1):
        from mpi_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(tuple(config.mesh_shape),
                         platform=resolve_device(device).type)
    if mesh is not None:
        for d in mesh.local_devices():
            resolve_device(d)
        if mesh.size > 1:
            return build_mesh_engine(config, mesh, depths=depths, tune=tune,
                                     blocks=blocks)
        device = mesh.devices[0][0]
    dev = resolve_device(device)
    tuned_plan = None
    if tune is not None:
        from mpi_tpu_torch.tune import resolve_tuned

        config, tuned_plan = resolve_tuned(config, (1, 1), tune, device=dev)
        if tuned_plan is not None and blocks is None:
            blocks = tuned_plan.get("blocks")
    kind, cols_eff, pad_bits, notes = plan_engine(config)
    notes = list(notes)
    kernel_id, _, refusal = KERNELS[kind]
    rule, r = config.rule, config.rule.radius
    depth = pass_depth(config, kind)
    if depth < config.comm_every:
        notes.append(
            f"comm_every {config.comm_every} x radius {r} = "
            f"{config.comm_every * r} > {cuda_stencil.MAX_DEPTH}, K2's "
            f"halo: passes of depth {depth} (on one device every "
            f"comm_every gives the same grid)")
    sparse_plan, stripes = None, []
    if config.sparse_tile:
        sparse_plan = plan_sparse(config, kind, cols_eff, pad_bits)
        p = sparse_plan
        unit = p.cell_cols_per_unit
        stripes = [(p.stripe_shape(K)[0], p.stripe_shape(K)[1] * unit)
                   for K in p.capacities]
        dense_depth = sparse_dense_depth(kind, rule)
        depths = (1, dense_depth)
        notes.append(
            f"sparse stepping on {p.tile_px}x{p.tile_px} tiles ({p.nti}x"
            f"{p.ntj}, rungs {list(p.capacities)}, {p.gens} generations a "
            f"gather, dense chunks in passes of {dense_depth}): the host "
            f"reads the active count once a phase (after each gather and "
            f"each probe); step_batched steps each board's phases in turn, "
            f"with launches per board")
    elif depths is None:
        depths = range(1, depth + 1)
    if blocks is not None:
        check_blocks(config, kind, dev, blocks)
        notes.append(_tile_note(kernel_id, blocks, pad_bits > 0 and
                                config.boundary == "periodic"))
    if tuned_plan is not None:
        notes.append(f"autotuned plan applied: {tuned_plan} (tune cache "
                     f"winner for this signature)")
    for msg in notes:
        print(f"note: {msg}", file=sys.stderr)
    depths = [k for k in depths if k > 0]
    checks = ([((config.rows, cols_eff), k, config.boundary) for k in depths]
              + [(s, 1, "dead") for s in stripes])
    for shape, k, boundary in checks:
        reason = refusal(shape, rule, k, boundary)
        if reason:
            raise ConfigError(f"kernel {kernel_id} cannot run {rule} "
                              f"at depth {k} on a {shape[0]}x{shape[1]} "
                              f"grid: {reason}")
    engine = Engine(config, dev, kind, depths, cols_eff, pad_bits, notes,
                    depth=depth, sparse_plan=sparse_plan, blocks=blocks)
    engine.tuned_plan = tuned_plan
    return engine


def build_mesh_engine(config: GolConfig, mesh, depths=None, tune=None,
                      blocks=None):
    """The engine for ``config`` sharded over ``mesh`` (more than one
    shard): the plan (:func:`plan_mesh_engine`), the reference's checks
    (``validate_mesh`` on the mesh's shape, ``overlap`` on tiles too small
    for its bands), and a check of every window a pass launches the
    kernel on, at every depth, against the kernel's refusal: a shape the
    kernel declines raises :class:`ConfigError`, never a fallback.

    ``tune`` and ``blocks`` as for :func:`build_engine`: a cached winner
    for this (device, requested plan, mesh shape) replaces the requested
    knobs before planning, and a CTA tile builds every shard window's
    launch with that variant of K1, K3 or K2."""
    from mpi_tpu_torch.backends.cuda_mesh import MeshEngine, chunk_gens
    from mpi_tpu_torch.config import validate_mesh

    mi, mj = mesh.dims
    dev = mesh.devices[0][0]
    tuned_plan = None
    if tune is not None:
        from mpi_tpu_torch.tune import resolve_tuned

        config, tuned_plan = resolve_tuned(config, (mi, mj), tune,
                                           device=dev)
        if tuned_plan is not None and blocks is None:
            blocks = tuned_plan.get("blocks")
    validate_mesh(config.rows, config.cols, (mi, mj),
                  config.rule.radius * config.comm_every,
                  processes=mesh.processes)
    if config.sparse_tile:
        raise ConfigError(
            f"sparse_tile requires a single-device mesh (got {mi}x{mj}); "
            f"shard OR activity-gate, not both yet")
    kind, cols_eff, pad_bits, notes = plan_mesh_engine(config, mi, mj)
    notes = list(notes)
    rule, r, K = config.rule, config.rule.radius, config.comm_every
    overlap = config.overlap
    if overlap and pad_bits and K > 1 and kind != "dense":
        notes.append(
            "--overlap dropped: padded (non-word-aligned) width "
            "with comm_every > 1 uses the exchange-all packed body "
            "(still far faster than the dense engine; overlap needs "
            "comm_every 1 here)")
    elif overlap:
        tile_r, tile_c = config.rows // mi, cols_eff // mj
        d = K if kind == "bit" else K * r
        if kind == "dense":
            if min(tile_r, tile_c) < 2 * d:
                raise ConfigError(
                    f"--overlap needs tiles >= {2 * d}x{2 * d} for radius "
                    f"{r} x comm_every {K} bands (got {tile_r}x{tile_c})")
        elif tile_r < 2 * d or tile_c < 2 * WORD:
            what = (f"tiles >= {2 * d} rows x {2 * WORD} cols"
                    if kind == "bit" else
                    f"tiles >= {2 * d} rows x {2 * WORD} cols for the "
                    f"bit-sliced radius-{r} bands")
            need = f"{what} (got {tile_r}x{tile_c})"
            if not pad_bits:
                raise ConfigError(f"--overlap needs {need}")
            notes.append(f"--overlap dropped: padded tile too small for "
                         f"the stitched bands ({need}); running the "
                         f"packed engine without overlap")
            overlap = False
    kernel_id, kernel, refusal = KERNELS[kind]
    if blocks is not None:
        check_blocks(config, kind, dev, blocks)
        kernel = functools.partial(kernel,
                                   defines=BLOCK_DEFINES[kind](blocks))
        notes.append(_tile_note(kernel_id, blocks, pad_bits > 0 and
                                config.boundary == "periodic"))
    if tuned_plan is not None:
        notes.append(f"autotuned plan applied: {tuned_plan} (tune cache "
                     f"winner for this signature)")
    for msg in notes:
        print(f"note: {msg}", file=sys.stderr)
    if depths is None:
        depths = range(1, K + 1)
    depths = [k for k in depths if k > 0]
    # the largest window a pass steps: a shard with its ghosts on every
    # side (the kernels take any height, and whole words, so the smallest
    # windows, bands and edge shards, pass where this one does)
    th, tw = config.rows // mi, cols_eff // mj
    for k in depths:
        dr = k if kind == "bit" else k * r
        dc = WORD if kind != "dense" else k * r
        shape = (th + 2 * dr, tw + 2 * dc)
        for g in chunk_gens(kind, rule, [k]):
            reason = refusal(shape, rule, g, "dead")
            if reason:
                raise ConfigError(
                    f"kernel {kernel_id} cannot run {rule} at depth {g} on "
                    f"a {shape[0]}x{shape[1]} shard window of the {mi}x{mj} "
                    f"mesh: {reason}")
    engine = MeshEngine(config, mesh, kind, kernel, kernel_id, depths,
                        cols_eff, pad_bits, overlap, notes)
    engine.tuned_plan = tuned_plan
    engine.blocks = None if blocks is None else [int(v) for v in blocks]
    return engine


def run_cuda(
    config: GolConfig,
    timer: Optional[PhaseTimer] = None,
    snapshot_cb: Optional[SnapshotCb] = None,
    initial=None,
    start_iteration: int = 0,
    device=None,
    mesh=None,
) -> np.ndarray:
    """Run one configuration; returns the final grid as a host uint8 array
    (None on a mesh that spans a process group: no process holds it).

    ``initial``/``start_iteration`` resume from a grid loaded with
    ``golio.load_snapshot`` at the iteration it was saved at, or, on a
    mesh, from a region loader ``initial(r0, r1, c0, c1)`` called once
    for each shard this process holds.  ``mesh`` shards the run (see
    :func:`build_engine`); snapshot tiles are then one a shard, this
    process's shards only under a process group."""
    timer = timer or PhaseTimer()
    want_snapshots = snapshot_cb is not None and config.snapshot_every > 0
    segments = plan_segments(
        config.steps, config.snapshot_every if want_snapshots else 0)
    engine = build_engine(config, device=device,
                          depths=segment_depths(segments, pass_depth(config)),
                          mesh=mesh)
    grid = engine.init_grid(initial=initial)
    engine.warm_up()
    engine.sync()
    timer.setup_done()

    it = start_iteration
    if want_snapshots and it == 0:
        snapshot_cb(0, engine.tiles(grid))
    for n in segments:
        grid = engine.step(grid, n)
        it += n
        if want_snapshots:
            snapshot_cb(it, engine.tiles(grid))
    engine.sync()
    timer.finish()
    return engine.fetch(grid)
