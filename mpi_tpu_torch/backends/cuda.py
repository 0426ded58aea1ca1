"""CUDA backend: hash init → K-generation kernel passes → snapshot hooks,
on one device.

The single-device paths of ``mpi_tpu.backends.tpu``: ``plan_pad_width``
and ``select_engine`` pick the width and the kernel, ``build_engine``
checks the plan and prints its notes, ``Engine`` holds the stepper,
``run_cuda`` is the one-shot run the CLI calls.  Three engines:

* ``"bit"``: radius 1, packed int32 words, kernel K1
  (``ops/cuda_bitlife.py``);
* ``"ltl"``: radius 2..7 with comm_every <= ⌊8/r⌋, packed words on bit
  planes, kernel K3 (``ops/cuda_bitltl.py``);
* ``"dense"``: any other rule and depth with comm_every x r <= 16, and the
  widths the pad plan leaves alone, uint8 cells, kernel K2
  (``ops/cuda_stencil.py``).

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

Kernel build and warm-up count as setup, as compilation does in the
reference; the segment loop is the timed steady state.

Entry points run on the GPU unless the caller passes ``device="cpu"``,
which runs the plain PyTorch version of the kernel; without CUDA and
without that request they raise.
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from mpi_tpu_torch.config import WORD, ConfigError, GolConfig, plan_segments
from mpi_tpu_torch.interop import dense_from_numpy
from mpi_tpu_torch.ops import bitlife, cuda_bitlife, cuda_bitltl, cuda_stencil
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


def plan_pad_width(config: GolConfig) -> Tuple[int, int]:
    """(cols_padded, pad_bits): the reference's pad-to-32 plan
    (``mpi_tpu.backends.tpu.plan_pad_width``) on one device.  A width that
    is not a whole number of words is padded with trailing dead columns to
    the next word, so the run takes the packed kernels; a periodic width
    pads only where the seam band serves it
    (``seam_serves(cols, comm_every x r)``), else it keeps its width and
    K2.  The reference's stretch of the padded width to 4096 cells at
    comm_every 1 is a TPU lane contract that the port's kernels do not
    have, so it is left out."""
    if config.cols % WORD == 0:
        return config.cols, 0
    if config.boundary == "periodic" and not seam.seam_serves(
            config.cols, config.comm_every * config.rule.radius):
        return config.cols, 0
    padded = -(-config.cols // WORD) * WORD
    return padded, padded - config.cols


def plan_engine(config: GolConfig) -> Tuple[str, int, int, Tuple[str, ...]]:
    """(engine, cols_eff, pad_bits, notes): the reference's single-device
    choice (``mpi_tpu.backends.tpu.build_engine``: the pad plan, then K1
    for radius 1 on a width of whole words, the fused bit-sliced kernel for
    radius >= 2 when comm_every <= ⌊8/r⌋, else the dense kernel), without
    the TPU's lane and VMEM conditions, which the port's kernels do not
    have.  Where the reference would take a 1x1-mesh stepper, the port
    takes K2 at the real width.  The notes say why a non-word-aligned
    width stays on K2, in the reference's words.  ``GolConfig`` refuses
    what no kernel serves (comm_every x r > 16)."""
    r = config.rule.radius
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
    """``"bit"``, ``"ltl"`` or ``"dense"``: the engine ``plan_engine``
    picks."""
    return plan_engine(config)[0]


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


class Engine:
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
    read the old one.

    A padded engine (``pad_bits`` > 0) holds ``cols_eff`` columns of which
    the first ``config.cols`` are real (``col_limit``); the pad is always
    zero, so ``population`` is exact, and ``fetch`` and ``tiles`` crop to
    the real width.  ``notes`` are the planning notes ``build_engine``
    printed."""

    def __init__(self, config: GolConfig, device: torch.device, kind: str,
                 depths=(1,), cols_eff: Optional[int] = None,
                 pad_bits: int = 0, notes=()):
        self.config = config
        self.device = device
        self.kind = kind
        self.depths = sorted(set(depths)) or [1]
        self.bitpacked = kind != "dense"
        self.kernel_id, self._kernel, _ = KERNELS[kind]
        self.cols_eff = config.cols if cols_eff is None else cols_eff
        self.pad_bits = pad_bits
        self.col_limit = config.cols if pad_bits else None
        self.notes = tuple(notes)
        # the seam band repairs a periodic padded grid's wrap columns
        self.seam = pad_bits > 0 and config.boundary == "periodic"
        if self.seam:
            self._evolve = seam.make_seam_stepper(
                self._pass, config.rule, config.cols, config.comm_every)
        else:
            self._evolve = segmented_evolve(self._pass, config.comm_every)
        # the spare buffer of the ping-pong pair, one for a solo grid (rank 2)
        # and one for a batch (rank 3), replaced when the shape changes
        self._spares = {}
        self.step_calls = 0
        self.batched_step_calls = 0

    def _pass(self, src, k, dst):
        if self.bitpacked:
            return self._kernel(src, self.config.rule, self.config.boundary,
                                gens=k, out=dst, col_limit=self.col_limit)
        return self._kernel(src, self.config.rule, self.config.boundary,
                            gens=k, out=dst)

    def _shape(self) -> Tuple[int, int]:
        cols = self.cols_eff // WORD if self.bitpacked else self.config.cols
        return self.config.rows, cols

    def init_grid(self, initial=None, seed=None) -> torch.Tensor:
        """A fresh grid on the device: the hash init of ``seed`` (default
        config.seed), or the uint8 0/1 ``initial`` grid; a padded grid's
        pad starts dead."""
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

    def init_grids(self, seeds=None, initials=None) -> torch.Tensor:
        """A fresh stacked (B, ...) batch: one board per entry of ``seeds``
        (hash init) or ``initials`` (uint8 grids)."""
        if initials is not None:
            boards = [self.init_grid(initial=i) for i in initials]
        else:
            boards = [self.init_grid(seed=s) for s in seeds]
        return self.stack_grids(boards)

    def stack_grids(self, grids) -> torch.Tensor:
        """One (B, ...) batch from B grids of this engine."""
        return torch.stack(list(grids))

    def unstack_grids(self, batched: torch.Tensor) -> list:
        """The B grids of a stacked batch, each in a buffer of its own."""
        return [b.clone() for b in batched.unbind(0)]

    def warm_up(self, boards: int = 0) -> None:
        """Build and load the kernel and launch it once at each pass depth
        of the run on a one-cell or one-word grid (and for a seam engine
        run the band's extraction and stitch on a one-row grid and its K2
        step at its height, so that its index tensors exist and PyTorch's
        kernels are loaded), and
        allocate the spare buffer of the ping-pong pair (and of a batch of
        ``boards``), so the first timed pass pays no build, module load,
        first-launch setup, host-to-device copy or ``cudaMalloc``."""
        dtype = torch.int32 if self.bitpacked else torch.uint8
        rule = self.config.rule
        shape = self._shape()
        for k in self.depths:
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
        for key in [shape] + ([(boards, *shape)] if boards else []):
            self._spares[len(key)] = torch.empty(key, dtype=dtype,
                                                 device=self.device)

    def sync(self) -> None:
        """Wait for the device: closes every timed region."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _advance(self, grid: torch.Tensor, n: int) -> torch.Tensor:
        rank = grid.dim()
        spare = self._spares.pop(rank, None)
        if (spare is None or spare.shape != grid.shape
                or spare.device != grid.device
                or spare.data_ptr() == grid.data_ptr()):
            del spare  # freed before its replacement is allocated
            spare = torch.empty_like(grid)
        grid, self._spares[rank] = self._evolve(grid, n, spare)
        return grid

    def step(self, grid: torch.Tensor, n: int) -> torch.Tensor:
        """Advance ``grid`` by ``n`` generations; consumes ``grid``."""
        if n <= 0:
            return grid
        self.step_calls += 1
        return self._advance(grid, n)

    def step_units(self, grid: torch.Tensor, n: int) -> torch.Tensor:
        """``n`` chained depth-1 steps with no sync between them (the one
        depth every serve session warms); consumes ``grid``."""
        for _ in range(max(0, int(n))):
            grid = self.step(grid, 1)
        return grid

    def step_batched(self, grids: torch.Tensor, n: int) -> torch.Tensor:
        """Advance every board of a stacked (B, ...) batch by ``n``
        generations, one kernel launch per pass for the whole batch;
        consumes ``grids``."""
        if n <= 0:
            return grids
        if grids.dim() != 3:
            raise ValueError(f"a batch is (B, rows, cols), got "
                             f"{tuple(grids.shape)}")
        self.batched_step_calls += 1
        return self._advance(grids, n)

    def step_batched_units(self, grids: torch.Tensor, n: int) -> torch.Tensor:
        """Batched :meth:`step_units`: ``n`` chained depth-1 batched steps
        with no sync between them; consumes ``grids``."""
        for _ in range(max(0, int(n))):
            grids = self.step_batched(grids, 1)
        return grids

    def batched_stepper(self, B: int):
        """A ``step(grids, n)`` callable pinned to batch width ``B``; it
        raises on a batch of another width."""
        def step(grids, n):
            got = grids.shape[0] if grids.dim() == 3 else None
            if got != B:
                raise ValueError(f"batched stepper built for B={B}, got {got}")
            return self.step_batched(grids, n)

        step.B = B
        step.engine = self
        return step

    def fetch(self, grid: torch.Tensor) -> np.ndarray:
        """The grid as a host uint8 0/1 array cropped to the real width,
        unpacked on the device a block of rows at a time."""
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

    def fetch_batched(self, grids: torch.Tensor) -> List[np.ndarray]:
        """Each board of a stacked batch as a host array (cropped to the
        real width)."""
        return [self.fetch(g) for g in grids]

    def tiles(self, grid: torch.Tensor):
        """Snapshot tiles ``(pid, tile, r0, c0)``: one device, one tile."""
        return [(0, self.fetch(grid), 0, 0)]

    def population(self, grid: torch.Tensor) -> int:
        """Live cells, counted on the device (the pad is always dead)."""
        if not self.bitpacked:
            return int(grid.sum(dtype=torch.int64).item())
        return bitlife.population(grid)

    def population_batched(self, grids: torch.Tensor) -> List[int]:
        """Live cells of each board of a stacked batch: one reduction on
        the device, one host transfer of B counts."""
        cells = grids if not self.bitpacked else bitlife.popcount(grids)
        counts = cells.sum(dim=(1, 2), dtype=torch.int64)
        return [int(v) for v in counts.cpu()]


def build_engine(config: GolConfig, device=None, depths=None) -> Engine:
    """The engine for ``config`` on ``device`` (the GPU when None).
    ``depths``: the pass depths that will run (default 1..comm_every);
    each must be one the chosen kernel serves.  Planning notes print to
    stderr as they are decided and stay on ``Engine.notes``."""
    dev = resolve_device(device)
    kind, cols_eff, pad_bits, notes = plan_engine(config)
    for msg in notes:
        print(f"note: {msg}", file=sys.stderr)
    kernel_id, _, refusal = KERNELS[kind]
    if depths is None:
        depths = range(1, config.comm_every + 1)
    depths = [k for k in depths if k > 0]
    shape = (config.rows, cols_eff)
    for k in depths:
        reason = refusal(shape, config.rule, k, config.boundary)
        if reason:
            raise ConfigError(f"kernel {kernel_id} cannot run {config.rule} "
                              f"at depth {k} on a {shape[0]}x{shape[1]} "
                              f"grid: {reason}")
    return Engine(config, dev, kind, depths, cols_eff, pad_bits, notes)


def run_cuda(
    config: GolConfig,
    timer: Optional[PhaseTimer] = None,
    snapshot_cb: Optional[SnapshotCb] = None,
    initial=None,
    start_iteration: int = 0,
    device=None,
) -> np.ndarray:
    """Run one configuration; returns the final grid as a host uint8 array.

    ``initial``/``start_iteration`` resume from a grid loaded with
    ``golio.load_snapshot`` at the iteration it was saved at."""
    timer = timer or PhaseTimer()
    want_snapshots = snapshot_cb is not None and config.snapshot_every > 0
    segments = plan_segments(
        config.steps, config.snapshot_every if want_snapshots else 0)
    engine = build_engine(config, device=device,
                          depths=segment_depths(segments, config.comm_every))
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
