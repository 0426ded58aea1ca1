"""CUDA backend: hash init → K-generation kernel passes → snapshot hooks,
on one device.

The single-device paths of ``mpi_tpu.backends.tpu``: ``select_engine``
picks the kernel, ``build_engine`` checks the plan, ``Engine`` holds the
stepper, ``run_cuda`` is the one-shot run the CLI calls.  Three engines:

* ``"bit"``: radius 1 at a width of whole 32-cell words, packed int32
  words, kernel K1 (``ops/cuda_bitlife.py``);
* ``"ltl"``: radius 2..7 at a word-aligned width with comm_every <= ⌊8/r⌋,
  packed words on bit planes, kernel K3 (``ops/cuda_bitltl.py``);
* ``"dense"``: any other rule and width with comm_every x r <= 16, uint8
  cells, kernel K2 (``ops/cuda_stencil.py``).

Kernel build and warm-up count as setup, as compilation does in the
reference; the segment loop is the timed steady state.

Entry points run on the GPU unless the caller passes ``device="cpu"``,
which runs the plain PyTorch version of the kernel; without CUDA and
without that request they raise.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from mpi_tpu_torch.config import WORD, ConfigError, GolConfig, plan_segments
from mpi_tpu_torch.interop import dense_from_numpy
from mpi_tpu_torch.ops import bitlife, cuda_bitlife, cuda_bitltl, cuda_stencil
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


def select_engine(config: GolConfig) -> str:
    """``"bit"``, ``"ltl"`` or ``"dense"``: the reference's single-device
    choice (``mpi_tpu.backends.tpu``: K1 for packed radius 1; the fused
    bit-sliced kernel for radius >= 2 when comm_every <= ⌊8/r⌋; the dense
    kernel when comm_every x r <= 16), without the TPU's lane and VMEM
    conditions, which the port's kernels do not have.  Where the reference
    would take a 1x1-mesh stepper or pad to 32 columns, the port takes K2.
    ``GolConfig`` refuses what no kernel serves (comm_every x r > 16)."""
    r = config.rule.radius
    if config.cols % WORD == 0:
        if r == 1:
            return "bit"
        if config.comm_every <= cuda_bitltl.max_gens(r):
            return "ltl"
    return "dense"


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
    it.  ``step`` consumes its input, as the reference's donated buffers
    do: the engine keeps the input as the spare buffer of its ping-pong
    pair, and the next ``step`` writes into it.  Callers must replace
    their reference with the returned grid and never read the old one."""

    def __init__(self, config: GolConfig, device: torch.device, kind: str,
                 depths=(1,)):
        self.config = config
        self.device = device
        self.kind = kind
        self.depths = sorted(set(depths)) or [1]
        self.bitpacked = kind != "dense"
        self.kernel_id, self._kernel, _ = KERNELS[kind]
        self._evolve = segmented_evolve(self._pass, config.comm_every)
        self._spare: Optional[torch.Tensor] = None

    def _pass(self, src, k, dst):
        return self._kernel(src, self.config.rule, self.config.boundary,
                            gens=k, out=dst)

    def init_grid(self, initial=None, seed=None) -> torch.Tensor:
        """A fresh grid on the device: the hash init of ``seed`` (default
        config.seed), or the uint8 0/1 ``initial`` grid."""
        rows, cols = self.config.rows, self.config.cols
        if initial is not None:
            initial = np.asarray(initial, dtype=np.uint8)
            if initial.shape != (rows, cols):
                raise ConfigError(
                    f"initial grid is {initial.shape}, config asks for "
                    f"{(rows, cols)}")
            if not self.bitpacked:
                return dense_from_numpy(initial, self.device)
            words = bitlife.pack_np(initial).view(np.int32)
            return torch.from_numpy(words).to(self.device)
        seed = self.config.seed if seed is None else seed
        if not self.bitpacked:
            return init_dense(rows, cols, seed, device=self.device)
        return bitlife.init_packed(rows, cols, seed, device=self.device)

    def warm_up(self) -> None:
        """Build and load the kernel and launch it once at each pass depth
        of the run on a one-cell or one-word grid, and allocate the spare
        buffer of the ping-pong pair, so the first timed pass pays no
        build, module load, first-launch setup or ``cudaMalloc``."""
        dtype = torch.int32 if self.bitpacked else torch.uint8
        if self.device.type == "cuda":
            tiny = torch.zeros((1, 1), dtype=dtype, device=self.device)
            for k in self.depths:
                self._kernel(tiny, self.config.rule, self.config.boundary,
                             gens=k)
        cols = self.config.cols // bitlife.WORD if self.bitpacked \
            else self.config.cols
        self._spare = torch.empty((self.config.rows, cols), dtype=dtype,
                                  device=self.device)

    def sync(self) -> None:
        """Wait for the device: closes every timed region."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, grid: torch.Tensor, n: int) -> torch.Tensor:
        """Advance ``grid`` by ``n`` generations; consumes ``grid``."""
        if n <= 0:
            return grid
        spare = self._spare
        if (spare is None or spare.shape != grid.shape
                or spare.device != grid.device
                or spare.data_ptr() == grid.data_ptr()):
            spare = torch.empty_like(grid)
        grid, self._spare = self._evolve(grid, n, spare)
        return grid

    def fetch(self, grid: torch.Tensor) -> np.ndarray:
        """The grid as a host uint8 0/1 array, unpacked on the device a
        block of rows at a time."""
        if not self.bitpacked:
            return grid.cpu().numpy().copy()
        rows, nw = grid.shape
        out = np.empty((rows, nw * bitlife.WORD), dtype=np.uint8)
        step = max(1, _FETCH_WORDS // nw)
        for r0 in range(0, rows, step):
            out[r0:r0 + step] = bitlife.unpack(grid[r0:r0 + step]).cpu().numpy()
        return out

    def tiles(self, grid: torch.Tensor):
        """Snapshot tiles ``(pid, tile, r0, c0)``: one device, one tile."""
        return [(0, self.fetch(grid), 0, 0)]

    def population(self, grid: torch.Tensor) -> int:
        """Live cells, counted on the device."""
        if not self.bitpacked:
            return int(grid.sum(dtype=torch.int64).item())
        return bitlife.population(grid)


def build_engine(config: GolConfig, device=None, depths=None) -> Engine:
    """The engine for ``config`` on ``device`` (the GPU when None).
    ``depths``: the pass depths that will run (default 1..comm_every);
    each must be one the chosen kernel serves."""
    dev = resolve_device(device)
    kind = select_engine(config)
    kernel_id, _, refusal = KERNELS[kind]
    if depths is None:
        depths = range(1, config.comm_every + 1)
    depths = [k for k in depths if k > 0]
    shape = (config.rows, config.cols)
    for k in depths:
        reason = refusal(shape, config.rule, k, config.boundary)
        if reason:
            raise ConfigError(f"kernel {kernel_id} cannot run {config.rule} "
                              f"at depth {k} on a {shape[0]}x{shape[1]} "
                              f"grid: {reason}")
    return Engine(config, dev, kind, depths)


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
