"""The engine on a device mesh larger than (1, 1): the mesh half of
``mpi_tpu.backends.tpu.Engine``.

One process drives every shard (the reference's ``--mesh``).  The grid is
a (mi, mj) nested list of shard tensors, each on its mesh device; a step
runs ``parallel/step.py``'s sharded stepper of the engine's kind, whose
every local launch is the engine's kernel (K1, K3 or K2), and a periodic
padded grid's seam band is stitched across the first and last shard
columns (``parallel/seam.py:make_mesh_seam_stepper``).  ``build_engine``
(``backends/cuda.py``) plans it and builds it.

Under a process group (``parallel/dist.py``, ``--multihost``) the mesh
spans the ranks and a grid holds this rank's shards only, None in the
place of every other rank's: the engine builds, loads, steps, writes and
counts the local shards, and ``fetch`` returns None, as the reference's
does under ``jax.process_count() > 1``.

What the serve layer calls on an engine beyond one run's (``step_batched``,
windows, batches) is ROADMAP item 19, serving and tuning on a mesh, and
raises :class:`ConfigError` here.
"""

from __future__ import annotations

import threading
import time
from typing import List

import numpy as np
import torch

from mpi_tpu_torch.config import WORD, ConfigError, GolConfig
from mpi_tpu_torch.ops import bitlife, cuda_bitltl, cuda_stencil
from mpi_tpu_torch.parallel import seam, step
from mpi_tpu_torch.parallel.mesh import Mesh

SERVING_ITEM = ("serving, batches and windows on a device mesh are "
                "ROADMAP item 19, serving and tuning on a mesh")


def chunk_gens(kind: str, rule, depths) -> List[int]:
    """The gens of every kernel launch a pass of each depth in ``depths``
    makes: K1 one launch of k, K3 chunks of <= ⌊8/r⌋, K2 chunks of
    <= ⌊16/r⌋."""
    top = {"bit": 16, "ltl": cuda_bitltl.max_gens(rule.radius),
           "dense": max(1, cuda_stencil.MAX_DEPTH // rule.radius)}[kind]
    out = set()
    for k in depths:
        full, rem = divmod(k, top)
        if full:
            out.add(top)
        if rem:
            out.add(rem)
    return sorted(out)


class MeshEngine:
    """The stepper for one configuration on a mesh of more than one shard:
    packed int32 words (``bitpacked``, engines "bit" and "ltl") or uint8
    cells ("dense") in every shard.  Grid state lives outside the engine:
    ``step`` takes a grid (the nested shard list) and returns the next,
    whose shards are new tensors (or views of them); callers replace their
    grid with it, as with the one-device engine.  No pass writes into the
    grid it was given."""

    def __init__(self, config: GolConfig, mesh: Mesh, kind: str, kernel,
                 kernel_id: str, depths, cols_eff: int, pad_bits: int,
                 overlap: bool, notes=()):
        self.config = config
        self.mesh = mesh
        self.mi, self.mj = mesh.dims
        i0, j0 = mesh.local_shards()[0]
        self.device = mesh.devices[i0][j0]
        self.kind = kind
        self.kernel_id = kernel_id
        self.bitpacked = kind != "dense"
        self.depths = sorted(set(depths)) or [1]
        self.depth = config.comm_every
        self.cols_eff = cols_eff
        self.pad_bits = pad_bits
        self.col_limit = config.cols if pad_bits else None
        self.overlap = overlap
        self.notes = tuple(notes)
        self.sparse_plan = None
        # every pass writes new shard tensors and never into its input:
        # no ping-pong pair to keep (the verifier holds it to that)
        self.donates_input = False
        self.seam = pad_bits > 0 and config.boundary == "periodic"
        self._kernel = kernel
        rule, boundary = config.rule, config.boundary
        if kind == "bit":
            inner = step.make_sharded_bit_stepper(
                mesh, rule, boundary, gens_per_exchange=config.comm_every,
                overlap=overlap, pad_bits=pad_bits, seam_pad=self.seam,
                kernel=kernel)
        elif kind == "ltl":
            inner = step.make_sharded_ltl_stepper(
                mesh, rule, boundary, gens_per_exchange=config.comm_every,
                overlap=overlap, pad_bits=pad_bits, seam_pad=self.seam,
                kernel=kernel)
        else:
            inner = step.make_sharded_stepper(
                mesh, rule, boundary, gens_per_exchange=config.comm_every,
                overlap=overlap, kernel=kernel)
        if self.seam:
            # inner(shards, k) with k <= comm_every runs one pass of k
            self._evolve = seam.make_mesh_seam_stepper(
                inner, rule, config.cols, config.comm_every, mesh=mesh)
        else:
            self._evolve = inner
        self._compile_lock = threading.Lock()
        self._compiled = set()
        self.compile_count = 0
        self.compile_wall_s = 0.0

    # -- geometry -------------------------------------------------------

    def _shard_shape(self):
        rows = self.config.rows // self.mi
        cols = self.cols_eff // self.mj
        return rows, (cols // WORD if self.bitpacked else cols)

    def _shard_cells(self):
        return self.config.rows // self.mi, self.cols_eff // self.mj

    def raw_grid(self, grid):
        return grid

    # -- init -----------------------------------------------------------

    def init_grid(self, initial=None, seed=None):
        """A fresh grid on the mesh: the hash init of ``seed`` (default
        config.seed), each shard hashing its own global coordinates, or the
        uint8 0/1 ``initial`` grid, or a region loader ``initial(r0, r1,
        c0, c1)`` read shard by shard (the reference's ``_put_initial``); a
        padded grid's pad starts dead.  Under a process group only the
        local shards are made, and the loader is called once for each."""
        rows = self.config.rows
        if initial is None:
            seed = self.config.seed if seed is None else seed
            if self.bitpacked:
                return step.sharded_bit_init(self.mesh, rows, self.cols_eff,
                                             seed, col_limit=self.col_limit)
            return step.sharded_init(self.mesh, rows, self.cols_eff, seed)
        if not callable(initial):
            arr = np.asarray(initial, dtype=np.uint8)
            if arr.shape != (rows, self.config.cols):
                raise ConfigError(
                    f"initial grid is {arr.shape}, config asks for "
                    f"{(rows, self.config.cols)}")

            def loader(r0, r1, c0, c1):
                return arr[r0:r1, c0:c1]
        else:
            loader = initial
        th, tw = self._shard_cells()
        C = self.config.cols
        out = []
        for i in range(self.mi):
            row = []
            for j in range(self.mj):
                if not self.mesh.is_local(i, j):
                    row.append(None)
                    continue
                r0, c0 = i * th, j * tw
                tile = np.zeros((th, tw), dtype=np.uint8)
                if c0 < C:
                    c1 = min(c0 + tw, C)
                    tile[:, :c1 - c0] = loader(r0, r0 + th, c0, c1)
                dev = self.mesh.devices[i][j]
                if self.bitpacked:
                    words = bitlife.pack_np(tile).view(np.int32)
                    row.append(torch.from_numpy(words).to(dev))
                else:
                    row.append(torch.from_numpy(tile).to(dev))
            out.append(row)
        return out

    # -- build and warm-up ------------------------------------------------

    def warm_up(self) -> None:
        """Build and load the kernel and launch it once at each gens its
        passes launch, on a one-word or one-cell grid (and for a seam grid
        the band's K2 step at its height), so the first timed pass pays no
        build or first-launch setup.  Under a process group each rank warms
        its own cards, and the band only where it is stepped."""
        self._warm(self.depths)

    def _steps_band(self) -> bool:
        """Whether this process steps the seam band: always in one
        process, the owner of shard (0, mj-1) under a group."""
        return self.seam and self.mesh.is_local(0, self.mj - 1)

    def _warm(self, depths) -> None:
        rule = self.config.rule
        dtype = torch.int32 if self.bitpacked else torch.uint8
        for dev in self.mesh.local_devices():
            if dev.type != "cuda":
                continue
            for g in chunk_gens(self.kind, rule, depths):
                tiny = torch.zeros((1, 1), dtype=dtype, device=dev)
                self._kernel(tiny, rule, "dead", gens=g)
        if self._steps_band():
            # on the first shard's device: in a group the root's one
            # device, which holds shard (0, mj-1)
            for k in depths:
                # the seam's index tensors, made before the first pass
                seam.seam_plan(self.config.cols, k * rule.radius,
                                str(self.device))
                seam.step_band(torch.zeros(
                    (self.config.rows, 4 * k * rule.radius),
                    dtype=torch.uint8, device=self.device), rule, k)

    def ensure_compiled(self, grid, n: int) -> None:
        """Warm every launch a step of ``n`` generations makes, once per
        ``n`` (counted in ``compile_count``, timed in ``compile_wall_s``)."""
        if n <= 0 or n in self._compiled:
            return
        from mpi_tpu_torch.utils.segmenting import segment_depths

        with self._compile_lock:
            if n in self._compiled:
                return
            t0 = time.perf_counter()
            self._warm(sorted(segment_depths([n], self.depth)))
            self.sync()
            self._compiled.add(n)
            self.compile_count += 1
            self.compile_wall_s += time.perf_counter() - t0

    def sync(self) -> None:
        """Wait for every card of the mesh this process holds: closes every
        timed region."""
        for dev in self.mesh.local_devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- stepping -------------------------------------------------------

    def step(self, grid, n: int):
        """Advance ``grid`` by ``n`` generations; consumes ``grid``."""
        if n <= 0:
            return grid
        return self._evolve(grid, n)

    def step_units(self, grid, n: int):
        for _ in range(max(0, int(n))):
            grid = self.step(grid, 1)
        return grid

    def _serving(self, *args, **kwargs):
        raise ConfigError(SERVING_ITEM)

    step_batched = step_batched_units = batched_stepper = _serving
    init_grids = stack_grids = unstack_grids = _serving
    ensure_compiled_batched = fetch_batched = population_batched = _serving
    fetch_window = write_window = _serving

    # -- reads ----------------------------------------------------------

    def _cells(self, shard: torch.Tensor) -> np.ndarray:
        cells = bitlife.unpack(shard) if self.bitpacked else shard
        return cells.cpu().numpy()

    def tiles(self, grid):
        """Snapshot tiles ``(pid, tile, r0, c0)``, one a shard this process
        holds (the reference writes ``processes = mi·mj`` tiles, each host
        its addressable ones), pid row-major over the whole mesh; a padded
        grid's tiles crop to the real width and a shard wholly in the pad
        writes none."""
        th, tw = self._shard_cells()
        out = []
        for i, j in self.mesh.local_shards():
            c0 = j * tw
            if self.col_limit is not None and c0 >= self.col_limit:
                continue
            tile = self._cells(grid[i][j])
            if self.col_limit is not None:
                tile = tile[:, :self.col_limit - c0]
            out.append((i * self.mj + j, tile, i * th, c0))
        return out

    def shard_snapshots(self, grid):
        return [(r0, c0, tile) for _pid, tile, r0, c0 in self.tiles(grid)]

    def fetch(self, grid):
        """The grid as a host uint8 0/1 array cropped to the real width
        (None under a process group, where no process holds the whole
        grid: the snapshot tiles are its output)."""
        if self.mesh.multiprocess:
            return None
        rows = [np.concatenate([self._cells(s) for s in row], axis=1)
                for row in grid]
        return np.concatenate(rows, axis=0)[:, :self.config.cols]

    def gather(self, grid) -> torch.Tensor:
        """The whole grid as one tensor on the first shard's device, in
        the engine's layout (packed words at the padded width, or cells):
        the single-device engine's grid, for comparing the two on the
        device.  Raises under a process group."""
        if self.mesh.multiprocess:
            raise ConfigError("gather: under a process group no process "
                              "holds the whole grid (write its tiles)")
        return torch.cat([torch.cat([s.to(self.device) for s in row], 1)
                          for row in grid], 0)

    def population(self, grid) -> int:
        """Live cells, counted shard by shard on its device (the pad is
        always dead); under a process group, of this process's shards."""
        total = 0
        for row in grid:
            for s in row:
                if s is None:
                    continue
                total += (bitlife.population(s) if self.bitpacked
                          else int(s.sum(dtype=torch.int64).item()))
        return total
