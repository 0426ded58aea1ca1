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

The serve layer's surfaces are the one-device engine's
(``backends/cuda.py:Engine``), as the reference's one ``Engine`` carries
them on every mesh.  A batch of B boards is one (B, h, w) tensor a shard
(``stack_grids``): the exchange, the windows and the seam take the board
axis (``parallel/step.py``), so ``step_batched`` launches one kernel a
shard a pass for all B boards, where the reference vmaps the sharded
step.  ``fetch_window`` copies only the shards a viewport meets, cropped
on the device, one transfer each; ``write_window`` edits only the shards a
patch meets, in place, and leaves the pad dead; ``shard_snapshots`` gives
the checkpoint's tiles.  Under a process group the window reads and
writes and ``fetch_batched`` answer None, and ``stack_grids`` and
``step_batched`` raise ConfigError: the group's seam path has no board
axis, and the reference serves no batch under several processes.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from mpi_tpu_torch.backends.cuda import ServeSurface
from mpi_tpu_torch.config import WORD, ConfigError, GolConfig
from mpi_tpu_torch.ops import bitlife, cuda_bitltl, cuda_stencil
from mpi_tpu_torch.parallel import seam, step
from mpi_tpu_torch.parallel.mesh import Mesh

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


class MeshEngine(ServeSurface):
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
        self._init_serving()
        self.blocks = None   # the CTA tile build_mesh_engine built, if any

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

    def warm_up(self, boards: int = 0) -> None:
        """Build and load the kernel and launch it once at each gens its
        passes launch, on a one-word or one-cell grid (and for a seam grid
        the band's one launch on a one-row block), so the first timed pass
        pays no build or first-launch setup.  Under a process group each
        rank warms its own cards, and the band only where it is stepped.  A
        batch of ``boards`` launches the same kernels, so it warms nothing
        more."""
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
                words, width = seam.seam_block(self.config.cols,
                                               k * rule.radius)
                tiny = torch.zeros((1, len(words)), dtype=torch.int32,
                                   device=self.device)
                seam.fused_band(tiny, torch.zeros_like(tiny), rule, width, k)

    def _warm_step(self, n: int, boards: int) -> None:
        # a batch launches the kernels a solo step does, on a board axis
        from mpi_tpu_torch.utils.segmenting import segment_depths

        self._warm(sorted(segment_depths([n], self.depth)))

    def _batch_width(self, grids):
        return _boards(grids) or None

    def sparse_stats(self, grid):
        """None: a mesh engine never steps sparsely."""
        return None

    def sync(self) -> None:
        """Wait for every card of the mesh this process holds: closes every
        timed region."""
        for dev in self.mesh.local_devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def block_until_ready(self, grid):
        """Wait until the launches queued so far on this thread's stream of
        every card of the mesh, those that produce ``grid`` among them,
        have run; returns ``grid``.  A no-op on the CPU."""
        for dev in self.mesh.local_devices():
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
                event.synchronize()
        return grid

    # -- stepping -------------------------------------------------------

    def step(self, grid, n: int):
        """Advance ``grid`` by ``n`` generations; consumes ``grid``."""
        if n <= 0:
            return grid
        if self.fault_hook is not None:
            # before any launch: an injected failure leaves the grid intact
            self.fault_hook("step")
        self.step_calls += 1
        return self._evolve(grid, n)

    # -- batches --------------------------------------------------------

    def stack_grids(self, grids):
        """One batch from B grids of this engine: each shard a (B, h, w)
        tensor on its device, board b's shard at index b.  Refused under a
        process group."""
        self._no_group_batch()
        grids = list(grids)
        return [[None if s is None else
                 torch.stack([g[i][j] for g in grids])
                 for j, s in enumerate(row)]
                for i, row in enumerate(grids[0])]

    def unstack_grids(self, batched) -> list:
        """The B grids of a stacked batch, each shard in a buffer of its
        own."""
        return [[[None if s is None else s[b].clone() for s in row]
                 for row in batched] for b in range(_boards(batched))]

    def step_batched(self, grids, n: int):
        """Advance every board of a stacked batch by ``n`` generations: one
        kernel launch a shard a window a pass for all B boards, as many as
        a solo step makes; consumes ``grids``.  Refused under a process
        group."""
        self._no_group_batch()
        if n <= 0:
            return grids
        if step.first_shard(grids).dim() != 3:
            raise ValueError(f"a batch is (B, rows, cols) a shard, got "
                             f"{tuple(step.first_shard(grids).shape)}")
        if self.fault_hook is not None:
            self.fault_hook("batched")
        self.batched_step_calls += 1
        return self._evolve(grids, n)

    def _no_group_batch(self) -> None:
        if self.mesh.multiprocess:
            raise ConfigError("a stacked batch runs on a mesh of one "
                              "process; this mesh spans a process group")

    def fetch_batched(self, grids) -> list:
        """Each board of a stacked batch as a host array cropped to the
        real width (None under a process group)."""
        if self.mesh.multiprocess:
            return None
        return [self.fetch([[s[b] for s in row] for row in grids])
                for b in range(_boards(grids))]

    def population_batched(self, grids) -> List[int]:
        """Live cells of each board of a stacked batch: one reduction a
        shard on its device, B counts a shard to the host."""
        total = np.zeros(_boards(grids), dtype=np.int64)
        for row in grids:
            for s in row:
                if s is None:
                    continue
                cells = bitlife.popcount(s) if self.bitpacked else s
                total += cells.sum(dim=(1, 2), dtype=torch.int64).cpu().numpy()
        return [int(v) for v in total]

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
        """``[(r0, c0, tile), ...]``: the checkpoint's tiles, one a shard
        this process holds, each fetched alone (never the whole board)."""
        return [(r0, c0, tile) for _pid, tile, r0, c0 in self.tiles(grid)]

    def _meets(self, r0: int, c0: int, h: int, w: int):
        """For each local shard the window ``[r0, r0+h) x [c0, c0+w)`` of
        the real board meets: ``(i, j, rows, units, off, out_rows,
        out_cols)``, the shard's rows and word (or cell) columns to slice,
        the first cell column in that slice, and where the piece lands in
        the window."""
        rows, cols = self.config.rows, self.config.cols
        if not (h > 0 and w > 0 and 0 <= r0 and r0 + h <= rows
                and 0 <= c0 and c0 + w <= cols):
            raise ValueError(f"window [{r0}:{r0 + h}, {c0}:{c0 + w}] is not "
                             f"on the {rows}x{cols} board")
        th, tw = self._shard_cells()
        for i, j in self.mesh.local_shards():
            sr0, sc0 = i * th, j * tw
            ir0, ir1 = max(r0, sr0), min(r0 + h, sr0 + th)
            ic0, ic1 = max(c0, sc0), min(c0 + w, sc0 + tw)
            if ir0 >= ir1 or ic0 >= ic1:
                continue
            lc0, lc1 = ic0 - sc0, ic1 - sc0
            if self.bitpacked:
                units = slice(lc0 // WORD, -(-lc1 // WORD))
                off = lc0 - units.start * WORD
            else:
                units, off = slice(lc0, lc1), 0
            yield (i, j, slice(ir0 - sr0, ir1 - sr0), units, off,
                   slice(ir0 - r0, ir1 - r0), slice(ic0 - c0, ic1 - c0))

    def fetch_window(self, grid, r0: int, c0: int, h: int, w: int,
                     shard_timer=None):
        """The host window ``[r0, r0+h) x [c0, c0+w)`` of the board (uint8
        0/1): only the shards it meets are read, each cropped on its
        device to the rows and words the window covers and copied to the
        host in one transfer; ``shard_timer(dt_s)`` is called once a
        shard.  The window must not wrap.  None under a process group, as
        :meth:`fetch`."""
        if self.mesh.multiprocess:
            return None
        out = np.zeros((h, w), dtype=np.uint8)
        for i, j, rs, units, off, out_r, out_c in self._meets(r0, c0, h, w):
            block = grid[i][j][rs, units]
            n = out_c.stop - out_c.start
            if self.bitpacked:
                block = bitlife.unpack(block)[:, off:off + n]
            t0 = time.perf_counter()
            out[out_r, out_c] = block.to("cpu", copy=True).numpy()
            if shard_timer is not None:
                shard_timer(time.perf_counter() - t0)
        return out

    def write_window(self, grid, r0: int, c0: int, patch):
        """``grid`` with the uint8 0/1 ``patch`` written at ``(r0, c0)``:
        only the shards the patch meets are edited, in place on their
        devices, and on a packed grid only the words it covers (read,
        changed, written back), so the pad bits stay zero.  The patch must
        not wrap.  None under a process group, where the caller re-inits
        the board."""
        if self.mesh.multiprocess:
            return None
        patch = np.asarray(patch, dtype=np.uint8)
        h, w = patch.shape
        for i, j, rs, units, off, out_r, out_c in self._meets(r0, c0, h, w):
            shard = grid[i][j]
            cells = torch.from_numpy(
                np.ascontiguousarray(patch[out_r, out_c])).to(shard.device)
            if not self.bitpacked:
                shard[rs, units] = cells
                continue
            block = bitlife.unpack(shard[rs, units])
            block[:, off:off + cells.shape[1]] = cells
            shard[rs, units] = bitlife.pack(block)
        return grid

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


def _boards(grids) -> int:
    """B of a stacked batch on a mesh (its first local shard's board axis),
    0 for a solo grid."""
    x = step.first_shard(grids)
    return int(x.shape[0]) if x.dim() == 3 else 0
