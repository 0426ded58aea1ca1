"""Sharded evolution over a device mesh: the port's ``mpi_tpu.parallel.step``.

A grid on a mesh is a (mi, mj) nested list of shard tensors, each on its
mesh device and each its own tensor (no views into one global buffer), so
the same code is right when the shards sit on different cards.  A pass of
k generations exchanges the halo (``parallel/halo.py``) and steps every
shard's halo-extended tile with its engine's kernel at a dead boundary:
K1 (``ops/cuda_bitlife.py``) for the SWAR stepper, K3
(``ops/cuda_bitltl.py``, in chunks of <= ``max_gens(r)`` generations) for
the LtL stepper, K2 (``ops/cuda_stencil.py``, in chunks of <= ⌊16/r⌋) for
the dense stepper.  On the card each launch is the kernel; on the CPU the
wrapper runs the kernel's plain version.  There is no other local path.

The reference re-kills, after every generation, the ghost cells that lie
outside a dead global grid (``_kill_outside_global``) and the pad columns
of a padded packed grid (``_mask_pad_cols``).  A kernel pass of k
generations cannot stop between generations, so the two masks take these
forms here, with the same grid:

* a ghost that would lie outside a dead global grid is left off
  (``exchange_halo_rc(..., drop_dead=True)``): the edge shard's extended
  tile ends at the global edge, and the kernel's own dead boundary is the
  global one (``parallel/halo.py:ghost_depths`` gives the ghost depths a
  shard keeps, for the exchange and the crop alike);
* the pad is the kernel's ``col_limit``, in the window's local columns
  (:func:`_mask_pad_cols`); words wholly in the pad are cut off the
  window, and a window with no real cell is not stepped.

``overlap=True`` is the reference's stitched-band body: the tile interior
steps k generations from the shard's own data (dead fill), then only the
d-deep edge bands (d = k for SWAR, k·r otherwise) are recomputed from the
exchanged halo, each by the kernel on its band, and written over the
interior's invalid fringe.  The grid is bit-identical to the plain
body's; its launches are five a shard a pass instead of one.

A shard may be a (B, h, w) batch of boards (``MeshEngine.step_batched``,
the serve layer's coalesced rounds): the exchange fills every board's
ghosts in the same copies and each window is one launch for all B boards,
since K1-K3 take a board axis, so a batched pass launches as many kernels
as a solo one.

Under a process group (``Mesh.multiprocess``) a grid holds this rank's
shards only, None in every other rank's place; a pass steps the local
shards, and the exchange brings the ghosts the other ranks hold
(``parallel/halo.py``).  The inits build the local shards only: the hash
init reads global coordinates, so each rank makes its own with no
communication.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mpi_tpu_torch.config import WORD
from mpi_tpu_torch.models.rules import Rule
from mpi_tpu_torch.ops import bitlife, cuda_bitlife, cuda_bitltl, cuda_stencil
from mpi_tpu_torch.parallel.halo import (
    Shards, exchange_halo, exchange_halo_rc, ghost_depths,
)
from mpi_tpu_torch.parallel.mesh import AXES, Mesh
from mpi_tpu_torch.utils.hashinit import init_tile_torch


def first_shard(shards: Shards) -> torch.Tensor:
    """The first shard this process holds (every shard has its shape)."""
    return next(s for row in shards for s in row if s is not None)


def mesh_evolve(local, K: int):
    """evolve(shards, steps) -> shards: ``steps // k`` passes of
    ``local(shards, k)`` (k = min(K, steps)) and one remainder pass, the
    reference's ``segmented_evolve`` plan."""

    def evolve(shards: Shards, steps: int) -> Shards:
        k = max(1, min(K, steps))
        full, rem = divmod(steps, k)
        for _ in range(full):
            shards = local(shards, k)
        if rem:
            shards = local(shards, rem)
        return shards

    return evolve


def _mask_pad_cols(first_word: int, words: int, col_limit: Optional[int]):
    """The pad of a window of ``words`` packed words whose first word is
    global word ``first_word``, against the grid's real width
    ``col_limit`` (global cells; None: no pad): (live words, local
    col_limit).  Live words are the window's first words that hold a real
    cell; the local col_limit is None when no live word holds pad.  A
    window before global word 0 (a periodic seam grid's left wrap ghost)
    counts as real, as the reference's global-column mask does."""
    if col_limit is None:
        return words, None
    real = col_limit - first_word * WORD
    if real >= words * WORD:
        return words, None
    if real <= 0:
        return 0, None
    live = -(-real // WORD)
    return live, real


class _Local:
    """One engine's local step on a window of a shard: k generations at a
    dead boundary by the kernel, in chunks of at most ``chunk``, with a
    padded grid's ``col_limit`` in the window's own columns."""

    def __init__(self, kernel: Callable, rule: Rule, chunk: int,
                 packed: bool, col_limit: Optional[int]):
        self.kernel, self.rule, self.chunk = kernel, rule, chunk
        self.packed, self.col_limit = packed, col_limit

    def _launch(self, x, k, limit):
        left = k
        while left > 0:
            g = min(left, self.chunk)
            if self.packed:
                x = self.kernel(x, self.rule, "dead", gens=g, col_limit=limit)
            else:
                x = self.kernel(x, self.rule, "dead", gens=g)
            left -= g
        return x

    def __call__(self, x: torch.Tensor, k: int, first_col: int):
        """k generations of the contiguous window ``x``, whose column 0 is
        global column unit ``first_col`` (a word, or a cell when dense)."""
        if not self.packed:
            return self._launch(x, k, None)
        live, limit = _mask_pad_cols(first_col, x.shape[-1], self.col_limit)
        if live == x.shape[-1]:
            return self._launch(x, k, limit)
        out = torch.zeros_like(x)
        if live:
            out[..., :live] = self._launch(x[..., :live].contiguous(), k,
                                           limit)
        return out


def _stepper(mesh: Mesh, boundary: str, local: _Local,
             rows_depth: Callable[[int], int],
             cols_depth: Callable[[int], int],
             band_units: Callable[[int], int],
             fits: Callable[[int, int, int], bool], axes=AXES,
             width_multiple: int = 1) -> Callable:
    """The pass ``local_step(shards, k)`` the three steppers share.

    ``rows_depth(k)``/``cols_depth(k)``: the ghost rows and ghost column
    units a pass of k exchanges; ``band_units(k)``: the tile column units a
    lateral band takes beside its ghost (the reference's band widths);
    ``fits(h, w, k)``: whether the stitched-band body serves the pass;
    ``width_multiple``: the extended tiles' width is padded with zero
    columns to a multiple of it (K2 moves rows of a multiple of 16 cells
    in 16-byte pieces).

    A shard the exchange-all body returns is a view of its kernel's
    output (its rows and columns of the extended tile), so the pass copies
    each shard once, into its extended tile; the overlap body's interior
    launch takes the shard contiguous."""
    dims = mesh.dims
    periodic = boundary == "periodic"

    shards_here = mesh.local_shards()

    def body_exchange_all(shards, k):
        dr, dc = rows_depth(k), cols_depth(k)
        ext = exchange_halo_rc(shards, dr, dc, boundary, axes,
                               drop_dead=True, width_multiple=width_multiple,
                               mesh=mesh)
        out = [[None] * dims[1] for _ in range(dims[0])]
        for i, j in shards_here:
            h, w = shards[i][j].shape[-2:]
            t, _, l, _ = ghost_depths(dims, i, j, dr, dc, periodic)
            y = local(ext[i][j], k, j * w - l)
            out[i][j] = y[..., t:t + h, l:l + w]
        return out

    def body_overlap(shards, k):
        dr, dc, bu = rows_depth(k), cols_depth(k), band_units(k)
        # the interiors first: k generations from each shard's own data,
        # independent of the exchange below; rows [d, h-d) and columns
        # [dc, w-dc) of each are exact
        out = [[None if s is None else local(s.contiguous(), k,
                                             j * s.shape[-1])
                for j, s in enumerate(row)] for row in shards]
        ext = exchange_halo_rc(shards, dr, dc, boundary, axes,
                               drop_dead=True, width_multiple=width_multiple,
                               mesh=mesh)
        for i, j in shards_here:
            h, w = shards[i][j].shape[-2:]
            t, _, l, _ = ghost_depths(dims, i, j, dr, dc, periodic)
            x, q = ext[i][j], out[i][j]
            c0 = j * w - l
            # edge bands from the exchanged halo, full cross extent so
            # corners are exact; every kept cell lies d from each side
            # of its band that is not the global edge
            top = local(x[..., :t + 3 * dr, :].contiguous(), k, c0)
            q[..., :dr, :] = top[..., t:t + dr, l:l + w]
            s0 = max(0, t + h - 3 * dr)
            bot = local(x[..., s0:, :].contiguous(), k, c0)
            q[..., h - dr:, :] = bot[..., t + h - dr - s0:t + h - s0,
                                     l:l + w]
            left = local(x[..., :l + bu].contiguous(), k, c0)
            q[..., :dc] = left[..., t:t + h, l:l + dc]
            wr = min(bu, l + w)
            e0 = l + w - wr
            right = local(x[..., e0:].contiguous(), k, c0 + e0)
            q[..., w - dc:] = right[..., t:t + h, wr - dc:wr]
        return out

    def local_step(shards, k):
        h, w = first_shard(shards).shape[-2:]
        if fits(h, w, k):
            return body_overlap(shards, k)
        return body_exchange_all(shards, k)

    return local_step


def _check_birth(K: int, rule: Rule) -> None:
    if K > 1 and 0 in rule.birth:
        raise ValueError("gens_per_exchange > 1 requires a rule without "
                         "birth-on-0")


def _check_pad(pad_bits: int, boundary: str, seam_pad: bool) -> None:
    if pad_bits and boundary == "periodic" and not seam_pad:
        raise ValueError(
            "pad_bits with the periodic boundary is only correct under "
            "the seam-stitching wrapper (parallel.seam); pass seam_pad=True"
        )


def _packed_col_limit(mesh: Mesh, tile_words: int, pad_bits: int):
    """The real width in cells of a padded packed grid of ``tile_words``
    words a shard (None when nothing is padded)."""
    if not pad_bits:
        return None
    return mesh.dims[1] * tile_words * WORD - pad_bits


def make_sharded_stepper(mesh: Mesh, rule: Rule, boundary: str, axes=AXES,
                         gens_per_exchange: int = 1, overlap: bool = False,
                         kernel: Callable = cuda_stencil.cuda_dense_step):
    """evolve(shards, steps) of the dense uint8 grid over the mesh: one
    k·r-deep exchange feeds k generations of K2 on each extended tile (in
    chunks of ⌊16/r⌋ where k·r exceeds K2's halo).  ``overlap``: the
    stitched-band body where the tile holds its bands (min(h, w) >=
    2·k·r)."""
    K = gens_per_exchange
    r = rule.radius
    if K < 1:
        raise ValueError(f"gens_per_exchange must be >= 1, got {K}")
    _check_birth(K, rule)
    local = _Local(kernel, rule, max(1, cuda_stencil.MAX_DEPTH // r),
                   packed=False, col_limit=None)
    return mesh_evolve(_stepper(
        mesh, boundary, local,
        rows_depth=lambda k: k * r, cols_depth=lambda k: k * r,
        band_units=lambda k: 3 * k * r,
        fits=lambda h, w, k: overlap and min(h, w) >= 2 * k * r,
        axes=axes, width_multiple=16), K)


def make_halo_probe(mesh: Mesh, boundary: str, radius: int = 1, axes=AXES):
    """A function that performs ONE ghost-ring exchange of its shards and
    nothing else, returning each shard's ghost-extended tile: the probe
    the collective-latency policy (``parallel/policy.py``) times.  Under a
    process group it is a collective: every rank calls it on its own
    shards (None elsewhere)."""

    def probe(shards: Shards) -> Shards:
        return exchange_halo(shards, radius, boundary, axes, mesh=mesh)

    return probe


def make_sharded_bit_stepper(
    mesh: Mesh, rule: Rule, boundary: str, axes=AXES,
    gens_per_exchange: int = 1, overlap: bool = False, pad_bits: int = 0,
    seam_pad: bool = False, kernel: Callable = cuda_bitlife.cuda_bit_step,
):
    """evolve(shards, steps) of the packed (rows, words) grid, radius-1
    rules: one exchange of k ghost rows and a single ghost word column (32
    halo bits cover any k <= 16) feeds k generations of K1 on each
    extended tile.

    ``overlap``: the stitched-band body where the tile holds its bands (h
    >= 2k rows, >= 2 words); its lateral bands are the ghost word and two
    tile words.  ``pad_bits`` > 0: the grid was padded with that many
    trailing dead cell columns; every window a kernel steps carries its
    ``col_limit``, and k > 1 takes the exchange-all body, as the
    reference's does.  ``seam_pad`` permits ``pad_bits`` with the periodic
    boundary, under ``parallel/seam.py:make_mesh_seam_stepper`` only: the
    column wrap then reads the pad, zeros, and the wrapper recomputes the
    seam columns."""
    K = gens_per_exchange
    if rule.radius != 1:
        raise ValueError("bitpacked sharded stepper supports radius-1 rules "
                         "only")
    if not 1 <= K <= cuda_bitlife.MAX_GENS:
        raise ValueError(f"gens_per_exchange must be in 1..16, got {K}")
    _check_birth(K, rule)
    _check_pad(pad_bits, boundary, seam_pad)
    return _packed_stepper(
        mesh, rule, boundary, axes, K, overlap, pad_bits, kernel,
        chunk=cuda_bitlife.MAX_GENS, rows_depth=lambda k: k, band_words=2)


def make_sharded_ltl_stepper(
    mesh: Mesh, rule: Rule, boundary: str, axes=AXES,
    gens_per_exchange: int = 1, overlap: bool = False, pad_bits: int = 0,
    seam_pad: bool = False, kernel: Callable = cuda_bitltl.cuda_ltl_step,
):
    """evolve(shards, steps) of the packed grid for a radius-r rule (2..7),
    the LtL form of :func:`make_sharded_bit_stepper`: one exchange of
    d = k·r ghost rows and a single ghost word column (k·r <= 31) feeds k
    generations of K3, in chunks of <= ``max_gens(r)``, on each extended
    tile.  Lateral overlap bands are the ghost word and three tile words;
    ``pad_bits`` and ``seam_pad`` as for the radius-1 stepper."""
    K = gens_per_exchange
    r = rule.radius
    if K < 1 or K * r > 31:
        raise ValueError(
            f"gens_per_exchange must satisfy 1 <= K and K*r <= 31 "
            f"(one ghost word column), got K={K}, r={r}"
        )
    _check_birth(K, rule)
    _check_pad(pad_bits, boundary, seam_pad)
    return _packed_stepper(
        mesh, rule, boundary, axes, K, overlap, pad_bits, kernel,
        chunk=cuda_bitltl.max_gens(r), rows_depth=lambda k: k * r,
        band_words=3)


def _packed_stepper(mesh, rule, boundary, axes, K, overlap, pad_bits,
                    kernel, chunk, rows_depth, band_words):
    passes = {}

    def pass_(shards, k):
        # the col_limit follows the shards' width, known at the first pass
        tw = first_shard(shards).shape[-1]
        if tw not in passes:
            local = _Local(kernel, rule, chunk, packed=True,
                           col_limit=_packed_col_limit(mesh, tw, pad_bits))
            passes[tw] = _stepper(
                mesh, boundary, local, rows_depth=rows_depth,
                cols_depth=lambda k: 1, band_units=lambda k: band_words,
                fits=lambda h, w, k: (overlap and h >= 2 * rows_depth(k)
                                      and w >= 2
                                      and not (pad_bits and k > 1)),
                axes=axes)
        return passes[tw](shards, k)

    return mesh_evolve(pass_, K)


def sharded_bit_init(mesh: Mesh, rows: int, cols: int, seed: int,
                     axes=AXES, col_limit=None) -> Shards:
    """The packed grid, each shard hashing and packing its own global
    coordinates on its device blockwise (decomposition-invariant); under
    a process group the local shards only (None elsewhere).
    ``col_limit``: global columns >= this start dead (the pad)."""
    mi, mj = mesh.dims
    if rows % mi or cols % mj or (cols // mj) % WORD:
        raise ValueError(
            f"mesh {mesh.shape} incompatible with packed grid {rows}x{cols} "
            f"(per-shard cols must be a multiple of {WORD})"
        )
    lr, lc = rows // mi, cols // mj
    return [[bitlife.init_packed(lr, lc, seed, row_offset=i * lr,
                                 col_offset=j * lc, col_limit=col_limit,
                                 device=mesh.devices[i][j])
             if mesh.is_local(i, j) else None
             for j in range(mj)] for i in range(mi)]


def sharded_init(mesh: Mesh, rows: int, cols: int, seed: int, axes=AXES,
                 block_rows: int = 1024) -> Shards:
    """The dense grid, each shard hashing its own global coordinates on its
    device, a block of rows at a time: no host-side global array; under a
    process group the local shards only (None elsewhere)."""
    mi, mj = mesh.dims
    if rows % mi or cols % mj:
        raise ValueError(f"mesh {mesh.shape} does not divide grid "
                         f"{rows}x{cols}")
    lr, lc = rows // mi, cols // mj

    def tile(i, j):
        dev = mesh.devices[i][j]
        out = torch.empty((lr, lc), dtype=torch.uint8, device=dev)
        for r0 in range(0, lr, block_rows):
            n = min(block_rows, lr - r0)
            out[r0:r0 + n] = init_tile_torch(n, lc, seed, i * lr + r0,
                                             j * lc, device=dev)
        return out

    return [[tile(i, j) if mesh.is_local(i, j) else None
             for j in range(mj)] for i in range(mi)]


def make_sharded_unpacker(mesh: Mesh, axes=AXES):
    """unpack(shards) -> the uint8 cells of every packed shard, shard by
    shard on its device (None stays None)."""

    def unpack(shards: Shards) -> Shards:
        return [[None if s is None else bitlife.unpack(s) for s in row]
                for row in shards]

    return unpack


def sharded_unpack(mesh: Mesh, packed: Shards, axes=AXES) -> Shards:
    return make_sharded_unpacker(mesh, axes)(packed)
