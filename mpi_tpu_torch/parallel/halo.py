"""Ghost-cell (halo) exchange between the shards of a mesh: the port's
``mpi_tpu.parallel.halo``.

The reference runs ``lax.ppermute`` ring shifts inside ``shard_map``; one
process here holds every shard's tensor, so a ppermute is a set of slice
copies: each shard's edge slab is copied into its neighbour's ghost
region, device to device when the two sit on different cards.  The order
is the reference's: rows first, then columns on the row-extended array,
so the corner blocks travel diagonally in two phases.  Under a process
group (``Mesh.multiprocess``) each rank holds its own shards only, and a
ghost block whose source shard is another rank's travels as a message of
one batch (``parallel/dist.py:exchange``); copies between a rank's own
shards stay slice copies.

Dead boundary: the pairs that would cross the global edge are missing,
and their ghosts arrive as zeros, as a ppermute delivers them.  Periodic
closes the ring; a 1-wide mesh axis wraps onto itself (no copy between
shards, no record).  The steppers (``parallel/step.py``) ask for the
dead-edge ghosts to be left off instead (``drop_dead``): their kernels'
own dead boundary is then the global one.

While the launch verifier's recorder is armed (``ops/_launch.py:arm``),
each ppermute is recorded: the mesh axis, its (src, dst) pairs of axis
positions and the slab's shape (``record_exchange``), which
``ir-collective`` holds to a bijection, a closed ring when periodic and
one of :func:`expected_slab_depths`.
"""

from __future__ import annotations

from typing import List

import torch

from mpi_tpu_torch.ops._launch import record_exchange
from mpi_tpu_torch.parallel.mesh import AXES

Shards = List[List[torch.Tensor]]


def axis_pairs(n: int, periodic: bool):
    """The (src, dst) pairs of the two shifts along an axis of n shards:
    forward (each shard's last slab to the next shard's before-ghost) and
    backward (its first slab to the previous shard's after-ghost)."""
    fwd = [(k, k + 1) for k in range(n - 1)]
    bwd = [(k, k - 1) for k in range(1, n)]
    if periodic:
        fwd.append((n - 1, 0))
        bwd.append((0, n - 1))
    return fwd, bwd


def _ghost_sources(n: int, periodic: bool):
    """For each axis position, the shard its before-ghost and its
    after-ghost come from ({dst: src} of the forward and backward
    ppermutes): a 1-wide axis wraps onto itself when periodic."""
    fwd, bwd = axis_pairs(n, periodic) if n > 1 else (
        ([(0, 0)], [(0, 0)]) if periodic else ([], []))
    return fwd, bwd, {d: s for s, d in fwd}, {d: s for s, d in bwd}


def expected_slab_depths(radius: int, comm_every: int, packed: bool):
    """The legal thin extents of a halo slab exchanged by one ppermute.

    A stepper that communicates every k-th step (k <= comm_every, since
    segment tails exchange at their own shorter cadence) ships a
    ``k * radius``-deep slab; bitpacked engines additionally exchange a
    single ghost *word* column (depth 1: 32 halo bits cover any K·r <= 31,
    see :func:`exchange_halo_rc`).  The one source of truth the verifier's
    ``ir-collective`` check holds recorded slab shapes to."""
    depths = {k * radius for k in range(1, comm_every + 1)}
    if packed:
        depths.add(1)
    return depths


def ghost_depths(dims, i: int, j: int, radius_rows: int, radius_cols: int,
                 periodic: bool):
    """The (top, bottom, left, right) ghost depths shard (i, j) of a mesh
    of ``dims`` keeps under ``drop_dead``: the full depth on every side
    inside the global grid or across a periodic wrap, 0 on a side past a
    dead global edge.  This is the form the reference's per-generation
    ``_kill_outside_global`` takes here: the ghost it would re-kill is
    left off, and the kernel's own dead boundary is the global one."""
    mi, mj = dims
    rr, rc = radius_rows, radius_cols
    if periodic:
        return rr, rr, rc, rc
    return rr * (i > 0), rr * (i < mi - 1), rc * (j > 0), rc * (j < mj - 1)


def exchange_halo(shards: Shards, radius: int, boundary: str,
                  axes=AXES, drop_dead: bool = False, mesh=None) -> Shards:
    """Every (h, w) shard → (h+2r, w+2r) with its ghost ring filled (a
    (B, h, w) batch of boards a shard → (B, h+2r, w+2r), every board's
    ring in the same copies).  Rows phase then columns phase on the
    row-extended arrays → corners correct."""
    return exchange_halo_rc(shards, radius, radius, boundary, axes,
                            drop_dead=drop_dead, mesh=mesh)


def _extent(s: slice) -> int:
    return s.stop - s.start


def exchange_halo_rc(shards: Shards, radius_rows: int, radius_cols: int,
                     boundary: str, axes=AXES, drop_dead: bool = False,
                     width_multiple: int = 1, mesh=None) -> Shards:
    """:func:`exchange_halo` with independent row/column ghost depths: the
    bitpacked steppers exchange K ghost rows but a single ghost *word*
    column (32 halo bits cover any K·r <= 31).

    Each extended tile is one new tensor on its shard's device, filled by
    one copy of the shard and one of each ghost block: the edge slabs from
    the row and column neighbours, and each corner from the diagonal
    neighbour, which is the block the reference's columns phase carries
    over from the row-extended array.  The ppermutes are recorded as the
    reference's two phases issue them.  A shard may carry a leading board
    axis, (B, h, w): each block then copies every board's slab at once,
    and a recorded slab keeps that axis in front, as a ppermute under the
    reference's ``vmap`` over boards carries it.

    ``mesh``: a mesh whose shards sit on several ranks
    (``Mesh.multiprocess``); ``shards`` then holds None in the place of
    every other rank's shard, and only the local shards' tiles are made
    (None elsewhere).  A ghost block whose source shard is another rank's
    arrives by a receive that its owner's send matches, tagged by (source
    shard, destination shard, block); every message of the exchange goes
    in one batch (``parallel/dist.py:exchange``).

    ``drop_dead``: on a dead boundary, a ghost that would lie outside the
    global grid is left off rather than filled with zeros, so an edge
    shard's extended tile ends at the global edge.  ``width_multiple``:
    where a tile has a right ghost, zero columns are added past it up to a
    multiple of it (a kernel that moves aligned rows faster).  No cell of
    the tile reads them within k generations: its dependence cone ends in
    the ghost, k·r <= the ghost's depth.  A tile that ends at a dead
    global edge gets none, since the cells there must stay dead."""
    periodic = boundary == "periodic"
    rr, rc = radius_rows, radius_cols
    mi, mj = len(shards), len(shards[0])
    fwd_r, bwd_r, up, down = _ghost_sources(mi, periodic)
    fwd_c, bwd_c, left, right = _ghost_sources(mj, periodic)
    local = [(i, j) for i in range(mi) for j in range(mj)
             if shards[i][j] is not None]
    # every shard of a mesh has one shape; a batch of boards leads it
    lead = tuple(shards[local[0][0]][local[0][1]].shape[:-2])
    h0, w0 = shards[local[0][0]][local[0][1]].shape[-2:]

    def depths(i, j):  # (top, bottom, left, right) ghosts of shard (i, j)
        if not drop_dead:
            return rr, rr, rc, rc
        return ghost_depths((mi, mj), i, j, rr, rc, periodic)

    def blocks(i, j):
        """Shard (i, j)'s blocks, in the order they are filled: (block
        number, source shard row and column (None: no pair), the block's
        rows and columns in the extended tile, and in the source)."""
        h, w = h0, w0
        t, b, l, r = depths(i, j)
        rows = ((up.get(i), slice(0, t), slice(h - rr, h)),
                (i, slice(t, t + h), slice(0, h)),
                (down.get(i), slice(t + h, t + h + b), slice(0, rr)))
        cols = ((left.get(j), slice(0, l), slice(w - rc, w)),
                (j, slice(l, l + w), slice(0, w)),
                (right.get(j), slice(l + w, l + w + r), slice(0, rc)))
        for bi, (si, dst_r, src_r) in enumerate(rows):
            for bj, (sj, dst_c, src_c) in enumerate(cols):
                yield 3 * bi + bj, si, sj, dst_r, dst_c, src_r, src_c

    if mi > 1:
        record_exchange(axes[0], fwd_r, lead + (rr, w0))
        record_exchange(axes[0], bwd_r, lead + (rr, w0))
    if mj > 1:
        t, b, _, _ = depths(0, 0)
        record_exchange(axes[1], fwd_c, lead + (t + h0 + b, rc))
        record_exchange(axes[1], bwd_c, lead + (t + h0 + b, rc))
    received = {}
    if mesh is not None and mesh.multiprocess:
        received = _remote_blocks(shards, mesh, blocks)
    out = [[None] * mj for _ in range(mi)]
    for i, j in local:
        x = shards[i][j]
        h, w = x.shape[-2:]
        t, b, l, r = depths(i, j)
        W = l + w + r
        if r:
            W += -W % width_multiple
        ext = torch.empty(lead + (t + h + b, W), dtype=x.dtype,
                          device=x.device)
        for blk, si, sj, dst_r, dst_c, src_r, src_c in blocks(i, j):
            dst = ext[..., dst_r, dst_c]
            if not dst.numel():
                continue
            if si is None or sj is None:
                dst.zero_()   # no pair: a ppermute delivers zeros
            elif (i, j, blk) in received:
                dst.copy_(received[i, j, blk], non_blocking=True)
            else:
                dst.copy_(shards[si][sj][..., src_r, src_c],
                          non_blocking=True)
        if W > l + w + r:
            ext[..., l + w + r:].zero_()
        out[i][j] = ext
    return out


def _remote_blocks(shards: Shards, mesh, blocks) -> dict:
    """The ghost blocks of this rank's shards that other ranks hold, by
    (i, j, block): one batch in which this rank also sends every block of
    its shards that another rank's shard needs."""
    from mpi_tpu_torch.parallel import dist

    mi, mj = mesh.dims
    n = mi * mj
    first = next(s for row in shards for s in row if s is not None)
    dtype, lead = first.dtype, tuple(first.shape[:-2])
    sends, recvs, keys = [], [], []
    for i in range(mi):
        for j in range(mj):
            dst_owner = mesh.owner(i, j)
            for blk, si, sj, dst_r, dst_c, src_r, src_c in blocks(i, j):
                if si is None or sj is None:
                    continue
                src_owner = mesh.owner(si, sj)
                shape = lead + (_extent(dst_r), _extent(dst_c))
                if src_owner == dst_owner or 0 in shape:
                    continue
                tag = ((si * mj + sj) * n + i * mj + j) * 9 + blk
                if src_owner == mesh.rank:
                    sends.append((dst_owner, tag,
                                  shards[si][sj][..., src_r, src_c]))
                elif dst_owner == mesh.rank:
                    recvs.append((src_owner, tag, shape, dtype))
                    keys.append((i, j, blk))
    return dict(zip(keys, dist.exchange(sends, recvs)))
