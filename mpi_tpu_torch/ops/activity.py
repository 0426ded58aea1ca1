"""Activity-gated sparse stepping: skip tiles that provably cannot change.

The port of ``mpi_tpu.ops.activity``, in plain PyTorch on tensors of the
engine's device.  The board is cut into fixed T×T tiles with a per-tile
map of the tiles that changed in the last generation: a tile is *active*
next step iff it or one of its 8 tile neighbours changed.  State moves at
most ``r`` cells a generation, so for T >= r one ring of dilation covers
everything that can change, and skipped tiles are bit-identical to
recomputed ones for every rule and boundary.

The phases are the reference's, in the same order and with the same
constants, so the grid **and** the changed map after every dispatch equal
the reference's:

  until the step budget is spent:
    for g in (plan.gens, 1), for K in the capacity ladder (ascending):
      while g steps remain and the active set fits K: one sparse step
    while the board is busy (active > release_tiles):
      unprobed dense chunks (DENSE_CHUNKS, largest first) under an
      all-ones map, then ONE probed final generation whose consecutive
      compare gives an exact map

A sparse step pads the active list to K slots with tile 0
(``torch.nonzero_static``; the padding lanes recompute tile 0 from the
same snapshot, so their duplicate writes carry identical values), gathers
the K haloed tiles side by side into one [T + 2·halo rows, K·(T + 2·halo)]
stripe, steps it ``g`` generations with dead-boundary calls of the
engine's own kernel at depth 1 (K1, K3 or K2), OR-ing each generation's
consecutive interior compare into the tile's dirty bit (a period-p
oscillator stays marked), and writes the interiors back in place with one
``index_put_``.  The dense phase runs the engine's ping-pong pass; its
unprobed chunks run as passes of ``dense_depth`` generations (their maps
are all-ones whatever the depth), the probed tail as one depth-1 pass.

**Where the port differs.**  The reference runs the phases as one jitted
``while_loop`` program with no host sync.  Here the phase loop is Python:
the host reads the dilated active count once per phase decision, that is
once after each sparse gather of ``g`` generations and after each probe
(a dense chunk leaves an all-ones map, whose count needs no read).  Each
read waits for the device, so the device idles while the host queues the
next phase's launches; the sparse path is host-bound by design, as the
phases do not run as a CUDA graph.

Tiles are in array units: rows are cells, columns are words on the
packed engines (T a multiple of 32) and cells on the dense engine.
``backends/cuda.py:build_engine`` builds the :class:`TilePlan` and
supplies the engine's pass and the stripe step.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

# Capacity ladder (fractions of all tiles): the active list is padded to a
# fixed size per rung, so a sparse step costs its rung, not the true count.
CAPACITY_FRACS = (1 / 32, 1 / 8)
# Hysteresis: the dense phase is entered when the active set exceeds the
# top rung and left only when a probe finds it at or below RELEASE_FRAC.
RELEASE_FRAC = 0.10
# Dense-phase chunk ladder: unprobed dense generations, largest first,
# under an all-ones map; only the dispatch's final generation is probed.
DENSE_CHUNKS = (128, 32, 8, 1)
# Generations per gather: each active tile is gathered with an s·r-deep
# halo and the stripe stepped s generations before the write-back, capped
# at tile_px // radius so the one-ring dilation covers the propagation.
DEPTH_TARGET = 8


class SparseState(NamedTuple):
    """The engine's grid (packed words or dense cells) and the [nti, ntj]
    bool map of tiles that changed in the last committed generation (an
    all-ones map is always safe, merely slower).  A batch stacks both
    fields on a leading board axis."""

    grid: torch.Tensor
    changed: torch.Tensor


@dataclass(frozen=True)
class TilePlan:
    """Static tile geometry in array units (rows = cells, cols = words on
    the packed engines).  ``tile_px`` is the tile side in cells (the
    ``sparse_tile`` knob); ``cell_cols_per_unit`` converts array columns to
    cells (32 packed, 1 dense); ``capacities`` is the ascending rung
    ladder; ``release_tiles`` the hysteresis release threshold."""

    tile_px: int
    tile_r: int
    tile_c: int
    halo_r: int
    halo_c: int
    nti: int
    ntj: int
    capacities: tuple
    release_tiles: int
    periodic: bool
    cell_cols_per_unit: int
    gens: int = 1                     # generations per gather

    @property
    def ntiles(self) -> int:
        return self.nti * self.ntj

    @property
    def capacity(self) -> int:
        """Top rung: the largest active set the sparse phases serve."""
        return self.capacities[-1]

    def stripe_shape(self, K: int) -> tuple:
        """(rows, columns) of the stripe of K haloed tiles, in array units."""
        return (self.tile_r + 2 * self.halo_r,
                K * (self.tile_c + 2 * self.halo_c))


def make_plan(*, rows: int, cols_units: int, tile_px: int, radius: int,
              periodic: bool, packed: bool, depth: int = 0) -> TilePlan:
    """Tile geometry for a [rows, cols_units] grid, as the reference plans
    it.  ``depth`` overrides the generations per gather (0 = DEPTH_TARGET
    capped at tile_px // radius).  Callers check divisibility and T >= r
    first, with a ConfigError that names the config."""
    unit = 32 if packed else 1
    if (tile_px % unit or rows % tile_px or (cols_units * unit) % tile_px
            or tile_px < radius):
        raise ValueError(f"tile {tile_px} does not fit a {rows}x"
                         f"{cols_units * unit} grid at radius {radius}")
    gens = max(1, min(depth or DEPTH_TARGET, tile_px // radius))
    tile_c = tile_px // unit
    nti, ntj = rows // tile_px, cols_units // tile_c
    ntiles = nti * ntj
    capacities = tuple(sorted(set(
        max(1, min(ntiles, math.ceil(f * ntiles))) for f in CAPACITY_FRACS)))
    release_tiles = min(capacities[-1], max(1, int(RELEASE_FRAC * ntiles)))
    halo = gens * radius
    return TilePlan(
        tile_px=tile_px, tile_r=tile_px, tile_c=tile_c, halo_r=halo,
        halo_c=max(1, math.ceil(halo / unit)) if packed else halo,
        nti=nti, ntj=ntj, capacities=capacities,
        release_tiles=release_tiles, periodic=periodic,
        cell_cols_per_unit=unit, gens=gens,
    )


def initial_state(grid: torch.Tensor, plan: TilePlan) -> SparseState:
    """A fresh grid with every tile marked changed (the prior step is
    unknown; the first probe settles the gate)."""
    return SparseState(grid, torch.ones((plan.nti, plan.ntj),
                                        dtype=torch.bool, device=grid.device))


def dilate_tiles(changed: torch.Tensor, periodic: bool) -> torch.Tensor:
    """8-neighbour dilation of the tile map over its last two axes.
    Periodic maps wrap, so a tile on the edge neighbours across the seam."""
    def along(x, dim):
        if periodic:
            return x | x.roll(1, dim) | x.roll(-1, dim)
        n = x.shape[dim]
        out = x.clone()
        out.narrow(dim, 1, n - 1).logical_or_(x.narrow(dim, 0, n - 1))
        out.narrow(dim, 0, n - 1).logical_or_(x.narrow(dim, 1, n - 1))
        return out
    return along(along(changed, -2), -1)


def active_count(changed: torch.Tensor, periodic: bool) -> torch.Tensor:
    """Tiles the next step must compute: the dilated map's count, a 0-d
    tensor on the map's device (reading it on the host syncs)."""
    return dilate_tiles(changed, periodic).sum()


def gather_stripe(grid: torch.Tensor, ti: torch.Tensor, tj: torch.Tensor,
                  plan: TilePlan) -> torch.Tensor:
    """The [tile_r + 2·halo_r, K·(tile_c + 2·halo_c)] stripe of the K
    haloed tiles (ti, tj) side by side: tile k owns columns [k·C, (k+1)·C).
    Periodic grids wrap by modular indexing; dead edges clip and zero the
    halo beyond the board.  The wrap and the clip work on the small [R, K]
    and [K, C] index vectors, broadcast as [R, K, 1] rows against
    [1, K, C] columns, so no stripe-sized index tensor is made here (on
    CUDA, PyTorch's index kernel makes such broadcast indices contiguous
    itself)."""
    H, W = grid.shape
    R, C = plan.stripe_shape(1)
    dev = grid.device
    ur = (torch.arange(-plan.halo_r, R - plan.halo_r, device=dev)[:, None]
          + ti[None] * plan.tile_r)
    uc = tj[:, None] * plan.tile_c + torch.arange(-plan.halo_c,
                                                  C - plan.halo_c, device=dev)
    if plan.periodic:
        stripe = grid[(ur % H)[:, :, None], (uc % W)[None]]
    else:
        stripe = grid[ur.clamp(0, H - 1)[:, :, None], uc.clamp(0, W - 1)[None]]
        stripe.masked_fill_(~((ur >= 0) & (ur < H))[:, :, None], 0)
        stripe.masked_fill_(~((uc >= 0) & (uc < W))[None], 0)
    return stripe.view(R, -1)


def tile_changed_map(new: torch.Tensor, old: torch.Tensor,
                     plan: TilePlan) -> torch.Tensor:
    """Exact [nti, ntj] map of tiles where ``new`` != ``old``; valid only
    across ONE generation (a longer baseline marks period-p oscillators
    clean)."""
    d = new != old
    return (d.view(plan.nti, plan.tile_r, plan.ntj, plan.tile_c)
            .any(dim=3).any(dim=1))


def make_sparse_evolve(base_pass: Callable, local_step: Callable,
                       plan: TilePlan, dense_depth: int = 1) -> Callable:
    """``evolve(state, steps, spare) -> (state, spare)`` over a
    :class:`SparseState`.

    ``base_pass(src, k, dst)`` writes ``k`` generations of the whole grid
    into ``dst`` and returns it (the engine's ping-pong pass); the dense
    phase runs it at depth ``dense_depth`` for unprobed chunks and at 1 for
    the probe.  ``local_step(stripe, out)`` writes one dead-boundary
    generation of a stripe into ``out`` and returns it.  ``spare`` is a
    buffer of the grid's shape the dense phase may overwrite (None: one is
    allocated); the input grid is consumed, as ``Engine.step``'s is.  The
    sparse phases write the grid in place.

    ``evolve.phases`` counts the phases run (``("sparse", K, g)``,
    ``("dense", n)``, ``("probe",)``) and ``evolve.reads`` the host reads
    of the active count, for the smoke run's report."""
    hr, hc = plan.halo_r, plan.halo_c
    tr, tc = plan.tile_r, plan.tile_c
    C = tc + 2 * hc

    def interior(x, K):
        return x[hr:hr + tr].view(tr, K, C)[:, :, hc:hc + tc]

    def sparse_step(grid, active, K, g):
        idx = torch.nonzero_static(active.flatten(), size=K,
                                   fill_value=0).flatten()
        ti, tj = idx // plan.ntj, idx % plan.ntj
        cur = gather_stripe(grid, ti, tj, plan)
        nxt = torch.empty_like(cur)
        # each generation's consecutive compare over the interior rows (one
        # contiguous pass), OR-ed cell by cell; reduced to a dirty bit per
        # tile, over its own columns, once a gather
        diff = torch.empty((tr, cur.shape[1]), dtype=torch.bool,
                           device=grid.device)
        seen = torch.zeros_like(diff)
        for _ in range(g):
            nxt = local_step(cur, nxt)
            seen |= torch.ne(nxt[hr:hr + tr], cur[hr:hr + tr], out=diff)
            cur, nxt = nxt, cur
        dirty = seen.view(tr, K, C)[:, :, hc:hc + tc].any(dim=0).any(dim=1)
        # one write of every tile through the grid's [nti, ntj, tr, tc]
        # view; padding lanes rewrite tile 0 with its value from the snapshot
        tiles = grid.view(plan.nti, tr, plan.ntj, tc).permute(0, 2, 1, 3)
        tiles.index_put_((ti, tj), interior(cur, K).permute(1, 0, 2))
        changed = torch.zeros(plan.ntiles, dtype=torch.bool,
                              device=grid.device)
        changed.index_put_((idx,), dirty)
        return changed.view(plan.nti, plan.ntj)

    def evolve(state: SparseState, steps: int, spare: Optional[torch.Tensor]):
        if steps <= 0:
            return state, spare
        grid, changed = state
        if spare is None:
            spare = torch.empty_like(grid)
        done = 0
        active, count = None, None  # the dilated map and its count, lazily

        def fits(limit: int) -> bool:
            nonlocal active, count
            if count is None:
                active = dilate_tiles(changed, plan.periodic)
                count = int(active.sum())
                evolve.reads += 1
            return count <= limit

        depths = [plan.gens] + ([1] if plan.gens > 1 else [])
        while done < steps:
            for g in depths:
                for K in plan.capacities:
                    while done + g <= steps and fits(K):
                        changed = sparse_step(grid, active, K, g)
                        active = count = None
                        done += g
                        evolve.phases["sparse", K, g] += 1
            for n in DENSE_CHUNKS:
                while done + n < steps and not fits(plan.release_tiles):
                    full, rem = divmod(n, dense_depth)
                    for k in [dense_depth] * full + [rem] * bool(rem):
                        grid, spare = base_pass(grid, k, spare), grid
                    changed = torch.ones_like(changed)
                    active, count = changed, plan.ntiles
                    done += n
                    evolve.phases["dense", n] += 1
            while done < steps and not fits(plan.release_tiles):
                new = base_pass(grid, 1, spare)
                changed = tile_changed_map(new, grid, plan)
                grid, spare = new, grid
                active = count = None
                done += 1
                evolve.phases["probe", ] += 1
        return SparseState(grid, changed), spare

    evolve.phases = Counter()
    evolve.reads = 0
    return evolve


def activity_stats(state: SparseState, plan: TilePlan) -> dict:
    """The next step's active set implied by the map: one small reduction
    on the device and one host read."""
    n = int(active_count(state.changed, plan.periodic))
    ntiles = plan.ntiles
    return {
        "active_tiles": n,
        "ntiles": ntiles,
        "active_fraction": n / ntiles if ntiles else 0.0,
        "mode": "sparse" if n <= plan.capacity else "dense",
        "tile": plan.tile_px,
        "capacity": plan.capacity,
    }
