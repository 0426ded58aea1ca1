"""``--comm-every auto``: the port's ``mpi_tpu.parallel.policy``.

On a mesh (``resolve_auto(config, effective_mesh, mesh)``) the reference's
policy holds as it is: K from :data:`LATENCY_TABLE` at the collective
latency :func:`probe_collective_latency_us` measures, clamped by the
engines' halo bounds and the fringe budget (:func:`choose_comm_policy`),
and ``overlap`` wherever the stitched bands fit.  The table's thresholds
are the reference's placeholders; the port's exchange is a set of slice
copies, whose latency on one card is a few launches.  Under a process
group every rank takes process 0's probed latency
(``parallel/dist.py:broadcast_one_to_all``), as the reference does
(``mpi_tpu/parallel/policy.py:195-207``): ranks that chose different K
would post exchanges that never pair, and the group would hang.

The rest of this docstring is the single-device branch, folded into one
function that returns the depth (``resolve_auto(config)``).

One device has no collective to avoid or hide, but every kernel reads
``comm_every`` as its temporal-blocking depth (generations per read and
write of device memory), so ``auto`` picks a depth from where the run
lands (``backends/cuda.py:select_engine``, the pad plan included):

* ``SINGLE_DEVICE_PALLAS_GENS`` (8) when K1 serves a radius-1 rule without
  birth-on-0 at depth 8, padded widths included;
* else the deepest of 8, 4, 2 at which the run lands on K2 with
  gens x r <= 16, if it is on K2 at depth 1 too;
* else 1.

A depth that would move a run off K1 or K3 onto K2 is never picked (K3
keeps depth 1, as the reference's LtL does).

Where the reference answers otherwise.  Its predicates are the TPU
kernels' shape contracts (``pallas_bitlife.supports``: packed rows a
multiple of 128 words, >= 8 rows; ``pallas_stencil.supports``: widths a
multiple of 128 cells), which the port's kernels do not have, and its LtL
runs at depths beyond ⌊8/r⌋ take a 1x1-mesh stepper the port does not
have (K2 serves them).  So, with ``MPI_TPU_PALLAS_INTERPRET=1`` on one
device (``tests/test_torch_policy.py`` pins each):

* radius 1 on K1 at a width that is not a multiple of 4096 cells (64x256,
  or padded: dead 64x100 and 64x4000, periodic 64x100): the reference
  picks 1, the port 8;
* a run on K2 at depth 1 (a periodic width the seam band cannot serve:
  Bosco at 64x18, Life at 16x3): the reference picks 1 (or refuses a grid
  under depth 8's halo), the port the deepest K2 depth the grid admits, 2;
* an LtL rule on K3 at a width of whole 128-cell groups whose 1x1-mesh
  interior the reference declines (Bosco at 64x256 or dead 64x128, R2 at
  64x256): the reference picks its dense kernel's depth (2 for Bosco, 8 for
  R2), the port 1;
* a grid under depth 8's halo (Life at 4x4096): the reference refuses it,
  the port picks 1.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

from mpi_tpu_torch.config import ConfigError
from mpi_tpu_torch.models.rules import Rule

# policy table: (latency ceiling in µs, K) — the first row whose ceiling
# exceeds the measured latency wins; deliberately coarse (the reference's)
LATENCY_TABLE = ((30.0, 1), (150.0, 2), (600.0, 4), (float("inf"), 8))

# a band deeper than tile_min/8 spends >~25% of compute on redundant
# fringe (both sides, both axes) — cap K there
FRINGE_DIVISOR = 8

# K1's depth when it serves the run: the reference's measured winner on the
# TPU; on the H100 a gens-8 pass costs about 3.5x a gens-1 pass for 8x the
# generations (PERF.md, the kernel table)
SINGLE_DEVICE_PALLAS_GENS = 8


def probe_collective_latency_us(mesh, reps: int = 5) -> float:
    """One-shot measured latency (µs) of one halo exchange across the
    mesh's shards (``parallel/step.py:make_halo_probe`` on one small int32
    tile a shard), warmed once, median of ``reps`` timed calls, each
    closed by a sync of every device of the mesh this process holds (a
    collective under a process group: each rank probes its shards)."""
    import torch

    from mpi_tpu_torch.parallel.step import make_halo_probe

    probe = make_halo_probe(mesh, "periodic")
    shards = [[torch.zeros((8, 8), dtype=torch.int32, device=dev)
               if mesh.is_local(i, j) else None
               for j, dev in enumerate(row)]
              for i, row in enumerate(mesh.devices)]
    cards = [d for d in mesh.local_devices() if d.type == "cuda"]

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    probe(shards)
    sync()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        probe(shards)
        sync()
        samples.append((time.perf_counter() - t0) * 1e6)
    samples.sort()
    return samples[len(samples) // 2]


def choose_comm_policy(
    n_devices: int,
    rule: Rule,
    tile_rows: int,
    tile_cols: int,
    latency_us: float,
    overlap_requested: bool = False,
) -> Tuple[int, bool]:
    """(comm_every, overlap) for ``--comm-every auto`` on a mesh of
    ``n_devices`` > 1 shards, the reference's table; one device goes
    through :func:`resolve_auto`, which judges by the port's own routing.
    K from the latency table, clamped by the engine's halo bounds (K <= 16
    at radius 1, K·r <= 31 beyond) and the fringe budget (K·r <=
    tile_min/8); a rule that gives birth on 0 neighbours cannot run deep
    halos.  ``overlap`` turns on whenever the stitched bands fit the
    tile."""
    if n_devices < 2:
        raise ValueError(f"choose_comm_policy is the mesh policy; got "
                         f"{n_devices} device(s)")
    r = rule.radius
    if 0 in rule.birth:
        return 1, overlap_requested
    for ceiling, k in LATENCY_TABLE:
        if latency_us < ceiling:
            break
    kmax_engine = 16 if r == 1 else 31 // r
    tile_min = min(tile_rows, tile_cols)
    kmax_fringe = max(1, tile_min // (FRINGE_DIVISOR * r))
    k = max(1, min(k, kmax_engine, kmax_fringe))
    # stitched bands need 2·K·r rows and (packed engines) 2 words of cols
    overlap = tile_rows >= 2 * k * r and tile_cols >= 64
    return k, overlap


def resolve_auto(config, effective_mesh: Optional[Tuple[int, int]] = None,
                 mesh=None, latency_us: Optional[float] = None):
    """What ``auto`` resolves to.  Without ``effective_mesh``: the depth
    ``comm_every`` on one device, judged by the port's own routing at each
    candidate depth.  With it, the reference's answer (comm_every,
    overlap): on (1, 1) that depth and the requested overlap; on a larger
    mesh :func:`choose_comm_policy` at ``latency_us``, probed on ``mesh``
    when not given."""
    if effective_mesh is not None:
        mi, mj = effective_mesh
        if mi * mj == 1:
            return resolve_auto(config), config.overlap
        if latency_us is None:
            latency_us = probe_collective_latency_us(mesh)
            from mpi_tpu_torch.parallel import dist

            if dist.process_count() > 1:
                # every rank must resolve the same K; per-rank medians can
                # straddle a table threshold, so process 0's is used
                latency_us = float(dist.broadcast_one_to_all(latency_us))
        return choose_comm_policy(
            mi * mj, config.rule, config.rows // mi, config.cols // mj,
            latency_us, overlap_requested=config.overlap)
    from mpi_tpu_torch.backends.cuda import select_engine

    def route(g: int) -> Optional[str]:
        # judged without sparse_tile, which holds comm_every at 1: the
        # config then refuses the depth picked, as the reference's does
        try:
            return select_engine(dataclasses.replace(
                config, comm_every=g, sparse_tile=0))
        except ConfigError:  # the grid is smaller than the depth's halo
            return None

    rule = config.rule
    if 0 in rule.birth:
        return 1
    if rule.radius == 1 and route(SINGLE_DEVICE_PALLAS_GENS) == "bit":
        return SINGLE_DEVICE_PALLAS_GENS
    if route(1) == "dense":
        for g in (SINGLE_DEVICE_PALLAS_GENS, 4, 2):
            if g * rule.radius <= 16 and route(g) == "dense":
                return g
    return 1
