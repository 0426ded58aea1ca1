"""``--comm-every auto`` on one device: the single-device branches of
``mpi_tpu.parallel.policy`` (``resolve_auto``, ``choose_comm_policy``),
folded into one function that returns the depth.

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
from typing import Optional

from mpi_tpu_torch.config import ConfigError

# K1's depth when it serves the run: the reference's measured winner on the
# TPU; on the H100 a gens-8 pass costs about 3.5x a gens-1 pass for 8x the
# generations (PERF.md, the kernel table)
SINGLE_DEVICE_PALLAS_GENS = 8


def resolve_auto(config) -> int:
    """The depth ``comm_every`` that ``auto`` resolves to for ``config`` on
    one device, judged by the port's own routing at each candidate depth."""
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
