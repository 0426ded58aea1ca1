"""The config matrix the launch-level verifier runs.

Each :class:`Cell` pins one (engine family x boundary x dense/sparse x
solo/batched x mesh x depth) point; the harness builds the cell's engine,
steps it for real under the recorder and the checks judge the records.
The cells are the reference's (``mpi_tpu/analysis/ir/matrix.py``), with
its ids, plus the (1, 1) counterparts of four of its mesh cells
(``<reference id>_1x1``) that the fast tier needs to launch each of K1,
K2 and K3 at gens > 1 on one device: ``packed_k2`` (K1 in passes of 2),
``ltl_r2_k2`` (K3 in passes of 2), ``ltl_r2_dead`` (K3 at a dead
boundary) and ``dense_r2_k16`` (radius 2 at comm_every 16 takes K2, in
passes of 8).  A cell on a mesh other than (1, 1) runs on that many
virtual shards of the one device (``make_mesh(shape, devices=[dev] *
n)``), on the CPU and on the card alike, and its halo exchanges are
recorded for ``ir-collective``; ``batched_packed_1x2`` steps a batch of
two boards on one, one K1 launch a shard a pass for both.

Grids are 64 rows, so a cell's steps are tiny; the ``fast`` tier runs
in the tests and every tier in ``chip_smoke.py`` on the card.  Which
kernel a cell takes is the port's plan (``backends/cuda.py:
plan_engine``): ``dense_bosco_1x1`` keeps the reference's id, but the
port steps Bosco at comm_every 1 on K3, where the reference off the TPU
takes its dense stencil.

``twin_of`` pairs (:data:`TWINS`) differ only in a field
``plan_signature`` deliberately EXCLUDES (seed): their signatures must
collide and their launch records must be identical.  ``NEAR_PAIRS``
differ in exactly one field the signature must SEE: the reference's pairs
whose two ends are both in this matrix (its mesh pairs among them), the
(1, 1) counterpart of its comm_every pair, and the boundary pair of the
two Bosco cells.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from mpi_tpu_torch.config import GolConfig
from mpi_tpu_torch.models.rules import rule_from_name


@dataclass(frozen=True)
class Cell:
    """One matrix point.  ``batch`` = 0 steps one grid with
    ``Engine.step``; B > 0 steps a stacked batch of B boards (seeds
    ``seed``, ``seed + 1``, ...) with ``Engine.step_batched``.  ``depth``
    is the generations of each recorded step."""

    id: str
    rows: int
    cols: int
    rule: str = "life"
    boundary: str = "periodic"
    mesh: Tuple[int, int] = (1, 1)
    comm_every: int = 1
    overlap: bool = False
    sparse_tile: int = 0
    depth: int = 1
    batch: int = 0
    seed: int = 0
    tier: str = "full"            # "fast" cells also run in the tests
    twin_of: Optional[str] = None  # seed-only twin (signature must match)

    def make_config(self) -> GolConfig:
        return GolConfig(
            rows=self.rows, cols=self.cols, steps=0, seed=self.seed,
            rule=rule_from_name(self.rule), boundary=self.boundary,
            backend="cuda", mesh_shape=self.mesh,
            comm_every=self.comm_every, overlap=self.overlap,
            sparse_tile=self.sparse_tile,
        )

    @property
    def devices_needed(self) -> int:
        return self.mesh[0] * self.mesh[1]


# a radius-2 Larger-than-Life rule: K3 up to comm_every 4, K2 beyond
_R2 = "R2,B8-12,S9-14"

CELLS: List[Cell] = [
    # -- fast tier: every engine family, K1-K3 each at gens > 1 ---------
    Cell("packed_1x1", 64, 64, depth=2, tier="fast"),
    Cell("packed_1x1_seed7", 64, 64, depth=2, seed=7, tier="fast",
         twin_of="packed_1x1"),
    Cell("packed_k2_1x1", 64, 64, comm_every=2, depth=3, tier="fast"),
    Cell("ltl_r2_k2_1x1", 64, 64, rule=_R2, comm_every=2, depth=3,
         tier="fast"),
    Cell("ltl_r2_dead_1x1", 64, 64, rule=_R2, boundary="dead", depth=1,
         tier="fast"),
    # K·r = 32 exceeds K3's ⌊8/r⌋ generations a pass: K2 in passes of
    # ⌊16/r⌋ = 8, depth 17 = 8 + 8 + 1
    Cell("dense_r2_k16_1x1", 64, 160, rule=_R2, comm_every=16, depth=17,
         tier="fast"),
    # 48 cells = 1.5 words: the padded K1 with the seam band's one launch
    Cell("seam_1x1", 64, 48, depth=2, tier="fast"),
    Cell("dense_bosco_1x1", 64, 64, rule="bosco", depth=1, tier="fast"),
    Cell("sparse_1x1", 64, 64, sparse_tile=32, depth=2, tier="fast"),
    Cell("batched_packed_1x2", 64, 64, mesh=(1, 2), depth=2, batch=2,
         tier="fast"),
    Cell("batched_seam_1x1", 64, 48, depth=2, batch=2, tier="fast"),
    # the reference's mesh cells: K1, K3 and K2 as tile interiors, the
    # halo exchange's slabs, dead and periodic rings
    Cell("packed_1x2_periodic", 64, 64, mesh=(1, 2), depth=2, tier="fast"),
    Cell("packed_1x2_dead", 64, 64, boundary="dead", mesh=(1, 2), depth=2,
         tier="fast"),
    Cell("packed_2x2_dead", 64, 64, boundary="dead", mesh=(2, 2), depth=2,
         tier="fast"),
    Cell("packed_k2_1x2", 64, 64, mesh=(1, 2), comm_every=2, depth=3,
         tier="fast"),
    Cell("ltl_r2_k2_1x2", 64, 64, rule=_R2, mesh=(1, 2), comm_every=2,
         depth=3, tier="fast"),
    Cell("ltl_r2_1x2_dead", 64, 64, rule=_R2, boundary="dead", mesh=(1, 2),
         depth=1, tier="fast"),
    # K·r = 32: past the packed engines' one ghost word and the seam, so
    # the dense stepper; depth 17 = passes of 16 and 1, K2 in chunks of 8
    Cell("dense_r2_k16_overlap_1x2", 64, 160, rule=_R2, mesh=(1, 2),
         comm_every=16, overlap=True, depth=17, tier="fast"),
    Cell("packed_2x4_2host", 64, 128, mesh=(2, 4), depth=2, tier="fast"),
    # -- full tier ------------------------------------------------------
    Cell("dense_bosco_1x1_dead", 64, 64, rule="bosco", boundary="dead",
         depth=1),
    Cell("sparse_ltl_1x1", 64, 64, rule=_R2, sparse_tile=32, depth=1),
    Cell("batched_sparse_1x1", 64, 64, sparse_tile=32, depth=1, batch=2),
    Cell("packed_2x2_periodic", 64, 64, mesh=(2, 2), depth=2),
    Cell("packed_2x1_asym", 128, 64, mesh=(2, 1), depth=1),
    Cell("packed_k4_1x2", 64, 64, mesh=(1, 2), comm_every=4, depth=5),
    Cell("packed_w128_1x2", 64, 128, mesh=(1, 2), depth=2),
    Cell("packed_w128_overlap_1x2", 64, 128, mesh=(1, 2), overlap=True,
         depth=2),
    Cell("highlife_1x2", 64, 64, rule="highlife", mesh=(1, 2), depth=2),
    Cell("seam_1x2", 64, 80, mesh=(1, 2), depth=2),
    Cell("dense_r2_k16_1x2", 64, 160, rule=_R2, mesh=(1, 2),
         comm_every=16, depth=17),
    Cell("seam_overlap_1x2", 64, 80, mesh=(1, 2), overlap=True, depth=2),
    Cell("ltl_r2_2x2_periodic", 64, 64, rule=_R2, mesh=(2, 2), depth=2),
    Cell("packed_1x8_2host", 64, 256, mesh=(1, 8), comm_every=2, depth=3),
    Cell("ltl_r2_2x4_2host", 64, 128, rule=_R2, mesh=(2, 4), depth=2),
]

# (cell, the cell it is a seed-only twin of)
TWINS: List[Tuple[str, str]] = [
    (c.id, c.twin_of) for c in CELLS if c.twin_of is not None]

# (cell_a, cell_b, the one signature-visible field they differ in)
NEAR_PAIRS: List[Tuple[str, str, str]] = [
    ("packed_1x1", "sparse_1x1", "sparse_tile"),
    ("packed_1x1", "packed_k2_1x1", "comm_every"),
    ("dense_bosco_1x1", "dense_bosco_1x1_dead", "boundary"),
    # the reference's mesh pairs
    ("packed_1x2_periodic", "packed_1x2_dead", "boundary"),
    ("packed_1x1", "packed_1x2_periodic", "mesh_shape"),
    ("packed_1x2_periodic", "packed_k2_1x2", "comm_every"),
    ("packed_1x2_periodic", "highlife_1x2", "rule"),
    ("packed_2x2_dead", "packed_2x2_periodic", "boundary"),
    ("packed_w128_1x2", "packed_w128_overlap_1x2", "overlap"),
    ("dense_r2_k16_1x2", "dense_r2_k16_overlap_1x2", "overlap"),
    ("seam_1x2", "seam_overlap_1x2", "overlap"),
    ("packed_2x4_2host", "ltl_r2_2x4_2host", "rule"),
]

_BY_ID = {c.id: c for c in CELLS}
assert len(_BY_ID) == len(CELLS), "duplicate cell ids"


def cell_by_id(cell_id: str) -> Cell:
    try:
        return _BY_ID[cell_id]
    except KeyError:
        raise KeyError(f"unknown matrix cell {cell_id!r} "
                       f"(see --list-cells)") from None


def cells(fast_only: bool = False) -> List[Cell]:
    if fast_only:
        return [c for c in CELLS if c.tier == "fast"]
    return list(CELLS)


def near_pairs(selected: List[Cell]) -> List[Tuple[Cell, Cell, str]]:
    """The NEAR_PAIRS whose both endpoints are in ``selected``."""
    ids = {c.id for c in selected}
    return [(_BY_ID[a], _BY_ID[b], f)
            for a, b, f in NEAR_PAIRS if a in ids and b in ids]
