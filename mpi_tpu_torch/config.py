"""Run configuration of the port: the single-device subset of
``mpi_tpu.config``.

The fields keep the reference's names and meanings, and ``sparse_tile``
the reference's checks.  What the port does not serve yet is refused here
with a :class:`ConfigError` that names the ROADMAP item which brings it:
device meshes and ``overlap`` (item 13).  Every other rule, width and
``comm_every`` runs on one of kernels K1, K2 and K3
(``backends/cuda.py:select_engine``, padded widths included; K2 runs a
comm_every deeper than its halo as passes of ⌊16/r⌋ generations); the
``serial`` oracle and the native host backends ``cpp`` and ``cpp-par``
(``backends/cpp.py``, ``workers`` threads) serve any rule and width.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

from mpi_tpu_torch.models.rules import LIFE, Rule

WORD = 32  # cells per packed word
BACKENDS = ("cuda", "serial", "cpp", "cpp-par")


class ConfigError(ValueError):
    """Invalid run configuration."""


def validate_size(rows: int, cols: int, ghost: int) -> None:
    """The reference's single-device size check: the grid must be at least
    ``ghost`` (= rule radius × comm_every) cells on each side."""
    if rows < ghost or cols < ghost:
        raise ConfigError(
            f"tile {rows}x{cols} smaller than the {ghost}-deep ghost "
            f"ring (rule radius x comm_every)"
        )


@dataclass(frozen=True)
class GolConfig:
    rows: int
    cols: int
    steps: int
    snapshot_every: int = 0          # 0 = no snapshots
    seed: int = 0
    rule: Rule = LIFE
    boundary: str = "periodic"       # "periodic" | "dead"
    backend: str = "cuda"            # "cuda" | "serial" | "cpp" | "cpp-par"
    mesh_shape: Optional[Tuple[int, int]] = None  # only None or (1, 1) here
    workers: int = 0                 # native backend threads; 0 = auto
    comm_every: int = 1              # cuda: generations per kernel pass (1..16)
    overlap: bool = False            # refused: multi-GPU slice
    sparse_tile: int = 0             # cuda: sparse tile side in cells; 0 = dense

    def __post_init__(self):
        if self.rows <= 0 or self.cols <= 0:
            raise ConfigError(f"grid size must be positive, got {self.rows}x{self.cols}")
        if self.steps < 0:
            raise ConfigError(f"steps must be >= 0, got {self.steps}")
        if self.snapshot_every < 0:
            raise ConfigError(f"snapshot_every must be >= 0, got {self.snapshot_every}")
        if self.boundary not in ("periodic", "dead"):
            raise ConfigError(f"boundary must be 'periodic' or 'dead', got {self.boundary!r}")
        if self.backend not in BACKENDS:
            raise ConfigError(
                f"backend must be one of {'/'.join(BACKENDS)}, got {self.backend!r}"
            )
        if not 1 <= self.comm_every <= 16:
            raise ConfigError(f"comm_every must be in 1..16, got {self.comm_every}")
        if self.comm_every > 1 and self.backend != "cuda":
            raise ConfigError(
                f"comm_every applies to the cuda backend only "
                f"(got backend={self.backend!r})"
            )
        if self.comm_every > 1 and 0 in self.rule.birth:
            raise ConfigError("comm_every > 1 requires a rule without birth-on-0")
        if self.mesh_shape is not None and tuple(self.mesh_shape) != (1, 1):
            raise ConfigError(
                f"mesh_shape {tuple(self.mesh_shape)}: the port runs one "
                f"device; multi-GPU meshes are ROADMAP queue 1 item 13"
            )
        if self.overlap:
            raise ConfigError(
                "overlap needs a device mesh; multi-GPU meshes are ROADMAP "
                "queue 1 item 13"
            )
        if self.sparse_tile < 0:
            raise ConfigError(f"sparse_tile must be >= 0, got {self.sparse_tile}")
        if self.sparse_tile:
            if self.backend != "cuda":
                raise ConfigError("sparse_tile applies to the cuda backend only")
            if self.comm_every != 1:
                raise ConfigError(
                    "sparse_tile requires comm_every=1 (the dirty map is "
                    "maintained per generation)")
            if self.rows % self.sparse_tile or self.cols % self.sparse_tile:
                raise ConfigError(
                    f"sparse_tile {self.sparse_tile} must divide the grid "
                    f"({self.rows}x{self.cols})")
            if self.sparse_tile < self.rule.radius:
                raise ConfigError(
                    f"sparse_tile {self.sparse_tile} smaller than the rule "
                    f"radius {self.rule.radius} (one-ring dilation would "
                    f"miss changes)")
        if self.backend == "cuda":
            validate_size(self.rows, self.cols,
                          self.rule.radius * self.comm_every)

    @property
    def cells(self) -> int:
        return self.rows * self.cols

    def validate_strict(self, effective_mesh: Optional[Tuple[int, int]] = None) -> None:
        """Enforce the reference's exact preconditions (``main.cpp:195``):
        square grid, square mesh, divisibility, tile >= 4 cells/side.

        ``effective_mesh`` is the decomposition the run will actually use
        (the cpp-par tile plan; one device, (1, 1), for every other
        backend) — strict mode must judge what runs, so when provided it
        wins over ``mesh_shape``; with neither, the one device's (1, 1)."""
        if self.rows != self.cols:
            raise ConfigError("strict mode: grid must be square")
        mesh = effective_mesh if effective_mesh is not None else (
            self.mesh_shape or (1, 1))
        mi, mj = mesh
        p = mi * mj
        z = math.isqrt(p)
        if z * z != p or mi != mj:
            raise ConfigError(
                f"strict mode: device count must be a perfect square mesh "
                f"(effective mesh {mi}x{mj})"
            )
        if self.rows % mi:
            raise ConfigError("strict mode: mesh must divide rows")
        if self.rows // mi < 4:
            raise ConfigError("strict mode: tile must be >= 4 cells per side")


def plan_signature(config: GolConfig, mesh_shape: Tuple[int, int],
                   segments=()) -> tuple:
    """Hashable key of everything an engine depends on: the EngineCache
    key (``mpi_tpu_torch.serve``), the reference's tuple field for field
    (``SIGNATURE_FIELDS``).  Two configs with equal signatures share one
    :class:`~mpi_tpu_torch.backends.cuda.Engine`.

    Deliberately EXCLUDES ``steps``, ``snapshot_every`` and ``seed``:
    none of them reach the stepper (seed only picks the initial grid; the
    step plan only picks which segment lengths are warmed, and those are
    carried separately as the sorted distinct ``segments`` set).
    ``mesh_shape`` is the resolved shape, always (1, 1) on one device, and
    ``Rule`` is a frozen dataclass of frozensets, so the whole tuple
    hashes."""
    return (
        config.rows, config.cols, config.rule, config.boundary,
        config.backend, tuple(mesh_shape), config.comm_every,
        bool(config.overlap), tuple(sorted(set(segments))),
        config.sparse_tile,
    )


# what each position of the plan_signature tuple holds, in order
SIGNATURE_FIELDS = (
    "rows", "cols", "rule", "boundary", "backend", "mesh_shape",
    "comm_every", "overlap", "segments", "sparse_tile",
)


def plan_segments(steps: int, snapshot_every: int) -> List[int]:
    """Split ``steps`` into evolution-segment lengths between snapshot
    points (the same plan as the reference, so snapshot series align)."""
    if snapshot_every <= 0 or snapshot_every >= steps:
        return [steps] if steps else []
    full, rem = divmod(steps, snapshot_every)
    return [snapshot_every] * full + ([rem] if rem else [])
