"""Run configuration of the port: the single-device subset of
``mpi_tpu.config``.

The fields keep the reference's names and meanings.  What no kernel of
the port serves yet is refused here with a :class:`ConfigError` that names
the ROADMAP item which brings it, rather than run on a slower path: device
meshes, ``overlap``, ``sparse_tile``, and on the ``cuda`` backend a
``comm_every`` deeper than kernel K2's halo (comm_every x radius >
``cuda_stencil.MAX_DEPTH``), which the packed kernels, shallower still,
cannot take either, and which the reference serves with its 1x1-mesh
stepper (ROADMAP queue 1 item 13).  Every other rule and width runs on
one of kernels K1, K2 and K3 (``backends/cuda.py:select_engine``, padded
widths included); the ``serial`` oracle serves any rule and width.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from mpi_tpu_torch.models.rules import LIFE, Rule
from mpi_tpu_torch.ops.cuda_stencil import MAX_DEPTH as MAX_DENSE_DEPTH

WORD = 32  # cells per packed word
BACKENDS = ("cuda", "serial")


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
    backend: str = "cuda"            # "cuda" | "serial"
    mesh_shape: Optional[Tuple[int, int]] = None  # only None or (1, 1) here
    comm_every: int = 1              # cuda: generations per kernel pass (1..16)
    overlap: bool = False            # refused: multi-GPU slice
    sparse_tile: int = 0             # refused: activity-gated slice

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
        if self.sparse_tile:
            raise ConfigError(
                "sparse_tile: activity-gated stepping is ROADMAP queue 1 "
                "item 10"
            )
        if self.backend == "cuda":
            depth = self.rule.radius * self.comm_every
            if depth > MAX_DENSE_DEPTH:
                raise ConfigError(
                    f"comm_every {self.comm_every} x radius "
                    f"{self.rule.radius} = {depth} > {MAX_DENSE_DEPTH}: the "
                    f"dense kernel K2 blocks at most {MAX_DENSE_DEPTH} cells "
                    f"of halo and the packed kernels fewer; the 1x1-mesh "
                    f"stepper that would serve it is ROADMAP queue 1 item 13"
                )
            validate_size(self.rows, self.cols,
                          self.rule.radius * self.comm_every)

    def validate_strict(self) -> None:
        """The reference's strict preconditions for a one-device run:
        square grid, tile >= 4 cells per side."""
        if self.rows != self.cols:
            raise ConfigError("strict mode: grid must be square")
        if self.rows < 4:
            raise ConfigError("strict mode: tile must be >= 4 cells per side")


def plan_segments(steps: int, snapshot_every: int) -> List[int]:
    """Split ``steps`` into evolution-segment lengths between snapshot
    points (the same plan as the reference, so snapshot series align)."""
    if snapshot_every <= 0 or snapshot_every >= steps:
        return [steps] if steps else []
    full, rem = divmod(steps, snapshot_every)
    return [snapshot_every] * full + ([rem] if rem else [])
