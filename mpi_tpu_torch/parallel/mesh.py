"""Mesh shapes: the port's copy of ``mpi_tpu.parallel.mesh.choose_mesh_shape``.

The port runs one device, so only the pure factorisation is here: the
``cpp-par`` backend plans its worker tiles with it (``backends/cpp.py``).
Device meshes are ROADMAP queue 1 item 13."""

from __future__ import annotations

import math
from typing import Tuple


def choose_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Most-square 2D factorization of n (the ``MPI_Dims_create`` analog).

    Prefers shapes like (2,4) over (1,8): a squarer mesh halves halo bytes
    per shard at large grids (perimeter vs area).
    """
    best = (1, n_devices)
    for a in range(1, math.isqrt(n_devices) + 1):
        if n_devices % a == 0:
            best = (a, n_devices // a)
    return best
