"""Device meshes: the port's ``mpi_tpu.parallel.mesh``.

A mesh is a (mi, mj) grid of ``torch.device``s with the reference's axis
names: axis ``"gi"`` shards the grid's rows, ``"gj"`` its columns.  One
process drives every shard of it (the reference's ``--mesh``, one
controller over ``shard_map``); the halo exchange is a set of slice copies
between the shards' tensors (``parallel/halo.py``), device to device when
the shards sit on different cards.

Devices.  On the card, ``make_mesh`` takes ``torch.cuda.device_count()``
cards and keeps the reference's strict check: a shape that does not use
every card is refused.  An explicit device list may name one device
several times: ``make_mesh((2, 2), devices=[torch.device("cuda", 0)] * 4)``
runs four shards on one card, the port's form of the reference's virtual
devices.  On the CPU the mesh sees :data:`CPU_VIRTUAL_DEVICES` (8) virtual
devices, as the reference's tests do under their XLA flag, and a smaller
shape takes a prefix of them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

AXIS_ROWS = "gi"   # mesh axis sharding grid rows
AXIS_COLS = "gj"   # mesh axis sharding grid cols
AXES: Tuple[str, str] = (AXIS_ROWS, AXIS_COLS)

# virtual devices a CPU mesh sees: the reference's tests force 8
# (tests/conftest.py, --xla_force_host_platform_device_count=8)
CPU_VIRTUAL_DEVICES = 8


@dataclass(frozen=True)
class Mesh:
    """A 2D grid of devices.  ``devices`` is row-major, a tuple of rows;
    ``shape`` maps each axis name to its size, as a JAX mesh's does."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = AXES

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    @property
    def dims(self) -> Tuple[int, int]:
        """(mi, mj)."""
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        mi, mj = self.dims
        return mi * mj



def axis_size(mesh: Mesh, axis_name: str) -> int:
    """Size of a named mesh axis (the reference reads it inside
    ``shard_map``; here the mesh is at hand)."""
    return mesh.shape[axis_name]


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


def visible_devices(platform: str = "cuda") -> list:
    """The devices ``make_mesh`` takes when given none: every card, or the
    CPU's :data:`CPU_VIRTUAL_DEVICES` virtual devices."""
    if platform == "cpu":
        return [torch.device("cpu")] * CPU_VIRTUAL_DEVICES
    if platform != "cuda":
        raise ValueError(f"platform must be cuda or cpu, got {platform!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: a mesh runs on the GPU unless asked for "
            "the CPU (platform='cpu', or --device cpu on the command line)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the card it means (``cuda:<current>``), so that a mesh's
    devices compare equal to its shards' ``tensor.device``."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence[torch.device]] = None,
    axis_names: Tuple[str, str] = AXES,
    platform: str = "cuda",
) -> Mesh:
    """A 2D mesh over the given devices (default: every device of
    ``platform``).  ``shape=None`` picks the most-square factorization;
    (n, 1) / (1, n) give 1D row / column decomposition.  On the CPU an
    explicit smaller shape runs on a prefix of the virtual devices; on the
    card the shape must use every card, as the reference requires of real
    devices."""
    devices = [_indexed(torch.device(d)) for d in (
        devices if devices is not None else visible_devices(platform))]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if shape is None:
        shape = choose_mesh_shape(n)
    shape = (int(shape[0]), int(shape[1]))
    want = shape[0] * shape[1]
    if want < n and devices[0].type == "cpu":
        devices = devices[:want]
        n = want
    if want != n:
        raise ValueError(f"mesh shape {shape} needs {want} devices, have {n}")
    rows = tuple(tuple(devices[i * shape[1]:(i + 1) * shape[1]])
                 for i in range(shape[0]))
    return Mesh(rows, tuple(axis_names))
