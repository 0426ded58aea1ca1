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

Under a process group (``parallel/dist.py``, the CLI's ``--multihost``)
a mesh spans the ranks (:func:`world_mesh`): each shard has an owner
rank, in the reference's device order (ranks own contiguous row-major
blocks of shards, so 2 ranks x 2 shards on 2x2 give rank 0 row 0), and a
rank holds the tensors of its own shards only.  On the card each rank
brings its one card, and a shape must use every rank's; on the CPU a
shape whose size is a multiple of the world size is split evenly, up to
:data:`CPU_VIRTUAL_DEVICES` shards a rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

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
    # the rank that owns each shard, row-major like ``devices`` (None: this
    # one process owns every shard), and this process's rank
    owners: Optional[Tuple[Tuple[int, ...], ...]] = None
    rank: int = 0

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

    def owner(self, i: int, j: int) -> int:
        """The rank that holds shard (i, j)."""
        return self.rank if self.owners is None else self.owners[i][j]

    def is_local(self, i: int, j: int) -> bool:
        return self.owner(i, j) == self.rank

    def local_shards(self) -> List[Tuple[int, int]]:
        """The (i, j) of this process's shards, row-major."""
        mi, mj = self.dims
        return [(i, j) for i in range(mi) for j in range(mj)
                if self.is_local(i, j)]

    def local_devices(self) -> List[torch.device]:
        """The distinct devices of this process's shards."""
        return sorted({self.devices[i][j] for i, j in self.local_shards()},
                      key=str)

    @property
    def processes(self) -> int:
        """How many ranks hold shards of the mesh."""
        if self.owners is None:
            return 1
        return len({r for row in self.owners for r in row})

    @property
    def multiprocess(self) -> bool:
        return self.processes > 1



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
    devices.  Under a process group the mesh spans the ranks
    (:func:`world_mesh`; ``shape=None``: one device a rank)."""
    from mpi_tpu_torch.parallel import dist

    g = dist.group()
    if g is not None and g.size > 1:
        if devices is not None:
            raise ValueError("under a process group a mesh spans the "
                             "ranks' devices; it takes no device list")
        if g.device.type != platform:
            raise ValueError(f"this rank runs on {g.device.type}, not "
                             f"{platform}")
        return world_mesh(shape or choose_mesh_shape(g.size), g.size,
                          g.rank, g.devices, axis_names)
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


def mesh_over(shape: Tuple[int, int],
              devices: Optional[Sequence[torch.device]] = None,
              device=None) -> Mesh:
    """The one-process mesh of ``shape`` that a serving session or a tuning
    run builds its engine on.  (1, 1) is ``device`` itself (the card when
    None).  A larger shape spans ``devices``, by default every device of
    ``device``'s kind (every card, or the CPU's virtual devices); a list
    that names one device several times gives virtual shards of it, and a
    smaller shape a prefix, as the CPU's virtual devices do."""
    dev = torch.device("cuda" if device is None else device)
    shape = (int(shape[0]), int(shape[1]))
    if devices is None or shape == (1, 1):
        # raises when the card is asked for and absent
        every = visible_devices(dev.type)
        devices = [dev] if shape == (1, 1) else every
    elif len(set(devices)) == 1:
        devices = list(devices)[:shape[0] * shape[1]]
    return make_mesh(shape, devices=devices, platform=dev.type)


def world_mesh(shape: Tuple[int, int], processes: int, rank: int,
               devices: Sequence[torch.device],
               axis_names: Tuple[str, str] = AXES) -> Mesh:
    """The mesh of a process group of ``processes`` ranks, seen from rank
    ``rank``; ``devices`` holds every rank's device, by rank.  The ranks
    own contiguous row-major blocks of shards, the reference's device
    order (its ``jax.devices()`` lists process 0's devices first, and its
    CPU mesh reshapes them row-major).  On the card a shape needs one
    device a rank; on the CPU its size must be a multiple of
    ``processes``, up to :data:`CPU_VIRTUAL_DEVICES` shards a rank."""
    mi, mj = int(shape[0]), int(shape[1])
    want = mi * mj
    if len(devices) != processes:
        raise ValueError(f"{len(devices)} devices for {processes} ranks")
    if devices[0].type == "cpu":
        have = processes * CPU_VIRTUAL_DEVICES
        if want > have:
            raise ValueError(f"mesh shape {(mi, mj)} needs {want} devices, "
                             f"have {have}")
        if want % processes:
            raise ValueError(f"mesh {(mi, mj)} cannot be split over "
                             f"{processes} processes ({want} shards)")
    elif want != processes:
        raise ValueError(f"mesh shape {(mi, mj)} needs {want} devices, have "
                         f"{processes}")
    per = want // processes
    owners = tuple(tuple((i * mj + j) // per for j in range(mj))
                   for i in range(mi))
    rows = tuple(tuple(devices[r] for r in row) for row in owners)
    return Mesh(rows, tuple(axis_names), owners=owners, rank=rank)
