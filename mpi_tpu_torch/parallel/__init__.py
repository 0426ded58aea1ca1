"""Distributed execution: device mesh, halo exchange, sharded steppers."""

from mpi_tpu_torch.parallel.mesh import make_mesh
from mpi_tpu_torch.parallel.halo import exchange_halo
from mpi_tpu_torch.parallel.policy import choose_comm_policy
from mpi_tpu_torch.parallel.step import (
    make_sharded_stepper,
    sharded_init,
    make_sharded_bit_stepper,
    make_sharded_ltl_stepper,
    sharded_bit_init,
    sharded_unpack,
)

__all__ = [
    "make_mesh",
    "exchange_halo",
    "choose_comm_policy",
    "make_sharded_stepper",
    "sharded_init",
    "make_sharded_bit_stepper",
    "make_sharded_ltl_stepper",
    "sharded_bit_init",
    "sharded_unpack",
]
