"""mpi_tpu_torch: the Game-of-Life / stencil engine on one NVIDIA GPU, in
PyTorch with hand-written CUDA kernels.

A port of ``mpi_tpu`` (JAX on a TPU), which stays beside it as the
reference: for the same rule, boundary, seed, shape and step count the two
produce bit-identical grids and byte-identical ``.gol`` files.  The port
imports nothing from ``mpi_tpu`` and no JAX.

The port runs one device: hash init, K-generation passes of one of three
hand-written kernels, snapshots and timing reports.  K1 (``csrc/bitlife.cu``)
steps radius-1 rules on packed 32-cell words, K3 (``csrc/bitltl.cu``)
Larger-than-Life rules on bit planes of packed words, and K2
(``csrc/stencil.cu``) any rule on dense uint8 cells at any width
(``backends/cuda.py:select_engine``).  A width that is not a whole number
of words runs on K1 or K3 padded to one (``plan_pad_width``; a periodic
grid's seam columns are recomputed on a thin band, ``parallel/seam.py``),
and ``Engine.step_batched`` steps a batch of boards with one launch a
pass.  Entry points run on the GPU unless the caller asks for the CPU.
"""

from mpi_tpu_torch.backends.cuda import (
    Engine,
    build_engine,
    plan_pad_width,
    run_cuda,
    select_engine,
)
from mpi_tpu_torch.config import ConfigError, GolConfig
from mpi_tpu_torch.models.rules import (
    BOSCO,
    DAY_AND_NIGHT,
    HIGHLIFE,
    LIFE,
    SEEDS,
    Rule,
    rule_from_name,
)

__version__ = "0.1.0"

__all__ = [
    "Engine",
    "build_engine",
    "plan_pad_width",
    "run_cuda",
    "select_engine",
    "ConfigError",
    "GolConfig",
    "Rule",
    "LIFE",
    "HIGHLIFE",
    "SEEDS",
    "DAY_AND_NIGHT",
    "BOSCO",
    "rule_from_name",
]
