"""``--comm-every auto`` on one device: the port's policy
(``mpi_tpu_torch/parallel/policy.py``) against the reference's
``mpi_tpu.parallel.policy.resolve_auto`` with the fused kernels enabled
off-TPU (``MPI_TPU_PALLAS_INTERPRET=1``), on the shapes where the TPU
predicates and the port's routing agree, with the rows where they differ
pinned on their own, and the CLI's ``auto`` end to end."""

import dataclasses

import numpy as np
import pytest

from mpi_tpu.config import GolConfig as JaxConfig
from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu.parallel.policy import resolve_auto as jax_resolve_auto
from mpi_tpu_torch import golio
from mpi_tpu_torch.backends import cuda as port
from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.cli import main as port_main
from mpi_tpu_torch.config import GolConfig
from mpi_tpu_torch.models.rules import LIFE, rule_from_name
from mpi_tpu_torch.parallel.policy import (
    SINGLE_DEVICE_PALLAS_GENS, resolve_auto,
)
from mpi_tpu_torch.utils.hashinit import init_tile_np


def _both(monkeypatch, rows, cols, rule, boundary):
    monkeypatch.setenv("MPI_TPU_PALLAS_INTERPRET", "1")
    ref = jax_resolve_auto(JaxConfig(
        rows=rows, cols=cols, steps=1, rule=jax_rule_from_name(rule),
        boundary=boundary, backend="tpu", mesh_shape=(1, 1)), (1, 1))[0]
    mine = resolve_auto(GolConfig(rows=rows, cols=cols, steps=1,
                                  rule=rule_from_name(rule),
                                  boundary=boundary))
    return ref, mine


@pytest.mark.parametrize("rows,cols,rule,boundary,k", [
    (64, 4096, "life", "periodic", 8),
    (64, 4096, "life", "dead", 8),
    (8, 4096, "life", "periodic", 8),
    (64, 4096, "highlife", "dead", 8),
    (64, 4096, "B03/S23", "periodic", 1),   # birth on 0: depth 1 only
    (64, 4096, "bosco", "periodic", 1),     # K3 keeps depth 1
    (64, 4096, "R2,B10-13,S8-12", "periodic", 1),
    (64, 8192, "R3,B20-25,S18-30", "periodic", 1),
    (64, 4096, "R7,B80-100,S75-119", "periodic", 1),
])
def test_auto_matches_the_reference_where_the_predicates_agree(
        monkeypatch, rows, cols, rule, boundary, k):
    assert _both(monkeypatch, rows, cols, rule, boundary) == (k, k)


@pytest.mark.parametrize("rows,cols,rule,boundary,ref_k,port_k", [
    # K1 serves widths the TPU kernel's 128-word lanes refuse
    (64, 256, "life", "periodic", 1, 8),
    (64, 100, "life", "dead", 1, 8),
    (64, 4000, "life", "dead", 1, 8),
    (64, 100, "life", "periodic", 1, 8),
    # K2 at depth 1 (the seam band cannot serve 18 < 4 x 5): its deepest
    (64, 18, "bosco", "periodic", 1, 2),
    # K3 keeps depth 1 where the reference's dense kernel takes the run
    (64, 256, "bosco", "periodic", 2, 1),
    (64, 128, "bosco", "dead", 2, 1),
    (64, 256, "R2,B10-13,S8-12", "periodic", 8, 1),
])
def test_auto_rows_where_the_port_differs(monkeypatch, rows, cols, rule,
                                          boundary, ref_k, port_k):
    assert _both(monkeypatch, rows, cols, rule, boundary) == (ref_k, port_k)


@pytest.mark.parametrize("rows,cols", [(16, 3), (4, 4096)])
def test_auto_on_grids_under_the_deepest_halo(monkeypatch, rows, cols):
    # the reference refuses these (its depth-8 config is under the halo);
    # the port takes K2's deepest admitted depth at 16x3, 1 on K1 at 4x4096
    with pytest.raises(Exception, match="ghost"):
        _both(monkeypatch, rows, cols, "life", "periodic")
    k = resolve_auto(GolConfig(rows=rows, cols=cols, steps=1))
    assert k == (2 if cols == 3 else 1)


def test_auto_never_moves_a_packed_run_onto_k2():
    for cols, rule in ((20, "life"), (64, "bosco"), (100, "R2,B10-13,S8-12")):
        cfg = GolConfig(rows=64, cols=cols, steps=1, rule=rule_from_name(rule))
        k = resolve_auto(cfg)
        base = port.select_engine(cfg)
        assert base in ("bit", "ltl")
        assert port.select_engine(dataclasses.replace(cfg, comm_every=k)) \
            == base


@pytest.mark.parametrize("rows,cols,rule,boundary,k", [
    (64, 256, "life", "periodic", SINGLE_DEVICE_PALLAS_GENS),  # K1
    (64, 256, "B03/S23", "periodic", 1),  # birth on 0, even on K1
    (64, 256, "B03/S23", "dead", 1),
    (64, 18, "bosco", "periodic", 2),     # K2: its deepest, 2 x 5 <= 16
    (64, 7, "R2,B10-13,S8-12", "periodic", 2),   # K2, the deepest it admits
    (64, 256, "bosco", "dead", 1),        # K3
])
def test_resolve_auto_single_device_table(rows, cols, rule, boundary, k):
    assert resolve_auto(GolConfig(rows=rows, cols=cols, steps=1,
                                  rule=rule_from_name(rule),
                                  boundary=boundary)) == k


def test_cli_comm_every_auto(tmp_path, capsys):
    d = str(tmp_path)
    assert port_main(["64", "100", "8", "8", "--save", "--device", "cpu",
                      "--comm-every", "auto", "--out-dir", d, "--name",
                      "auto", "--seed", "5"]) == 0
    assert "comm policy auto: comm_every=8" in capsys.readouterr().out
    np.testing.assert_array_equal(
        golio.load_snapshot(d, "auto", 8),
        evolve_np(init_tile_np(64, 100, seed=5), 8, LIFE, "periodic"))
    assert port_main(["64", "256", "8", "8", "--backend", "serial",
                      "--comm-every", "auto", "--out-dir", d,
                      "--quiet"]) == 2
    assert "cuda backend only" in capsys.readouterr().err
    assert port_main(["64", "256", "8", "8", "--device", "cpu",
                      "--comm-every", "nope", "--out-dir", d,
                      "--quiet"]) == 2
