"""comm_every x r beyond kernel K2's 16-cell halo in the port, on the CPU:
the reference serves it on one device with its 1x1-mesh stepper, and the
port with K2 passes of ⌊16/r⌋ generations.  ``run_cuda`` (``device="cpu"``,
K2's plain version) against ``run_tpu`` on XLA:CPU and the serial oracle,
bit for bit, with the pass depths, the warm-up depths, the notes and the
kernel calls as planned; and the CLI's ``.gol`` files against the oracle's."""

import filecmp
import os

import numpy as np
import pytest

from mpi_tpu.backends.tpu import run_tpu
from mpi_tpu.config import GolConfig as JaxConfig
from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu_torch.backends import cuda as port
from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.cli import main as port_main
from mpi_tpu_torch.config import ConfigError, GolConfig
from mpi_tpu_torch.models.rules import rule_from_name
from mpi_tpu_torch.parallel.policy import resolve_auto
from mpi_tpu_torch.utils.hashinit import init_tile_np

R3 = "R3,B20-25,S18-30"

# (rule, comm_every, the pass depth ⌊16/r⌋)
DEEP = [("bosco", 4, 3), ("bosco", 5, 3), (R3, 6, 5), ("R2,B10-13,S8-12", 9, 8)]


@pytest.mark.parametrize("boundary", ["periodic", "dead"])
@pytest.mark.parametrize("rule,comm_every,depth", DEEP,
                         ids=["bosco-4", "bosco-5", "r3-6", "r2-9"])
def test_run_cuda_matches_run_tpu_and_the_oracle(rule, comm_every, depth,
                                                 boundary):
    kw = dict(rows=64, cols=64, steps=23, snapshot_every=10, seed=3,
              boundary=boundary, comm_every=comm_every)
    want = run_tpu(JaxConfig(backend="tpu", mesh_shape=(1, 1),
                             rule=jax_rule_from_name(rule), **kw))
    snaps = []
    got = port.run_cuda(GolConfig(rule=rule_from_name(rule), **kw),
                        snapshot_cb=lambda it, tiles: snaps.append(it),
                        device="cpu")
    np.testing.assert_array_equal(got, want)
    oracle = evolve_np(init_tile_np(64, 64, 3), 23, rule_from_name(rule),
                       boundary)
    np.testing.assert_array_equal(got, oracle)
    assert snaps == [0, 10, 20, 23]


@pytest.mark.parametrize("rule,comm_every,depth", DEEP,
                         ids=["bosco-4", "bosco-5", "r3-6", "r2-9"])
def test_engine_runs_passes_of_the_deepest_k2_depth(rule, comm_every, depth,
                                                    monkeypatch):
    calls = []
    kid, kernel, refusal = port.KERNELS["dense"]

    def counted(grid, rule, boundary, gens, **kw):
        calls.append(gens)
        return kernel(grid, rule, boundary, gens, **kw)

    monkeypatch.setitem(port.KERNELS, "dense", (kid, counted, refusal))
    cfg = GolConfig(rows=64, cols=64, steps=0, rule=rule_from_name(rule),
                    comm_every=comm_every)
    assert port.select_engine(cfg) == "dense"
    assert port.pass_depth(cfg) == depth
    eng = port.build_engine(cfg, device="cpu")
    assert (eng.kind, eng.depth, eng.depths) == \
        ("dense", depth, list(range(1, depth + 1)))
    assert any(f"passes of depth {depth}" in n for n in eng.notes)
    g = eng.step(eng.init_grid(seed=2), 23)
    full, rem = divmod(23, depth)
    assert calls == [depth] * full + [rem] * bool(rem)
    np.testing.assert_array_equal(
        eng.fetch(g), evolve_np(init_tile_np(64, 64, 2), 23,
                                rule_from_name(rule), "periodic"))


def test_run_cuda_warms_only_the_depths_it_runs(monkeypatch):
    built = []
    real = port.build_engine

    def spy(config, device=None, depths=None, **kw):
        eng = real(config, device=device, depths=depths, **kw)
        built.append(eng)
        return eng

    monkeypatch.setattr(port, "build_engine", spy)
    cfg = GolConfig(rows=64, cols=64, steps=23, snapshot_every=10,
                    rule=rule_from_name("bosco"), comm_every=4)
    port.run_cuda(cfg, snapshot_cb=lambda it, tiles: None, device="cpu")
    # segments 10, 10, 3 at depth 3: passes of 3 and remainders of 1
    assert built[0].depths == [1, 3]


@pytest.mark.parametrize("rule,comm_every", [("bosco", 3), ("life", 16),
                                             ("R2,B10-13,S8-12", 4),
                                             ("R2,B10-13,S8-12", 8)])
def test_configs_within_the_halo_keep_their_depth(rule, comm_every):
    cfg = GolConfig(rows=64, cols=64, steps=0, rule=rule_from_name(rule),
                    comm_every=comm_every)
    eng = port.build_engine(cfg, device="cpu")
    assert eng.depth == port.pass_depth(cfg) == comm_every
    assert not any("passes of depth" in n for n in eng.notes)


def test_size_check_keeps_the_references_ghost_ring():
    # the reference's 1x1-mesh stepper needs r x comm_every cells a side
    with pytest.raises(ConfigError, match="ghost"):
        GolConfig(rows=16, cols=64, steps=1, rule=rule_from_name("bosco"),
                  comm_every=4)
    GolConfig(rows=20, cols=20, steps=1, rule=rule_from_name("bosco"),
              comm_every=4)


def test_auto_policy_keeps_its_depth_guard():
    # the guard g x r <= 16 stays: Bosco on K2 at depth 1 picks 2, never 4
    cfg = GolConfig(rows=64, cols=18, steps=1, rule=rule_from_name("bosco"))
    assert port.select_engine(cfg) == "dense"
    assert resolve_auto(cfg) == 2


@pytest.mark.parametrize("size,rule,comm", [(64, "bosco", "4"),
                                            (50, "bosco", "5"),
                                            (64, R3, "6")])
@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_cli_gol_files_equal_the_serial_oracle(size, rule, comm, boundary,
                                               tmp_path):
    common = [str(size), str(size), "4", "9", "--save", "--seed", "5",
              "--rule", rule, "--boundary", boundary, "--quiet", "--name", "n"]
    cu, ser = str(tmp_path / "cu"), str(tmp_path / "se")
    assert port_main(common + ["--out-dir", cu, "--comm-every", comm,
                               "--device", "cpu"]) == 0
    assert port_main(common + ["--out-dir", ser, "--backend", "serial"]) == 0
    names = sorted(f for f in os.listdir(ser) if f.endswith(".gol"))
    _, mismatch, errors = filecmp.cmpfiles(ser, cu, names, shallow=False)
    assert len(names) == 5 and not mismatch and not errors  # master + 4
