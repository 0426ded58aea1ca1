"""The plan tuner on a device mesh (``tune_plan`` and ``python -m
mpi_tpu_torch.tune --mesh``, ``build_engine(tune=, blocks=)`` on a mesh,
a tuned mesh session) on the CPU's virtual devices, beside the
reference's ``mpi_tpu.tune`` on the same 1x2 request: the cache key and
base dict (the backend ``"cuda"`` against ``"tpu"`` the one difference),
the candidate labels, the winner-side halo-slab bless (the reference
walks a jaxpr for its ppermutes, the port reads the launch verifier's
exchange records) and the boards a tuned plan steps.  A slab of the wrong
depth fails the bless, in the bless alone and in a sweep."""

from __future__ import annotations

import json

import numpy as np
import pytest

import mpi_tpu.config as ref_config
import mpi_tpu.tune as ref_tune
from mpi_tpu.backends.serial_np import evolve_np
from mpi_tpu.backends.tpu import build_engine as ref_build_engine
from mpi_tpu.models.rules import rule_from_name as ref_rule
from mpi_tpu.parallel.mesh import make_mesh as ref_make_mesh
from mpi_tpu.tune import cache as ref_cache
from mpi_tpu.tune import space as ref_space
from mpi_tpu.tune import tuner as ref_tuner
from mpi_tpu_torch import tune
from mpi_tpu_torch.backends.cuda import build_engine
from mpi_tpu_torch.backends.cuda_mesh import MeshEngine
from mpi_tpu_torch.config import ConfigError, GolConfig
from mpi_tpu_torch.models.rules import rule_from_name
from mpi_tpu_torch.parallel import halo
from mpi_tpu_torch.parallel.halo import exchange_halo_rc
from mpi_tpu_torch.serve.session import SessionManager
from mpi_tpu_torch.tune import cache as port_cache
from mpi_tpu_torch.tune import space as port_space
from mpi_tpu_torch.tune import tuner as port_tuner
from mpi_tpu_torch.tune.__main__ import main as tune_main
from mpi_tpu_torch.utils.hashinit import init_tile_np

PLATFORM = "p:kind:1"
MESH = (1, 2)


def _pair(rule="life", **kw):
    """The same request on a 1x2 mesh as the port's and the reference's
    config."""
    base = dict(rows=64, cols=64, steps=0, seed=3, mesh_shape=MESH)
    base.update(kw)
    ours = GolConfig(rule=rule_from_name(rule), backend="cuda", **base)
    ref = ref_config.GolConfig(rule=ref_rule(rule), backend="tpu", **base)
    return ours, ref


@pytest.mark.parametrize("rule,kw", [
    ("life", {}), ("life", dict(boundary="dead")), ("bosco", {}),
    ("R2,B10-13,S8-12", dict(comm_every=2)),
    ("life", dict(rows=128, cols=64, mesh_shape=(2, 1))),
    ("life", dict(cols=128, mesh_shape=(2, 2), overlap=True)),
])
def test_mesh_key_base_and_candidates_equal_the_references(rule, kw):
    ours, ref = _pair(rule, **kw)
    mesh = ours.mesh_shape
    a, b = port_cache.base_dict(ours, mesh), ref_cache.base_dict(ref, mesh)
    assert (a.pop("backend"), b.pop("backend")) == ("cuda", "tpu")
    assert a == b and a["mesh"] == list(mesh)
    ka = port_cache.tune_key(ours, mesh, PLATFORM).split("|")
    kb = ref_cache.tune_key(ref, mesh, PLATFORM).split("|")
    assert (ka[5], kb[5]) == ("cuda", "tpu")
    assert ka[:5] + ka[6:] == kb[:5] + kb[6:]
    assert f"mesh{mesh[0]}x{mesh[1]}" in ka
    for batch in (False, True):
        got = [c.label for c in port_space.candidates(
            ours, mesh, include_batch=batch, device="cpu")]
        want = [c.label for c in ref_space.candidates(
            ref, mesh, include_batch=batch)]
        assert got == want
    # the cache's --check path rebuilds the entry under the mesh rules
    cfg, m = port_cache.config_from_base(port_cache.base_dict(ours, mesh))
    assert m == mesh and cfg.mesh_shape == mesh


def test_infeasible_mesh_plans_are_refused_like_the_reference():
    """A plan whose halo the shards cannot carry is not a candidate:
    ``validate_mesh`` on the mesh, where one device asks only the ghost
    ring's size."""
    ours, ref = _pair(rows=16, cols=64, mesh_shape=(2, 1))
    got = [c.label for c in port_space.candidates(ours, (2, 1),
                                                  device="cpu")]
    want = [c.label for c in ref_space.candidates(ref, (2, 1))]
    assert got == want == ["default", "comm_every=2"]
    with pytest.raises(ConfigError, match="too small for a 4-deep halo"):
        port_cache.validate_plan(ours, (2, 1), {"comm_every": 4})


@pytest.mark.parametrize("k", [2, 4])
def test_slab_bless_agrees_with_the_references(k):
    ours, ref = _pair(comm_every=k)
    board = np.random.default_rng(k).integers(0, 2, (64, 64),
                                              dtype=np.uint8)
    eng = build_engine(ours, device="cpu")
    reng = ref_build_engine(ref, mesh=ref_make_mesh(MESH))
    got = port_tuner._slab_depths_ok(eng, eng.init_grid(initial=board), k)
    want = ref_tuner._slab_depths_ok(reng, reng.init_grid(initial=board), k)
    assert got == want == (True, "")


def test_slab_of_the_wrong_depth_fails_the_bless():
    """A stepper that ships a 3-deep slab where comm_every 2 on a packed
    engine allows 1, 2: the bless names the slab."""
    ours, _ = _pair(comm_every=2)
    eng = build_engine(ours, device="cpu")
    good = eng._evolve

    def widened(shards, n):
        exchange_halo_rc(shards, 1, 3, "periodic", mesh=eng.mesh)
        return good(shards, n)

    eng._evolve = widened
    ok, why = port_tuner._slab_depths_ok(eng, eng.init_grid(), 2)
    assert not ok and "depth 3 not in [1, 2]" in why


def test_sweep_on_a_mesh_blesses_and_refuses(tmp_path, monkeypatch):
    """A sweep on 1x2: every measured probe holds the oracle; the winner
    is keyed by the mesh; and with the allowed slab depths emptied, every
    comm_every > 1 candidate fails the bless and the default wins."""
    ours, ref = _pair()
    cache = tune.TuneCache(str(tmp_path / "tc.json"))
    res = tune.tune_plan(ours, device="cpu", steps=4, reps=1, cache=cache)
    assert res.mesh_shape == MESH and res.oracle == "serial-numpy"
    labels = [p.label for p in res.probes]
    assert labels == [c.label for c in ref_space.candidates(ref, MESH)]
    assert all(p.parity for p in res.probes if p.status == "measured")
    assert "|mesh1x2|" in res.key and cache.check() == []

    monkeypatch.setattr(halo, "expected_slab_depths",
                        lambda radius, comm_every, packed: {99})
    res = tune.tune_plan(ours, device="cpu", steps=4, reps=1,
                         min_speedup=0.0)
    failed = [p for p in res.probes if p.status == "failed"]
    assert [p.label for p in failed] == labels[1:]
    assert all("not in [99]" in p.detail for p in failed)
    assert res.winner == {}


def test_tuned_mesh_engine_and_session(tmp_path):
    """``build_mesh_engine(tune=)`` applies a cached winner on the mesh
    (the grid equals the untuned engine's and the reference's under the
    same plan), and a second tuned mesh session is a cache hit that
    compiles nothing."""
    ours, ref = _pair()
    plan = {"comm_every": 4}
    cache = tune.TuneCache(str(tmp_path / "tc.json"))
    cache.record(ours, MESH, plan, {}, device="cpu")
    cache.save()
    eng = build_engine(ours, device="cpu", tune=cache)
    plain = build_engine(ours, device="cpu")
    assert isinstance(eng, MeshEngine) and eng.tuned_plan == plan
    assert (eng.depth, plain.depth) == (4, 1)
    board = np.random.default_rng(5).integers(0, 2, (64, 64), dtype=np.uint8)
    got = eng.fetch(eng.step(eng.init_grid(initial=board), 11))
    np.testing.assert_array_equal(got, plain.fetch(plain.step(
        plain.init_grid(initial=board), 11)))
    rc = ref_tune.TuneCache(str(tmp_path / "ref.json"))
    rc.record(ref, MESH, plan, {}, platform=ref_tune.platform_fingerprint())
    reng = ref_build_engine(ref, mesh=ref_make_mesh(MESH), tune=rc)
    np.testing.assert_array_equal(got, np.asarray(reng.fetch(reng.step(
        reng.init_grid(initial=board), 11))))

    mgr = SessionManager(device="cpu", tune_cache=cache.path)
    try:
        spec = {"rows": 64, "cols": 64, "seed": 3, "mesh": "1x2"}
        a = mgr.create(spec)
        eng = mgr.get(a["id"]).engine
        compiles = eng.compile_count
        b = mgr.create(dict(spec, seed=4))
        assert b["cache_hit"] and mgr.get(b["id"]).engine is eng
        assert eng.compile_count == compiles
        assert eng.tuned_plan == plan
        for info, seed in ((a, 3), (b, 4)):
            mgr.step(info["id"], 9)
            np.testing.assert_array_equal(
                mgr.snapshot_array(info["id"])[0],
                evolve_np(init_tile_np(64, 64, seed), 9, ref.rule,
                          "periodic"))
            if info is a:       # the first step of 9 warms its passes once
                compiles = eng.compile_count
        assert eng.compile_count == compiles
    finally:
        mgr.shutdown()


def test_runner_on_a_mesh_writes_the_references_key(tmp_path, capsys):
    path = str(tmp_path / "tc.json")
    assert tune_main(["--mesh", "1x2", "--device", "cpu", "--rows", "64",
                      "--cols", "64", "--steps", "2", "--reps", "1",
                      "--quiet", "--cache", path]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _, ref = _pair()
    want = ref_cache.tune_key(ref, MESH, "cpu:cpu:1").replace("|tpu|",
                                                              "|cuda|")
    assert out["key"] == want and out["mesh"] == [1, 2]
    with open(path) as f:
        entry = json.load(f)["entries"][want]
    assert entry["base"]["mesh"] == [1, 2]
    assert tune_main(["--check", "--cache", path]) == 0
