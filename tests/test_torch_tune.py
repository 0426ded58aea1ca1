"""The port's plan tuner (``mpi_tpu_torch/tune``, ``config.apply_plan``,
``build_engine(tune=, blocks=)``, the serve layer's ``tune_cache`` and the
one-shot CLI's ``--profile``) against the reference's ``mpi_tpu.tune`` on
the CPU, on the same inputs: cache keys and base dicts field for field
(the backend ``"cuda"`` against ``"tpu"`` the one difference),
``apply_plan``, the pruning rule, the candidate labels, a sweep's winner
and the boards both packages step under it, the cache's ``--check``
findings and the runner's exit codes, the zero-recompile serving contract,
the tuned-plans gauge and the devmem row, and the CTA-tile screens.
Candidate lists are restricted and boards 64² so the sweeps stay quick.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import mpi_tpu.config as ref_config
import mpi_tpu.tune as ref_tune
from mpi_tpu.backends.serial_np import evolve_np
from mpi_tpu.backends.tpu import build_engine as ref_build_engine
from mpi_tpu.models.rules import rule_from_name as ref_rule
from mpi_tpu.parallel.mesh import make_mesh
from mpi_tpu.tune import cache as ref_cache
from mpi_tpu.tune import tuner as ref_tuner
from mpi_tpu.tune.__main__ import main as ref_main
from mpi_tpu_torch import tune
from mpi_tpu_torch.backends.cuda import build_engine, check_blocks
from mpi_tpu_torch.config import (
    PLAN_ONLY_KEYS, SIGNATURE_FIELDS, TUNABLE_FIELDS, ConfigError, GolConfig,
    apply_plan,
)
from mpi_tpu_torch.models.rules import rule_from_name
from mpi_tpu_torch.ops import cuda_bitlife, cuda_bitltl, cuda_stencil
from mpi_tpu_torch.serve.session import SessionManager
from mpi_tpu_torch.tune import cache as port_cache
from mpi_tpu_torch.tune import tuner as port_tuner
from mpi_tpu_torch.tune.__main__ import main as tune_main

RULES = ("life", "highlife", "B36/S23", "B3/S012345678", "bosco",
         "R2,B10-13,S8-12", "R3,B20-25,S18-30")
PLATFORM = "p:kind:1"


def _pair(rule="life", **kw):
    """The same request as the port's config and the reference's."""
    base = dict(rows=64, cols=64, steps=0, seed=3)
    base.update(kw)
    ours = GolConfig(rule=rule_from_name(rule), backend="cuda", **base)
    ref = ref_config.GolConfig(rule=ref_rule(rule), backend="tpu",
                               mesh_shape=(1, 1), **base)
    return ours, ref


def _cpu_cache(tmp_path, name="tc.json"):
    return tune.TuneCache(str(tmp_path / name))


# ------------------------------------------------------------ keys


@pytest.mark.parametrize("rule,kw", [
    (rule, kw) for rule in RULES
    for kw in ({}, dict(boundary="dead"), dict(comm_every=2),
               dict(sparse_tile=32))
    # comm_every > 1 needs a rule without birth-on-0
    if not (kw.get("comm_every") and 0 in rule_from_name(rule).birth)])
def test_key_and_base_equal_the_references(rule, kw):
    ours, ref = _pair(rule, **kw)
    assert port_cache.rule_canonical(ours.rule) == \
        ref_cache.rule_canonical(ref.rule)
    a = port_cache.base_dict(ours, (1, 1))
    b = ref_cache.base_dict(ref, (1, 1))
    assert (a.pop("backend"), b.pop("backend")) == ("cuda", "tpu")
    assert a == b
    ka = port_cache.tune_key(ours, (1, 1), PLATFORM).split("|")
    kb = ref_cache.tune_key(ref, (1, 1), PLATFORM).split("|")
    assert (ka[5], kb[5]) == ("cuda", "tpu")
    assert ka[:5] + ka[6:] == kb[:5] + kb[6:]
    # the canonical rule reparses to the same rule, and rebuilds the config
    cfg, mesh = port_cache.config_from_base(port_cache.base_dict(ours, (1, 1)))
    assert (cfg.rule.birth, cfg.rule.survive, cfg.rule.radius, mesh) == \
        (ours.rule.birth, ours.rule.survive, ours.rule.radius, (1, 1))


def test_fingerprint_names_the_device():
    assert tune.platform_fingerprint("cpu") == "cpu:cpu:1"
    ours, _ = _pair()
    key = tune.tune_key(ours, (1, 1), device="cpu")
    assert key.startswith(f"sig{len(SIGNATURE_FIELDS)}|cpu:cpu:1|")
    # a winner found on one device never applies on another
    assert key != tune.tune_key(ours, (1, 1), "cuda:NVIDIA_H100:1")


def test_default_cache_path_is_the_ports(monkeypatch):
    monkeypatch.delenv("MPI_TPU_TUNE_CACHE", raising=False)
    assert tune.default_cache_path().endswith(
        os.path.join("perf", "tune_cache_torch.json"))
    assert tune.default_cache_path() != ref_tune.default_cache_path()
    monkeypatch.setenv("MPI_TPU_TUNE_CACHE", "/elsewhere.json")
    assert tune.default_cache_path() == "/elsewhere.json"


# ------------------------------------------------------------ apply_plan


@pytest.mark.parametrize("plan", [
    {}, {"comm_every": 4}, {"sparse_tile": 32}, {"blocks": [8, 8]},
    {"batch": 4}, {"comm_every": 2, "blocks": [32, 4]},
    {"rows": 128}, {"comm_every": 2, "seed": 1},
    {"sparse_tile": 48}, {"comm_every": 32},
])
def test_apply_plan_equals_the_references(plan):
    ours, ref = _pair()
    try:
        want = ref_config.apply_plan(ref, plan)
    except ref_config.ConfigError as e:
        with pytest.raises(ConfigError) as got:
            apply_plan(ours, plan)
        assert str(got.value) == str(e)
        return
    got = apply_plan(ours, plan)
    assert (got.comm_every, got.sparse_tile) == \
        (want.comm_every, want.sparse_tile)
    assert (got == ours) == (want == ref)
    assert (TUNABLE_FIELDS, PLAN_ONLY_KEYS) == \
        (ref_config.TUNABLE_FIELDS, ref_config.PLAN_ONLY_KEYS)


# ------------------------------------------------------------ pruning


@settings(max_examples=200, deadline=None)
@given(opc=st.floats(0.0, 100.0), demonstrated=st.floats(0.0, 1e15),
       best=st.floats(0.0, 1e13), margin=st.floats(0.0, 10.0))
def test_prune_rule_equals_the_references(opc, demonstrated, best, margin):
    assert tune.should_prune(opc, demonstrated, best, margin) == \
        ref_tune.should_prune(opc, demonstrated, best, margin)
    assert port_tuner.candidate_bound(opc, demonstrated, margin) == \
        ref_tuner.candidate_bound(opc, demonstrated, margin)
    # the incumbent: it demonstrated best x opc itself, so never pruned
    assert not tune.should_prune(opc, best * opc, best, margin)
    assert (port_tuner.PRUNE_MARGIN, port_tuner.ORACLE_CELL_STEPS) == \
        (ref_tuner.PRUNE_MARGIN, ref_tuner.ORACLE_CELL_STEPS)


# ------------------------------------------------------------ the space


@pytest.mark.parametrize("rule,rows,cols", [
    ("life", 64, 64), ("life", 96, 128), ("R2,B10-13,S8-12", 64, 64),
    ("bosco", 64, 64), ("B3/S012345678", 64, 64)])
@pytest.mark.parametrize("batch", [False, True])
def test_candidate_labels_equal_the_references(rule, rows, cols, batch):
    ours, ref = _pair(rule, rows=rows, cols=cols)
    a = tune.candidates(ours, (1, 1), include_batch=batch, device="cpu")
    b = ref_tune.candidates(ref, (1, 1), include_batch=batch)
    assert [(c.label, c.plan) for c in a] == [(c.label, c.plan) for c in b]
    assert not any("blocks" in c.plan for c in a + b)
    assert [c.data_dependent for c in a] == [c.data_dependent for c in b]


def test_card_candidates_propose_screened_tiles():
    """On the card the space adds K1's, K3's and K2's CTA tiles, each
    within its kernel's screen, never the default build's, at most
    MAX_BLOCK_CANDIDATES an axis."""
    life = GolConfig(rows=2048, cols=2048, steps=0)
    labels = [c.label for c in tune.candidates(life, (1, 1))]
    plain = [c for c in tune.candidates(life, (1, 1))
             if "blocks" in c.plan and "comm_every" not in c.plan]
    paired = [c for c in tune.candidates(life, (1, 1))
              if "blocks" in c.plan and "comm_every" in c.plan]
    assert 0 < len(plain) <= tune.space.MAX_BLOCK_CANDIDATES
    assert 0 < len(paired) <= tune.space.MAX_BLOCK_CANDIDATES
    assert "blocks=64x4" not in labels                 # the gens-1 default
    assert "comm_every=8,blocks=128x4" not in labels   # the gens-8 default
    for c in plain + paired:
        rows, wpl = c.plan["blocks"]
        assert cuda_bitlife.blocks_ok(rows, wpl, 2048)
    bosco = GolConfig(rows=2048, cols=2048, steps=0,
                      rule=rule_from_name("bosco"))
    tiles = [c.plan for c in tune.candidates(bosco, (1, 1))
             if "blocks" in c.plan]
    # K3 at comm_every 1; past ⌊8/5⌋ Bosco runs on K2 in passes of 3, whose
    # [rows, cols] tiles pair with the deepest comm_every
    assert tiles[:4] == [{"blocks": [32]}, {"blocks": [64]},
                         {"blocks": [128]}, {"blocks": [512]}]
    k2 = tiles[4:]
    assert 0 < len(k2) <= tune.space.MAX_BLOCK_CANDIDATES
    for plan in k2:
        assert plan["comm_every"] == 8 and plan["blocks"] != [128, 256]
        assert cuda_stencil.blocks_ok(*plan["blocks"], 5, 3, 2048)


# ------------------------------------------------------------ tile screens


@pytest.mark.parametrize("rows", cuda_bitlife.BLOCK_ROWS)
@pytest.mark.parametrize("wpl", cuda_bitlife.BLOCK_WPL)
def test_k1_screen_is_the_kernels_shared_memory(rows, wpl):
    """``(rows + 2 gens) x 32 wpl`` words at the deepest of gens <= 16,
    the attribute ``csrc/bitlife.cu:allow_shared_memory`` sets for every
    pass, against the H100's 227 KB."""
    most = max((rows + 2 * g) * 32 * wpl * 4 for g in range(1, 17))
    assert cuda_bitlife.max_tile_bytes(rows, wpl) == most \
        == (rows + 32) * 128 * wpl
    assert cuda_bitlife.blocks_ok(rows, wpl) == (most <= 227 * 1024)
    assert not cuda_bitlife.blocks_ok(rows, 3)
    assert not cuda_bitlife.blocks_ok(48, wpl)
    assert cuda_bitlife.block_defines([rows, wpl]) == \
        {"K1_ROWS": rows, "K1_WPL": wpl}


@pytest.mark.parametrize("radius", range(2, 8))
def test_k3_screen_takes_every_run_length(radius):
    """K3's tile is the run of rows a warp steps: its warps hold their
    state in registers (and, deeper than one generation, their rings of
    counts in at most 36 KB of shared memory whatever the run), so every
    run length it is built with serves every grid of a radius it takes."""
    for rows in cuda_bitltl.BLOCK_ROWS:
        assert cuda_bitltl.blocks_ok(rows, radius)
        assert cuda_bitltl.blocks_ok(rows, radius, H=2**31 - 1)
        assert not cuda_bitltl.blocks_ok(rows, 1)
    assert cuda_bitltl.DEFAULT_ROWS in cuda_bitltl.BLOCK_ROWS
    assert not cuda_bitltl.blocks_ok(48, radius)
    assert cuda_bitltl.block_defines([64]) == {"K3_ROWS": 64}


@pytest.mark.parametrize("rule,kw,blocks,device", [
    ("bosco", dict(comm_every=2), [32], "cuda"),   # K2 takes [rows, cols]
    ("R2,B10-13,S8-12", dict(comm_every=8), [32], "cuda"),  # K2 past ⌊8/2⌋
    ("life", {}, [32, 4], "cpu"),                  # the CPU: no tile
    ("bosco", {}, [32], "cpu"),
    ("life", {}, [48, 4], "cuda"),                 # not a tile of K1
    ("life", {}, [512, 4], "cuda"),                # over the shared memory
    ("bosco", {}, [32, 4], "cuda"),                # K3 takes [rows]
])
def test_blocks_off_their_route_raise(rule, kw, blocks, device):
    ours, _ = _pair(rule, **kw)
    from mpi_tpu_torch.backends.cuda import plan_engine
    import torch

    with pytest.raises(ConfigError, match="blocks"):
        check_blocks(ours, plan_engine(ours)[0], torch.device(device),
                     blocks)
    if device == "cpu":
        with pytest.raises(ConfigError, match="blocks"):
            build_engine(ours, device="cpu", blocks=blocks)


@pytest.mark.parametrize("rule,kw,blocks", [
    ("bosco", dict(comm_every=2), [32, 128]),      # K2 at its own tile
    ("R2,B10-13,S8-12", dict(comm_every=8), [512, 128]),
    ("life", {}, [32, 4]),                         # K1
    ("bosco", {}, [32]),                           # K3
])
def test_blocks_on_their_route_pass(rule, kw, blocks):
    ours, _ = _pair(rule, **kw)
    from mpi_tpu_torch.backends.cuda import plan_engine
    import torch

    check_blocks(ours, plan_engine(ours)[0], torch.device("cuda"), blocks)


@pytest.mark.parametrize("backend", ["serial", "cpp", "cpp-par"])
def test_blocks_on_a_host_backend_raise(backend):
    import dataclasses

    import torch

    ours = dataclasses.replace(_pair()[0], backend=backend)
    with pytest.raises(ConfigError, match="runs no kernel"):
        check_blocks(ours, "bit", torch.device("cuda"), [32, 4])
    # and a cached tile for such a plan never validates
    with pytest.raises(ConfigError):
        port_cache.validate_plan(ours, (1, 1), {"blocks": [32, 4]})


def test_default_build_takes_no_macros():
    """Without a tile the engine launches the default build: the same
    library path as before the tuner (no macros in its hash)."""
    from mpi_tpu_torch.ops import _build

    life = rule_from_name("life")
    assert _build.rule_library_path("bit", life) == \
        _build.rule_library_path("bit", life, {})
    assert _build.rule_library_path("bit", life) != \
        _build.rule_library_path("bit", life, cuda_bitlife.block_defines(
            [32, 4]))
    eng = build_engine(GolConfig(rows=64, cols=64, steps=0), device="cpu")
    assert eng.blocks is None and eng.tuned_plan is None
    assert eng._kernel is cuda_bitlife.cuda_bit_step


# ------------------------------------------------------------ the sweep


def test_tune_plan_winner_steps_equal_to_the_references(tmp_path):
    """A restricted sweep at 64² on the CPU: every measured probe holds
    parity against the serial oracle; the winner (recorded even when it is
    the default) steps the port's board to the reference's evolve_np and
    to the JAX engine's board under the same plan."""
    ours, ref = _pair()
    cache = _cpu_cache(tmp_path)
    cands = [tune.Candidate({}, "default"),
             tune.Candidate({"comm_every": 2}, "comm_every=2"),
             tune.Candidate({"sparse_tile": 32}, "sparse_tile=32")]
    res = tune.tune_plan(ours, device="cpu", steps=4, reps=1, cache=cache,
                         cands=cands)
    assert res.oracle == "serial-numpy" and res.default_cells_per_s > 0
    measured = [p for p in res.probes if p.status == "measured"]
    assert len(measured) == 3 and all(p.parity for p in measured)
    entry = tune.TuneCache(cache.path).get(res.key)
    assert entry["plan"] == res.winner and entry["measured"]["steps"] == 4
    board = np.random.default_rng(3).integers(0, 2, (64, 64), dtype=np.uint8)
    for plan in (res.winner, {"comm_every": 2}, {"sparse_tile": 32}):
        c = _cpu_cache(tmp_path, f"{sorted(plan)}.json")
        c.record(ours, (1, 1), plan, {}, device="cpu")
        eng = build_engine(ours, device="cpu", tune=c)
        assert eng.tuned_plan == (plan or None)
        got = eng.fetch(eng.step(eng.init_grid(initial=board), 9))
        rc = ref_tune.TuneCache(str(tmp_path / "ref.json"))
        rc.record(ref, (1, 1), plan, {},
                  platform=ref_tune.platform_fingerprint())
        reng = ref_build_engine(ref, mesh=make_mesh((1, 1)), tune=rc)
        want = np.asarray(reng.fetch(reng.step(
            reng.init_grid(initial=board), 9)))
        assert np.array_equal(got, want)
        assert np.array_equal(got, evolve_np(board, 9, ref.rule,
                                             "periodic"))


def test_tune_plan_refuses_a_broken_baseline(monkeypatch, tmp_path):
    ours, _ = _pair()
    monkeypatch.setattr(
        "mpi_tpu_torch.backends.serial_np.evolve_np",
        lambda board, n, rule, boundary: 1 - board)
    with pytest.raises(AssertionError, match="serial oracle"):
        tune.tune_plan(ours, device="cpu", steps=2, reps=1,
                       cands=[tune.Candidate()])


# ------------------------------------------------------------ the cache


def _scenario(kind, path, ours, ref, ours_cache, ref_cache_):
    """Put the same state into both packages' caches."""
    if kind == "corrupt":
        for p in (path, path + ".ref"):
            with open(p, "w") as fh:
                fh.write("{not json")
        return
    if kind == "missing":
        return
    plan = {"sparse_tile": 48} if kind == "stale" else {"sparse_tile": 32}
    keys = [ours_cache.record(ours, (1, 1), plan, {}, platform=PLATFORM),
            ref_cache_.record(ref, (1, 1), plan, {}, platform=PLATFORM)]
    ours_cache.save()
    ref_cache_.save()
    if kind == "orphaned":
        for p, key in zip((path, path + ".ref"), keys):
            with open(p) as fh:
                raw = json.load(fh)
            old = key.replace(f"sig{len(SIGNATURE_FIELDS)}|", "sig3|", 1)
            raw["entries"] = {old: raw["entries"][key]}
            with open(p, "w") as fh:
                json.dump(raw, fh)


@pytest.mark.parametrize("kind,finding", [
    ("round_trip", None), ("missing", None), ("corrupt", "unreadable"),
    ("stale", "no longer validates"), ("orphaned", "no longer resolves")])
def test_cache_check_equals_the_references(tmp_path, kind, finding):
    ours, ref = _pair()
    path = str(tmp_path / "tc.json")
    _scenario(kind, path, ours, ref, tune.TuneCache(path),
              ref_tune.TuneCache(path + ".ref"))
    a, b = tune.TuneCache(path), ref_tune.TuneCache(path + ".ref")
    fa, fb = a.check(), b.check()
    assert len(fa) == len(fb) == (finding is not None)
    if finding:
        assert finding in fa[0] and finding in fb[0]
    assert (a.load_error is None) == (b.load_error is None)
    assert len(a) == len(b)
    # resolve: a good entry applies, anything else leaves the config alone
    tuned, plan = a.resolve(ours, (1, 1), PLATFORM)
    if kind == "round_trip":
        assert plan == {"sparse_tile": 32} and tuned.sparse_tile == 32
    else:
        assert plan is None and tuned == ours
    # the runner's exit codes equal the reference's
    code = tune_main(["--check", "--cache", path])
    assert code == ref_main(["--check", "--cache", path + ".ref"])
    assert code == (1 if finding else 0)
    assert tune_main(["--list", "--cache", path]) == 0


def test_corrupt_cache_is_repaired_by_a_save(tmp_path):
    ours, _ = _pair()
    path = str(tmp_path / "tc.json")
    with open(path, "w") as fh:
        fh.write("nope")
    cache = tune.TuneCache(path)
    assert cache.load_error is not None and len(cache) == 0
    cache.record(ours, (1, 1), {}, {}, device="cpu")
    cache.save()
    assert tune.TuneCache(path).load_error is None
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_a_stale_tile_is_skipped_never_fatal(tmp_path):
    """A cached CTA tile that its route no longer takes (here a CPU entry
    naming one) costs the plan, never the run."""
    ours, _ = _pair()
    cache = _cpu_cache(tmp_path)
    cache.record(ours, (1, 1), {"blocks": [32, 4]}, {}, device="cpu")
    eng = build_engine(ours, device="cpu", tune=cache)
    assert eng.tuned_plan is None and eng.blocks is None
    assert any("no longer validates" in f for f in cache.check())


def test_runner_tunes_on_the_cpu_and_refuses_meshes(tmp_path, capsys):
    path = str(tmp_path / "tc.json")
    assert tune_main(["--device", "cpu", "--rows", "64", "--cols", "64",
                      "--steps", "2", "--reps", "1", "--quiet",
                      "--cache", path]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["oracle"] == "serial-numpy" and out["probed"] >= 1
    assert out["key"].split("|")[1] == "cpu:cpu:1"
    assert tune_main(["--check", "--cache", path]) == 0
    capsys.readouterr()
    assert tune_main(["--mesh", "2x1", "--device", "cpu", "--rows", "64",
                      "--cols", "64", "--steps", "2", "--reps", "1",
                      "--quiet", "--cache", path]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mesh"] == [2, 1] and "|mesh2x1|" in out["key"]
    assert tune_main(["--check", "--cache", path]) == 0
    assert tune_main(["--mesh", "3x3", "--device", "cpu", "--rows", "96",
                      "--cols", "96", "--quiet", "--cache", path]) == 2
    assert "needs 9 devices, have 8" in capsys.readouterr().err
    assert tune_main(["--mesh", "banana", "--device", "cpu"]) == 2
    assert tune_main(["--device", "cpu", "--rows", "0", "--cache", path]) \
        == 2


# ------------------------------------------------------------ serving


def test_second_session_compiles_nothing(tmp_path):
    """The cached winner is applied on the first compile miss; a second
    same-spec session is a hit on the same tuned engine with no compile,
    and its board equals the untuned plan's."""
    ours, _ = _pair()
    cache = _cpu_cache(tmp_path)
    cache.record(ours, (1, 1), {"sparse_tile": 32}, {}, device="cpu")
    cache.save()
    mgr = SessionManager(device="cpu", batching=False, async_enabled=False,
                         tune_cache=cache.path)        # the path form
    try:
        spec = {"rows": 64, "cols": 64, "seed": 3}
        s1 = mgr.create(spec)
        e1 = mgr.get(s1["id"]).engine
        assert e1.tuned_plan == {"sparse_tile": 32}
        assert s1["tuned_plan"] == {"sparse_tile": 32}
        mgr.step(s1["id"], 4)
        compiles = e1.compile_count
        s2 = mgr.create(spec)
        assert s2["cache_hit"] is True and mgr.get(s2["id"]).engine is e1
        mgr.step(s2["id"], 4)
        assert e1.compile_count == compiles
        grid, _, _ = mgr.snapshot_array(s2["id"])
    finally:
        mgr.shutdown()
    plain = build_engine(ours, device="cpu")
    want = plain.fetch(plain.step(plain.init_grid(seed=3), 4))
    assert np.array_equal(grid, want)


def test_tuned_plans_gauge_and_devmem_row(tmp_path):
    from mpi_tpu_torch.obs import Obs

    ours, _ = _pair()
    cache = _cpu_cache(tmp_path)
    cache.record(ours, (1, 1), {"sparse_tile": 32}, {}, device="cpu")
    obs = Obs()
    mgr = SessionManager(device="cpu", batching=False, async_enabled=False,
                         tune_cache=cache, obs=obs)
    try:
        mgr.create({"rows": 64, "cols": 64, "seed": 3})
        mgr.create({"rows": 64, "cols": 48})
        obs.arm_telemetry(manager=mgr, start=False)
        obs.arm_flight(manager=mgr)
        text = obs.render_metrics()
    finally:
        mgr.shutdown()
    assert 'mpi_tpu_tuned_plans{plan="tuned"} 1' in text
    assert 'mpi_tpu_tuned_plans{plan="default"} 1' in text
    assert 'mpi_tpu_engine_cache_entries{cache="tune"} 1' in text


def test_manager_without_tune_cache_is_untouched():
    mgr = SessionManager(device="cpu", batching=False, async_enabled=False)
    try:
        s = mgr.create({"rows": 64, "cols": 64})
        assert mgr.get(s["id"]).engine.tuned_plan is None
        assert "tuned_plan" not in s and mgr.tune_cache is None
    finally:
        mgr.shutdown()


# ------------------------------------------------------------ --profile


def test_cli_profile_writes_one_chrome_trace(tmp_path):
    from mpi_tpu_torch import golio
    from mpi_tpu_torch.cli import main

    common = ["16", "64", "4", "8", "--device", "cpu", "--save", "--quiet"]
    assert main(common + ["--out-dir", str(tmp_path / "a"), "--name", "a",
                          "--profile", str(tmp_path / "trace")]) == 0
    assert main(common + ["--out-dir", str(tmp_path / "b"),
                          "--name", "b"]) == 0
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].startswith(f"trace-{os.getpid()}-")
    with open(tmp_path / "trace" / traces[0]) as fh:
        assert json.load(fh)["traceEvents"]
    assert np.array_equal(golio.assemble(str(tmp_path / "a"), "a", 8),
                          golio.assemble(str(tmp_path / "b"), "b", 8))
    for backend in ("serial", "cpp", "cpp-par"):
        assert main(["16", "64", "0", "2", "--backend", backend, "--quiet",
                     "--out-dir", str(tmp_path / "c"),
                     "--profile", str(tmp_path / "t2")]) == 2
    assert not os.path.exists(tmp_path / "t2")
