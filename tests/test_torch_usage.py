"""The port's usage ledger and cost cards (``mpi_tpu_torch/obs/ledger.py``,
``obs/cost.py``) on the CPU: the scenarios of the reference's
``tests/test_usage.py`` through ``SessionManager(device="cpu", obs=Obs())``
and the API (the reference's ``GET /usage`` is the manager's ``usage()``),
with the cost cards taken from the kernels' own counts where the
reference asks XLA: K1 and K3 cards equal ``word_ops``/``ltl_word_ops``
times words, generations and boards, K2's the instruction count of its
row loop in ``csrc/stencil.cu``."""

import os
import re
import threading

import pytest

from mpi_tpu_torch.backends import cuda as port
from mpi_tpu_torch.config import WORD, GolConfig
from mpi_tpu_torch.models.rules import BOSCO, LIFE, rule_from_name
from mpi_tpu_torch.obs import Obs
from mpi_tpu_torch.obs import cost
from mpi_tpu_torch.obs.cost import capture_card, ops_per_cell_detail
from mpi_tpu_torch.obs.ledger import UsageLedger
from mpi_tpu_torch.ops.bitlife import word_ops
from mpi_tpu_torch.ops.bitltl import ltl_word_ops
from mpi_tpu_torch.ops.stencil import dense_cell_ops
from mpi_tpu_torch.serve import EngineCache, SessionManager

CUDA_SPEC = {"rows": 64, "cols": 64, "backend": "cuda"}


@pytest.fixture()
def make_manager():
    made = []

    def make(*args, **kw):
        kw.setdefault("device", "cpu")
        mgr = SessionManager(*args, **kw)
        made.append(mgr)
        return mgr

    yield make
    for mgr in made:
        mgr.shutdown()


def _step_all_concurrently(mgr, sids, steps=1):
    """Step every session from its own thread so the microbatcher
    coalesces them; re-raises the first worker error."""
    results, errors = {}, []

    def go(sid, n):
        try:
            results[sid] = mgr.step(sid, n)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(s, steps)) for s in sids]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return results


# ------------------------------------------------------- ledger (unit)


def test_ledger_batched_split_sums_to_leader_time():
    led = UsageLedger()
    led.record("batched", "sig", 0.8,
               [(f"s{i}", 2, 8192, 100.0) for i in range(4)])
    tot = led.totals()
    assert tot["syncs"] == 1 and tot["by_kind"]["batched"] == 1
    assert tot["device_s"] == pytest.approx(0.8)
    shares = [led.session_row(f"s{i}")["device_s"] for i in range(4)]
    assert shares == pytest.approx([0.2] * 4)
    assert sum(shares) == pytest.approx(0.8)
    row = led.session_row("s0")
    assert row["dispatches"]["batched"] == 1
    assert row["mean_amortization"] == 4.0
    assert tot["generations"] == 8 and tot["cells"] == 4 * 8192
    assert tot["flops"] == pytest.approx(400.0)
    sig = led.signature_rows()["sig"]
    assert sig["syncs"] == 1 and sig["device_s"] == pytest.approx(0.8)


def test_ledger_host_time_is_not_device_time():
    led = UsageLedger()
    led.record("host", None, 0.5, [("s0", 3, 768, 0.0)])
    tot = led.totals()
    assert tot["host_s"] == pytest.approx(0.5) and tot["device_s"] == 0.0
    assert led.signature_rows()["-"]["host_s"] == pytest.approx(0.5)
    with pytest.raises(ValueError):
        led.record("warp", None, 0.1, [("s0", 1, 1, 0.0)])


# -------------------------------------------------- cost-card capture

CARD_CASES = [
    # rows, cols, rule, boundary, comm_every, kernel
    (64, 64, "life", "periodic", 1, "K1"),
    (64, 96, "highlife", "dead", 4, "K1"),
    (64, 50, "life", "periodic", 2, "K1"),         # padded, the seam band
    (64, 64, "bosco", "periodic", 1, "K3"),
    (64, 64, "R2,B10-13,S8-12", "dead", 4, "K3"),
    (64, 64, "bosco", "periodic", 3, "K2"),
    (48, 40, "R3,B9-14,S8-16", "dead", 5, "K2"),   # passes of 5
]


@pytest.mark.parametrize("rows,cols,rule,boundary,k,kid", CARD_CASES)
@pytest.mark.parametrize("batch", [0, 3])
def test_cards_count_the_kernels_instructions(rows, cols, rule, boundary, k,
                                              kid, batch):
    r = rule_from_name(rule)
    eng = port.build_engine(GolConfig(rows=rows, cols=cols, steps=0, rule=r,
                                      boundary=boundary, comm_every=k),
                            device="cpu")
    eng.sig_label = "L"
    assert eng.kernel_id == kid
    depth = 2 * k + 1                   # full passes and a remainder
    card = capture_card(eng, depth=depth, batch=batch)
    boards = batch or 1
    passes = -(-depth // eng.depth)
    if kid == "K2":
        units, per, unit_bytes = rows * cols, dense_cell_ops(r.radius), 1
    else:
        units = rows * eng.cols_eff // WORD
        per = word_ops(r) if kid == "K1" else ltl_word_ops(r)
        unit_bytes = 4
    ops = per * units * depth
    moved = 2 * unit_bytes * units * passes
    if eng.seam:
        ks = [eng.depth] * (depth // eng.depth) + [depth % eng.depth]
        ops += sum(dense_cell_ops(1) * rows * 4 * kp * kp for kp in ks if kp)
        moved += sum(2 * rows * 4 * kp for kp in ks if kp)
    assert card.source == "kernel_count" and card.sig_label == "L"
    assert (card.depth, card.batch, card.boards) == (depth, batch, boards)
    assert card.flops == ops * boards
    assert card.bytes_accessed == moved * boards
    assert card.peak_memory_bytes == 2 * unit_bytes * units * boards
    assert card.ops_per_cell(rows * cols) == pytest.approx(
        ops / (rows * cols * depth))


def _k2_row_loop_count(radius):
    """K2's instructions per row of a thread's words, read off the source
    of ``csrc/stencil.cu``: its group width, its window loads and the
    rule's byte lookups, independently of ``ops/stencil.py``."""
    src = open(os.path.join(os.path.dirname(port.__file__), os.pardir,
                            "csrc", "stencil.cu")).read()
    group = int(re.search(r"constexpr int kGroup = (\d+);", src)[1])
    m = -(-radius // 4)
    body = src[src.index("for (int i = a; i < b; ++i)"):
               src.index("__syncthreads();\n  }\n\n  // the owned tile")]
    loads = 2 * 3 + 1                   # two load_window, the centre uint4
    assert body.count("load_window<M>") == 2 and "uint4*>(src" in body
    slide = group + 2 * m               # one IADD3 per window word
    permutes = sum(1 for s in range(-radius, radius + 1) if s % 4)
    pairs = body.count("__byte_perm(total, alive[j]")
    lookups = body.count("table[")
    per_word = permutes + radius + pairs + lookups + lookups + (lookups - 1) + 1
    return loads + slide + group * per_word + 1, group * 4


@pytest.mark.parametrize("radius", range(1, 8))
def test_k2_count_is_its_row_loop_in_the_source(radius):
    per_row, cells = _k2_row_loop_count(radius)
    assert dense_cell_ops(radius) == per_row / cells
    if radius == 5:
        assert dense_cell_ops(5) == 124 / 16


def test_k2_count_refuses_radii_the_kernel_lacks():
    for r in (0, 8):
        with pytest.raises(ValueError):
            dense_cell_ops(r)


def test_cost_cards_captured_for_solo_and_batched_steps(make_manager):
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs,
                       batch_window_ms=500.0, batch_max=8)
    sids = [mgr.create(dict(CUDA_SPEC, seed=s))["id"] for s in (1, 2)]
    engine = mgr.get(sids[0]).engine
    mgr.step(sids[0], 2)                    # solo depth-2 warm-up miss
    _step_all_concurrently(mgr, sids)       # batched depth-1, B=2
    cards = {(c.depth, c.batch): c for c in engine.cost_cards()}
    assert (2, 0) in cards and (1, 2) in cards
    for c in cards.values():
        assert c.flops > 0 and c.source == "kernel_count"
        assert c.sig_label == engine.sig_label
    assert cards[(1, 2)].boards == 2
    assert cards[(1, 2)].flops == 2 * cards[(1, 0)].flops
    # warm-up HITS never re-capture (cards track misses only)
    n = len(engine.cost_cards())
    mgr.step(sids[0], 2)
    assert len(engine.cost_cards()) == n


def test_a_card_that_cannot_be_built_never_fails_a_step(make_manager,
                                                       monkeypatch):
    """Capture failing is metering failing: the card is dropped and the
    step runs (the reference's opcount fallback has no counterpart: the
    kernel counts are the one source)."""
    def boom(*a, **k):
        raise RuntimeError("no count")

    monkeypatch.setattr(cost, "capture_card", boom)
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs)
    sid = mgr.create(dict(CUDA_SPEC, seed=3))["id"]
    assert mgr.step(sid, 2)["generation"] == 2
    engine = mgr.get(sid).engine
    assert engine.cost_card(2) is None and engine.cost_cards() == []
    assert obs.ledger.totals()["flops"] == 0.0


def test_no_obs_engine_captures_nothing(make_manager):
    mgr = make_manager(EngineCache(max_size=4), obs=None)
    sid = mgr.create(dict(CUDA_SPEC, seed=4))["id"]
    mgr.step(sid, 2)
    assert mgr.get(sid).engine.cost_cards() == []


# ---------------------------------------------- attribution edge cases


def test_batched_rider_shares_sum_to_leader_dispatch_time(make_manager):
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs,
                       batch_window_ms=500.0, batch_max=8)
    sids = [mgr.create(dict(CUDA_SPEC, seed=s))["id"]
            for s in (11, 12, 13, 14)]
    _step_all_concurrently(mgr, sids)
    tot = obs.ledger.totals()
    assert tot["by_kind"]["batched"] == 1 and tot["syncs"] == 1
    leader_dur = [r["dur_s"] for r in obs.tracer.snapshot()
                  if r["name"] == "batched_dispatch"]
    assert len(leader_dur) == 1
    shares = [obs.ledger.session_row(s)["device_s"] for s in sids]
    assert sum(shares) == pytest.approx(leader_dur[0], rel=1e-6)
    for s in sids:
        row = obs.ledger.session_row(s)
        assert row["mean_amortization"] == 4.0
        assert row["generations"] == 1


def test_solo_fallback_rider_not_double_counted(make_manager):
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs,
                       batch_window_ms=500.0, batch_max=8)
    sids = [mgr.create(dict(CUDA_SPEC, seed=s))["id"] for s in (5, 6)]
    engine = mgr.get(sids[0]).engine

    def boom(boards):
        raise RuntimeError("forced stack failure")

    engine.stack_grids = boom
    _step_all_concurrently(mgr, sids)
    assert mgr.stats()["batch"]["batched_fallbacks"] == 1
    tot = obs.ledger.totals()
    assert tot["by_kind"]["batched"] == 0
    assert tot["by_kind"]["solo"] == 2
    assert tot["syncs"] == 2 and tot["generations"] == 2
    for s in sids:
        assert obs.ledger.session_row(s)["dispatches"]["solo"] == 1


def test_async_unit_chain_is_one_sync(make_manager):
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs)
    sid = mgr.create(dict(CUDA_SPEC, seed=7))["id"]
    out = mgr.ticket_result(mgr.step_async(sid, 5)["ticket"],
                            wait=True, timeout_s=120)
    assert out["result"]["generation"] == 5
    tot = obs.ledger.totals()
    assert tot["by_kind"]["unit"] == 1      # 5 rounds, ONE wait
    assert tot["generations"] == 5
    assert obs.ledger.session_row(sid)["dispatches"]["unit"] == 1
    card = mgr.get(sid).engine.cost_card(1)
    assert tot["flops"] == 5 * card.flops


def test_usage_reconciles_with_dispatch_trace_under_mixed_load(make_manager):
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs,
                       batch_window_ms=300.0, batch_max=8)
    sids = [mgr.create(dict(CUDA_SPEC, seed=s))["id"] for s in (8, 9)]
    mgr.step(sids[0], 1)                    # solo
    _step_all_concurrently(mgr, sids)       # batched
    tickets = [mgr.step_async(s, d) for s, d in zip(sids, (2, 5))]
    for t in tickets:
        mgr.ticket_result(t["ticket"], wait=True, timeout_s=120)
    tot = obs.ledger.totals()
    durs = [r["dur_s"] for r in obs.tracer.snapshot()
            if r["name"] in ("device_dispatch", "batched_dispatch",
                             "unit_round")]
    assert tot["syncs"] == len(durs)
    assert tot["device_s"] == pytest.approx(sum(durs), rel=0.01)
    assert tot["by_kind"]["solo"] >= 1
    assert tot["by_kind"]["batched"] >= 1
    assert tot["by_kind"]["unit"] >= 1
    assert tot["generations"] == 1 + 2 + 2 + 5
    assert tot["cells"] == tot["generations"] * 64 * 64
    # Life on K1: 15 instructions a word a generation, 128 words a board
    assert tot["flops"] == word_ops(LIFE) * 128 * tot["generations"]


def test_restore_from_checkpoint_resets_nothing(make_manager, tmp_path):
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs,
                       state_dir=str(tmp_path), checkpoint_every=1)
    sid = mgr.create(dict(CUDA_SPEC, seed=9))["id"]
    mgr.step(sid, 2)
    assert obs.ledger.totals()["syncs"] >= 1
    mgr.shutdown()
    obs2 = Obs()
    mgr2 = make_manager(EngineCache(max_size=4), obs=obs2,
                        state_dir=str(tmp_path))
    assert mgr2.snapshot(sid)["generation"] == 2
    assert obs2.ledger.totals()["syncs"] == 0
    assert obs2.ledger.session_row(sid) is None
    assert any(r["name"] == "restore_replay"
               for r in obs2.tracer.snapshot())
    mgr2.step(sid, 1)
    assert obs2.ledger.session_row(sid)["generations"] == 1


@pytest.mark.parametrize("backend", ["serial", "cpp", "cpp-par"])
def test_host_backend_steps_meter_host_seconds(make_manager, backend):
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs)
    sid = mgr.create({"rows": 16, "cols": 16, "backend": backend,
                      "seed": 1})["id"]
    mgr.step(sid, 3)
    tot = obs.ledger.totals()
    assert tot["by_kind"]["host"] == 1 and tot["device_s"] == 0.0
    assert tot["host_s"] > 0.0
    row = obs.ledger.session_row(sid)
    assert row["generations"] == 3 and row["flops"] == 0.0
    assert [r["name"] for r in obs.tracer.snapshot()].count("host_step") == 1


# ------------------------------------------------------- the usage readout


def test_usage_payload_shape_and_roofline(make_manager, monkeypatch):
    """Off the card the roof comes from ``MPI_TPU_ROOF_OPS_PER_S``; the
    readout's arithmetic is the reference's."""
    monkeypatch.setenv("MPI_TPU_ROOF_OPS_PER_S", "1e12")
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs)
    sid = mgr.create(dict(CUDA_SPEC, seed=21))["id"]
    mgr.step(sid, 2)
    usage = mgr.usage()
    assert usage["totals"]["syncs"] == 1
    assert sid in usage["sessions"]
    assert usage["roof_ops_per_s"] == 1e12
    (row,) = usage["signatures"]
    assert row["signature"] == mgr.get(sid).engine.sig_label
    assert row["cost_cards"] and all(
        c["flops"] > 0 and c["source"] == "kernel_count"
        for c in row["cost_cards"])
    roof = row["roofline"]
    assert roof["ops_per_cell"] == pytest.approx(word_ops(LIFE) / WORD)
    assert roof["bound_cells_per_s"] == pytest.approx(
        1e12 / roof["ops_per_cell"])
    assert roof["achieved_cells_per_s"] == pytest.approx(
        row["cells"] / row["device_s"])
    assert roof["efficiency"] == pytest.approx(
        roof["achieved_cells_per_s"] / roof["bound_cells_per_s"])
    assert roof["trip_count_suspect"] is False
    assert mgr.describe(mgr.get(sid))["usage"]["generations"] == 2
    assert mgr.stats()["obs"]["usage"]["syncs"] == 1


def test_no_roof_off_the_card_and_no_tpu_default(make_manager, monkeypatch):
    monkeypatch.delenv("MPI_TPU_ROOF_OPS_PER_S", raising=False)
    assert not hasattr(cost, "DEFAULT_ROOF_OPS_PER_S")
    assert cost.roof_ops_per_s() is None
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs)
    sid = mgr.create(dict(CUDA_SPEC, seed=22))["id"]
    mgr.step(sid, 2)
    usage = mgr.usage()
    assert usage["roof_ops_per_s"] is None
    assert "roofline" not in usage["signatures"][0]
    assert "mpi_tpu_roofline_efficiency{" not in obs.render_metrics()


def test_card_roof_from_the_device_properties(monkeypatch):
    """The card's roof is SM count x 64 int32 lanes x the SM clock: an
    H100 SXM's properties give 16.7e12 instructions/s."""
    import torch

    class Props:
        multi_processor_count, major, clock_rate = 132, 9, 1980000

    monkeypatch.delenv("MPI_TPU_ROOF_OPS_PER_S", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props())
    cost.device_roof_ops_per_s.cache_clear()
    try:
        assert cost.roof_ops_per_s() == 132 * 64 * 1.98e9
        Props.major = 5                 # an architecture the table lacks
        cost.device_roof_ops_per_s.cache_clear()
        assert cost.roof_ops_per_s() is None
    finally:
        cost.device_roof_ops_per_s.cache_clear()


def test_ops_per_cell_detail_prefers_depth_one_cards():
    eng = port.build_engine(GolConfig(rows=64, cols=64, steps=0, rule=BOSCO),
                            device="cpu")
    deep = capture_card(eng, depth=2, batch=0)
    one = capture_card(eng, depth=1, batch=4)
    assert ops_per_cell_detail([deep], 64 * 64) == (
        deep.ops_per_cell(64 * 64), True)
    assert ops_per_cell_detail([deep, one], 64 * 64) == (
        one.ops_per_cell(64 * 64), False)
    assert ops_per_cell_detail([], 64 * 64) == (None, False)


def test_usage_raises_without_obs(make_manager):
    mgr = make_manager(EngineCache(max_size=4), obs=None)
    with pytest.raises(RuntimeError):
        mgr.usage()
    with pytest.raises(RuntimeError):
        mgr.slo()
