"""Every cell run end to end at a small size on the CPU (the program's
plain versions), its result line, and the check's control and planted
faults, each of which has to make ``correct`` come out false."""

import io
import json
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest

from portbench import harness
from portbench.control import planted
from portbench.reference.cells import parse_rule
from portbench.run import report
from portbench.tests.small import SMALL, with_waiting

# the benchmark's cells and the served cell that waits for a bound
M = with_waiting(harness.load_manifest())
CELLS = [c["name"] for c in M["workloads"]]


def _run(cell, seed=7, trace=False, seconds=0.1):
    tr = SMALL[harness.cell_entry(M, cell)["traffic"]]
    return harness.run_cell(cell, seed, seconds, trace, t0=time.perf_counter(),
                            device="cpu", traffic=tr, manifest=M)


def _rule(cell):
    return parse_rule(harness.config_file(
        M, harness.cell_entry(M, cell)["config"])["rule"])


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run(cell):
    r = _run(cell, seed=2 ** 31 + 12345)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "seconds", "checks"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 3
    want = {m["name"] for m in harness.end_to_end(M, cell)}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["device"]["platform"] == "cpu" and r["device"]["count"] == 1
    assert all(c["value"] == 0 == c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell):
    r = _run(cell, trace=True)
    assert list(r)[-3:] == ["breakdown", "seconds", "checks"]
    assert r["correct"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
    allowed = {m["name"] for m in harness.per_layer(M, cell)}
    assert set(r["metrics"]) <= allowed


def test_report_prints_checks_last():
    r = _run("life.run")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        report(r)
    assert json.loads(out.getvalue().splitlines()[-1]) == r
    assert err.getvalue().splitlines()[-1] == "check cells_wrong 0 limit 0"


# the faults each cell can have: a state left unchanged and an answer
# altered, everywhere; half of a batch left out where requests are
# batched; the control (the reference with a dead edge) everywhere.  One
# chip: no exchange between chips to leave out.
FAULTS = [(c, f) for c in CELLS for f in ("control", "unchanged", "flip")] \
    + [("life.serve", "half_batch")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    with planted(fault, _rule(cell)):
        r = _run(cell, seed=5)
    assert not r["correct"], r["checks"]
    assert r["checks"]["cells_wrong"]["value"] > 0


def test_faults_are_removed():
    with planted("unchanged", _rule("life.run")):
        pass
    assert _run("life.run")["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_small_cells_on_the_card(card, cell):
    tr = SMALL[harness.cell_entry(M, cell)["traffic"]]
    for trace in (False, True):
        r = harness.run_cell(cell, 9, 0.2, trace, t0=time.perf_counter(),
                             traffic=tr, manifest=M)
        assert r["correct"], r["checks"]
        assert r["device"]["platform"] == "gpu"
        if trace:
            assert r["device"]["busy_s"] > 0
            kernels = [n for n, _ in r["breakdown"]["device_ops"]]
            assert any("step_kernel" in n for n in kernels), kernels


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, cell):
    tr = SMALL[harness.cell_entry(M, cell)["traffic"]]
    with planted("control", _rule(cell)):
        r = harness.run_cell(cell, 4, 0.2, False, t0=time.perf_counter(),
                             traffic=tr, manifest=M)
    assert not r["correct"]
