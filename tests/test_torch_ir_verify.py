"""The port's launch-level verifier (``mpi_tpu_torch.analysis.ir``) on the
CPU, where each wrapper runs its kernel's plain version.

Layers, mirroring ``tests/test_ir_verify.py``:

* the matrix itself — the fast tier and the whole matrix clean against
  the checked-in baseline, K1, K2 and K3 each launched at gens > 1;
* each contract caught on a seeded fault: a seam stepper that reads its
  band after the launch (``ir-donation``), an engine that hands back its
  input's storage (``ir-donation``), an ``.item()`` inside a dense step
  (``ir-purity``) and a signature blind to one near-pair field
  (``ir-signature``);
* canonical form stable across processes and free of addresses, paths
  and device names; the baseline round trip; the CLI's exit codes;
* parity with the reference: every cell's grid after one and two steps
  equal bit for bit to the reference engine's on JAX's CPU, and the
  port's ``plan_signature`` the reference's, field for field, with the
  same verdicts on twins and near-pairs.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mpi_tpu.backends.tpu import build_engine as jax_build_engine
from mpi_tpu.config import GolConfig as JaxConfig
from mpi_tpu.config import plan_signature as jax_signature
from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu_torch.analysis.ir import checks, load_baseline, run_ir
from mpi_tpu_torch.analysis.ir import write_baseline
from mpi_tpu_torch.analysis.ir.__main__ import main as ir_main
from mpi_tpu_torch.analysis.ir.faults import late_band_seam
from mpi_tpu_torch.analysis.ir.harness import record_engine
from mpi_tpu_torch.analysis.ir.matrix import (
    CELLS, NEAR_PAIRS, TWINS, Cell, cell_by_id,
)
from mpi_tpu_torch.backends.cuda import build_engine
from mpi_tpu_torch.config import SIGNATURE_FIELDS, plan_signature

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def full_report():
    """One run of the whole matrix on the CPU, shared by every test that
    only reads its facts (the fast tier is a subset of it)."""
    t0 = time.perf_counter()
    rep = run_ir(device="cpu")
    rep.elapsed = time.perf_counter() - t0
    return rep


def _by_id(report):
    return {rc.cell.id: rc for rc in report.recorded}


# -- the matrix ------------------------------------------------------------

def test_fast_matrix_clean_and_launches_every_kernel():
    t0 = time.perf_counter()
    rep = run_ir(device="cpu", fast_only=True)
    elapsed = time.perf_counter() - t0
    assert not rep.errors, rep.errors
    assert not rep.findings, "\n".join(f.format() for f in rep.findings)
    assert {rc.cell.id for rc in rep.recorded} == {
        c.id for c in CELLS if c.tier == "fast"}
    deep = {ln.kernel for rc in rep.recorded for s in rc.steps
            for ln in s.launches if ln.gens > 1}
    assert deep == {"K1", "K2", "K3"}
    assert all(n > 0 for n in rep.launches().values()), rep.launches()
    # a few seconds on one core; 30 s leaves room for a loaded box
    assert elapsed < 30.0, f"fast launch matrix took {elapsed:.1f}s"


def test_full_matrix_clean(full_report):
    assert not full_report.errors, full_report.errors
    assert not full_report.findings, "\n".join(
        f.format() for f in full_report.findings)
    assert len(full_report.recorded) == len(CELLS)
    assert full_report.complete


def test_checked_in_baseline_covers_whole_matrix():
    bl = load_baseline()
    assert set(bl) == {c.id for c in CELLS}, (
        "baseline.json out of sync with the matrix — regenerate with "
        "`python -m mpi_tpu_torch.analysis.ir --device cpu "
        "--write-baseline`")
    assert all(re.fullmatch(r"[0-9a-f]{16}", v["fingerprint"])
               for v in bl.values())


def test_host_reads_are_the_sparse_phase_loops(full_report):
    for rc in full_report.recorded:
        sparse = rc.engine.sparse_plan is not None
        for step in rc.steps:
            assert len(step.host_reads) == step.counted_reads
            assert (step.counted_reads > 0) == sparse, rc.cell.id


def test_seam_band_extracted_before_each_launch(full_report):
    """Regression pin: in each pass of a seam cell the band reads the
    pass's input before the next pass writes into it.  The one-device
    band is one launch (``seam``) right after each K1 launch, on that
    launch's input and output, with no launch and no op between them."""
    for cid in ("seam_1x1", "batched_seam_1x1"):
        rc = _by_id(full_report)[cid]
        for step in rc.steps:
            launches = [k for k, ev in enumerate(step.events)
                        if getattr(ev, "kernel", None) in ("K1", "seam")]
            kinds = [step.events[k].kernel for k in launches]
            assert kinds and kinds == ["K1", "seam"] * (len(kinds) // 2), cid
            for k1, band in zip(launches[::2], launches[1::2]):
                ev, sb = step.events[k1], step.events[band]
                assert band == k1 + 1, cid
                assert (sb.src, sb.out) == (ev.src, ev.out), cid


def test_sparse_gathers_hold_the_contracts():
    """A quiet board (one blinker on 512² Life, 16 x 16 tiles of 32) takes
    the sparse phases, not the dense ones the matrix's soups take: stripe
    launches whose inputs are compared with their outputs after the
    launch, the one read of a consumed input ``ir-donation`` allows."""
    cell = Cell("sparse_quiet", 512, 512, sparse_tile=32, depth=2)
    engine = build_engine(cell.make_config(), device="cpu")
    board = np.zeros((512, 512), dtype=np.uint8)
    board[100, 99:102] = 1
    init = engine.init_grid
    engine.init_grid = lambda: init(initial=board)
    rc = record_engine(cell, engine)
    assert any(k.startswith("sparse") for k in rc.steps[1].phases), \
        rc.steps[1].phases
    compares = [e for e in rc.steps[1].events
                if getattr(e, "name", "") == "aten::ne"]
    assert compares
    assert checks.check_donation(rc) == []
    assert checks.check_purity(rc) == []
    # a blinker's period is 2: each step of 2 generations gives it back
    np.testing.assert_array_equal(rc.boards_1[0], board)
    np.testing.assert_array_equal(rc.boards_2[0], board)


# -- seeded faults ---------------------------------------------------------

def test_seeded_late_band_read_detected():
    cell = cell_by_id("seam_1x1")
    engine = build_engine(cell.make_config(), device="cpu")
    rc = record_engine(cell, engine, late_band_seam(engine))
    # the grid is right all the same: the CPU runs in program order
    ref = record_engine(cell, build_engine(cell.make_config(), device="cpu"))
    np.testing.assert_array_equal(rc.boards_2[0], ref.boards_2[0])
    findings = checks.check_donation(rc)
    assert findings and all(f.check == "ir-donation" for f in findings)
    first = findings[0]
    assert first.cell == "seam_1x1"
    assert "aten::index_select reads the input of launch 1 (K1) (the " \
           "step's entry grid) after the launch took it" in first.message
    assert "parallel/seam.py" in first.message
    assert checks.check_donation(ref) == []


def test_seeded_engine_handing_back_its_input_detected():
    cell = cell_by_id("dense_bosco_1x1")   # one pass a step
    engine = build_engine(cell.make_config(), device="cpu")
    real = engine._evolve

    def hands_back(grid, n, spare):
        new, spare = real(grid, n, spare)
        if new is not grid:
            grid.copy_(new)
            spare = new
        return grid, spare

    rc = record_engine(cell, engine, hands_back)
    msgs = [f.message for f in checks.check_donation(rc)]
    assert len(msgs) == 2, msgs
    assert all("hands back a storage its last pass did not write" in m
               for m in msgs)


def test_seeded_spare_not_reused_detected():
    """The other direction: an engine that allocates a fresh buffer every
    step instead of reusing the spare it kept (the donation lost)."""
    cell = cell_by_id("dense_bosco_1x1")
    engine = build_engine(cell.make_config(), device="cpu")
    real = engine._evolve

    def fresh(grid, n, spare):
        return real(grid, n, spare.clone())

    rc = record_engine(cell, engine, fresh)
    msgs = [f.message for f in checks.check_donation(rc)]
    assert any("did not reuse the consumed buffer" in m for m in msgs), msgs


def test_seeded_item_in_dense_step_detected():
    cell = cell_by_id("packed_1x1")
    engine = build_engine(cell.make_config(), device="cpu")
    real = engine._evolve

    def with_item(grid, n, spare):
        new, spare = real(grid, n, spare)
        new.sum().item()
        return new, spare

    rc = record_engine(cell, engine, with_item)
    findings = checks.check_purity(rc)
    assert [f.check for f in findings] == ["ir-purity"] * 2
    assert "aten::_local_scalar_dense" in findings[0].message
    assert "a step without sparse stepping makes none" in findings[0].message


def test_seeded_signature_collision_detected():
    """Blind the signature to ``sparse_tile`` and the soundness check must
    report both the collision and the blinded near-pair."""
    i = SIGNATURE_FIELDS.index("sparse_tile")

    def blinded(config, mesh_shape):
        sig = plan_signature(config, mesh_shape)
        return sig[:i] + ("<dropped>",) + sig[i + 1:]

    rep = run_ir(device="cpu", cell_ids=["packed_1x1", "sparse_1x1"],
                 use_baseline=False, signature_fn=blinded)
    assert not rep.errors, rep.errors
    msgs = [f.message for f in rep.findings if f.check == "ir-signature"]
    assert any("plan_signature collision" in m and "packed_1x1" in m
               and "sparse_1x1" in m for m in msgs), msgs
    assert any("plan_signature is blind to field 'sparse_tile'" in m
               for m in msgs), msgs


def test_signature_checks_clean_on_real_engines(full_report):
    assert checks.check_signatures(full_report.recorded) == []
    by_id = _by_id(full_report)
    for cid, twin in TWINS:
        assert by_id[cid].signature == by_id[twin].signature
        assert by_id[cid].fingerprint == by_id[twin].fingerprint
    for a, b, _ in NEAR_PAIRS:
        assert by_id[a].signature != by_id[b].signature


# -- canonical form --------------------------------------------------------

def test_canon_text_has_no_addresses_paths_or_devices(full_report):
    for rc in full_report.recorded:
        text = rc.canon.text
        assert not re.search(r"0x[0-9a-fA-F]+", text), rc.cell.id
        assert ROOT not in text and "cpu" not in text and "cuda" not in text
        assert rc.fingerprint == __import__("hashlib").sha256(
            text.encode()).hexdigest()[:16]


def test_canon_stable_across_processes(full_report):
    ids = ["seam_1x1", "sparse_1x1"]
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.analysis.ir", "--device",
         "cpu", "--format", "json", *(a for c in ids
                                      for a in ("--cell", c))],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(proc.stdout)
    by_id = _by_id(full_report)
    assert data["cells"] == {c: by_id[c].fingerprint for c in ids}


# -- baseline --------------------------------------------------------------

def test_baseline_roundtrip(tmp_path, full_report):
    recorded = full_report.recorded
    path = str(tmp_path / "baseline.json")
    write_baseline(recorded, path)
    bl = load_baseline(path)
    assert set(bl) == {rc.cell.id for rc in recorded}
    assert checks.check_drift(recorded, bl) == []
    bl2 = dict(bl, packed_1x1={"fingerprint": "0" * 16})
    msgs = [f.message for f in checks.check_drift(recorded, bl2)]
    assert any("launch records drifted" in m and "--write-baseline" in m
               for m in msgs), msgs
    bl3 = {k: v for k, v in bl.items() if k != "packed_1x1"}
    msgs = [f.message for f in checks.check_drift(recorded, bl3)]
    assert any("no launch baseline recorded" in m for m in msgs)
    bl4 = dict(bl, ghost_cell={"fingerprint": "1" * 16})
    assert checks.check_drift(recorded, bl4, complete=False) == []
    msgs = [f.message for f in checks.check_drift(recorded, bl4,
                                                  complete=True)]
    assert any("unknown cell 'ghost_cell'" in m for m in msgs)


# -- CLI -------------------------------------------------------------------

def _main(capsys, *args):
    rc = ir_main(list(args))
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_list_cells(capsys):
    rc, out, _ = _main(capsys, "--list-cells")
    assert rc == 0
    for c in CELLS:
        assert c.id in out


def test_cli_single_cell_json(capsys):
    rc, out, err = _main(capsys, "--device", "cpu", "--cell", "packed_1x1",
                         "--format", "json")
    assert rc == 0, out + err
    data = json.loads(out)
    assert data["tool"] == "mpi_tpu_torch.analysis.ir"
    assert data["device"] == "cpu"
    assert data["summary"] == {
        "cells_recorded": 1, "findings": 0, "errors": 0,
        "complete_matrix": False, "host_reads": 0,
        "launches": {"K1": 4, "K2": 0, "K3": 0}}
    assert data["cells"] == {
        "packed_1x1": load_baseline()["packed_1x1"]["fingerprint"]}


def test_cli_unknown_cell_is_internal_error(capsys):
    rc, _, err = _main(capsys, "--device", "cpu", "--cell", "no_such_cell")
    assert rc == 2
    assert "unknown matrix cell" in err


@pytest.mark.parametrize("device", [(), ("--device", "cuda")],
                         ids=["default", "cuda"])
def test_cli_without_a_card_exits_2(device, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _main(capsys, *device, "--fast")
    assert rc == 2, out + err
    assert "CUDA is not available" in err
    assert out == ""


def test_module_without_a_card_exits_2():
    """``python -m mpi_tpu_torch.analysis.ir`` itself, with no card
    visible: exit 2, nothing run on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.analysis.ir", "--fast"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "CUDA is not available" in proc.stderr and proc.stdout == ""


# -- parity with the reference ---------------------------------------------

def _jax_engine(cell):
    return jax_build_engine(JaxConfig(
        rows=cell.rows, cols=cell.cols, steps=0, seed=cell.seed,
        rule=jax_rule_from_name(cell.rule), boundary=cell.boundary,
        backend="tpu", mesh_shape=cell.mesh, comm_every=cell.comm_every,
        overlap=cell.overlap, sparse_tile=cell.sparse_tile))


def _jax_boards(cell):
    """The reference's boards after one step of ``depth`` and after two."""
    eng = _jax_engine(cell)
    out = []
    if cell.batch:
        g = eng.init_grids(seeds=[cell.seed + i for i in range(cell.batch)])
        for _ in range(2):
            g = eng.step_batched(g, cell.depth)
            out.append(eng.fetch_batched(g))
    else:
        g = eng.init_grid()
        for _ in range(2):
            g = eng.step(g, cell.depth)
            out.append([eng.fetch(g)])
    return out


@pytest.mark.parametrize("cid", [c.id for c in CELLS])
def test_grids_equal_the_reference(cid, full_report):
    rc = _by_id(full_report)[cid]
    want_1, want_2 = _jax_boards(rc.cell)
    for got, want in ((rc.boards_1, want_1), (rc.boards_2, want_2)):
        assert len(got) == len(want) == max(1, rc.cell.batch)
        for a, b in zip(got, want):
            assert a.dtype == np.uint8 and a.shape == b.shape
            np.testing.assert_array_equal(a, np.asarray(b))


def _same(name, ours, ref):
    if name == "rule":
        return str(ours) == str(ref)
    if name == "backend":   # the port's one-device backend is "cuda"
        return (ours, ref) == ("cuda", "tpu")
    return ours == ref


@pytest.mark.parametrize("cid", [c.id for c in CELLS])
def test_signature_equals_the_reference(cid, full_report):
    rc = _by_id(full_report)[cid]
    ref = _jax_engine(rc.cell)
    theirs = jax_signature(ref.config, (ref.mi, ref.mj))
    assert len(rc.signature) == len(theirs) == len(SIGNATURE_FIELDS)
    for name, ours, their in zip(SIGNATURE_FIELDS, rc.signature, theirs):
        assert _same(name, ours, their), name


def test_pair_verdicts_agree_with_the_reference(full_report):
    by_id = _by_id(full_report)

    def ref_sig(cid):
        eng = _jax_engine(by_id[cid].cell)
        sig = jax_signature(eng.config, (eng.mi, eng.mj))
        return tuple(str(v) for v in sig)

    for a, b in TWINS:
        assert by_id[a].signature == by_id[b].signature
        assert ref_sig(a) == ref_sig(b)
    for a, b, _ in NEAR_PAIRS:
        assert by_id[a].signature != by_id[b].signature
        assert ref_sig(a) != ref_sig(b)
