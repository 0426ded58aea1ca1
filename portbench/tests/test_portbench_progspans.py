"""The program's spans in a traced window, on records of known shape: the
spans counted, device work and idle time charged to the span that
launched it, the seam band's readings; the benchmark's own reduction and
readers unmoved by the program's records; the ``kernel_load_s`` reader;
and the span measurement on the CPU at a small size."""

import sys
import time
import types

import pytest

from portbench import harness, progspans
from portbench.devtrace import reduce_records
from portbench.tests.small import SMALL

# one window (0..1000 ns) of two passes, each K1 and a seam band of one
# extraction op, K2 and one stitch op, then a check copy
HARNESS = [(0, 1000, "window"), (0, 480, "engine.step"),
           (480, 980, "engine.step"), (980, 1000, "check.copy")]
PROGRAM = [(10, 470, "engine.pass"), (20, 60, "seam.extract"),
           (100, 140, "seam.band"), (150, 200, "seam.stitch"),
           (490, 970, "engine.pass"), (500, 540, "seam.extract"),
           (560, 600, "seam.band"), (610, 660, "seam.stitch")]
ATEN = [(25, 55, "aten::index_select"), (155, 195, "aten::index_add_"),
        (505, 535, "aten::index_select"), (615, 655, "aten::index_add_")]
# runtime calls (start, end, correlation id) and device ops (start, end,
# name, correlation id)
RUNTIME = [(30, 40, 1), (70, 80, 2), (110, 120, 3), (160, 170, 4),
           (510, 520, 5), (545, 555, 6), (570, 580, 7), (620, 650, 8),
           (985, 990, 9)]
DEVICE = [(45, 60, "indexSelectSmallIndex", 1),
          (80, 300, "bit_step_kernel", 2),      # launched late: gap 60..80
          (300, 320, "dense_narrow_kernel", 3),
          (330, 340, "indexFuncSmallIndex", 4),  # queued: bubble 320..330
          (525, 530, "indexSelectSmallIndex", 5),
          (560, 800, "bit_step_kernel", 6),
          (800, 820, "dense_narrow_kernel", 7),
          (840, 850, "indexFuncSmallIndex", 8),  # its call ended at 650
          (992, 998, "Memcpy DtoD (Device -> Device)", 9)]
HOST = HARNESS + PROGRAM + ATEN + [(s, e, "cudaLaunchKernel")
                                  for s, e, _ in RUNTIME]


def _reduced():
    return progspans.reduce_spans(HOST, RUNTIME, DEVICE)


def test_spans_counted_and_work_charged_to_them():
    red = _reduced()
    rows = red["spans"]
    assert red["window_s"] == pytest.approx(1000e-9)
    assert {n: r["count"] for n, r in rows.items()} == {
        "engine.pass": 2, "seam.extract": 2, "seam.band": 2,
        "seam.stitch": 2, progspans.NO_SPAN: 0, progspans.WINDOW_END: 0}
    assert {n: r["launches"] for n, r in rows.items()} == {
        "engine.pass": 2, "seam.extract": 2, "seam.band": 2,
        "seam.stitch": 2, progspans.NO_SPAN: 1, progspans.WINDOW_END: 0}
    assert rows["engine.pass"]["device_s"] == pytest.approx(460e-9)
    assert rows["seam.band"]["device_s"] == pytest.approx(40e-9)
    assert rows["seam.extract"]["device_s"] == pytest.approx(20e-9)
    assert rows["seam.stitch"]["device_s"] == pytest.approx(20e-9)
    assert red["device_s"] == pytest.approx(546e-9)


def test_gaps_charged_to_the_op_that_ends_them_late_or_bubble():
    rows = _reduced()["spans"]
    # 0..45 before the first extraction (its call ended at 40: late);
    # 340..525 before the second (call ended at 520: late)
    assert rows["seam.extract"]["idle_late_s"] == pytest.approx(230e-9)
    assert rows["seam.extract"]["idle_bubble_s"] == 0
    # 60..80 before K1 (its call ended at 80: late); 530..560 before the
    # second K1 (call ended at 555, after the gap began: late)
    assert rows["engine.pass"]["idle_late_s"] == pytest.approx(50e-9)
    # 320..330 and 820..840 before the stitches: queued long before
    assert rows["seam.stitch"]["idle_bubble_s"] == pytest.approx(30e-9)
    assert rows["seam.stitch"]["idle_late_s"] == 0
    assert rows["seam.band"]["idle_late_s"] == 0
    assert rows["seam.band"]["idle_bubble_s"] == 0
    # 850..992 before the copy, 998..1000 the window's tail
    assert rows[progspans.NO_SPAN]["idle_late_s"] == pytest.approx(142e-9)
    assert rows[progspans.WINDOW_END]["idle_late_s"] == pytest.approx(2e-9)
    red = _reduced()
    idle = sum(r["idle_late_s"] + r["idle_bubble_s"] for r in rows.values())
    assert idle == pytest.approx(red["idle_s"])
    trace = reduce_records(HOST, [d[:3] for d in DEVICE])
    assert red["idle_s"] == pytest.approx(trace.window_s - trace.busy_s)


def test_seam_readings():
    got = progspans.seam_readings(_reduced())
    assert got == {"seam_band_share": pytest.approx(100 * 80 / 546),
                   "seam_launches_per_pass": 3.0,
                   "seam_idle_share": pytest.approx(100 * 260 / 1000)}
    assert progspans.seam_readings(progspans.reduce_spans(
        HARNESS, RUNTIME, DEVICE)) == {}


def test_ops_of_an_unknown_call_fall_to_no_span():
    red = progspans.reduce_spans(HOST, [], DEVICE)
    assert set(red["spans"]) == {"engine.pass", *progspans.SEAM_SPANS,
                                 progspans.NO_SPAN, progspans.WINDOW_END}
    assert red["spans"][progspans.NO_SPAN]["launches"] == len(DEVICE)


# the benchmark's readers that read the traced window
READERS = ["k1_roofline", "k3_roofline", "seam_share", "idle_share"]
WORK = {"word_gen_ops": 15, "cells": 64 * 64, "gens_per_pass": 8,
        "board_bytes": 64 * 2 * 4, "int32_ops_per_s": 1.6e13,
        "hbm_bytes_per_s": 3.35e12}


@pytest.mark.parametrize("name", READERS + ["fields"])
def test_program_records_move_no_existing_reading(name):
    """Arming the program's spans adds host records to the trace: the
    benchmark's reduction gives the same device operations, busy time and
    window, and every reader the same value; only the gaps' names may
    name a program span now."""
    device = [d[:3] for d in DEVICE]
    without = reduce_records(HARNESS + ATEN, device)
    with_spans = reduce_records(HARNESS + PROGRAM + ATEN, device)
    if name == "fields":
        assert (with_spans.ops, with_spans.busy_s, with_spans.window_s) == (
            without.ops, without.busy_s, without.window_s)
        assert sum(with_spans.gaps.values()) == pytest.approx(
            sum(without.gaps.values()))
        # 60..80 began as the extraction's span closed, 320..330 inside
        # the pass
        assert {"engine.step:seam.extract", "engine.step:engine.pass"} <= \
            set(with_spans.gaps)
        assert "engine.step" in without.gaps
    else:
        read = harness.reader(name)
        assert read(with_spans, WORK) == read(without, WORK)


def test_kernel_load_s_reads_the_programs_counter(monkeypatch):
    read = harness.reader("kernel_load_s")
    key = "mpi_tpu_torch.ops._build"
    monkeypatch.setitem(sys.modules, key,
                        types.SimpleNamespace(load_seconds=1.25, builds=2))
    assert read(None, {}) == 1.25
    # a program without the counter, or without the module, gives none
    monkeypatch.setitem(sys.modules, key, types.SimpleNamespace(builds=2))
    assert read(None, {}) is None
    monkeypatch.delitem(sys.modules, key)
    assert read(None, {}) is None


def test_armed_engines_carry_an_obs_inside_the_block_only():
    from mpi_tpu_torch.backends import cuda
    from mpi_tpu_torch.config import GolConfig
    from mpi_tpu_torch.models.rules import LIFE
    from mpi_tpu_torch.obs import Obs

    cfg = GolConfig(rows=32, cols=64, steps=0, rule=LIFE)
    with progspans.armed_engines():
        assert isinstance(cuda.build_engine(cfg, device="cpu").obs, Obs)
    assert cuda.build_engine(cfg, device="cpu").obs is None


@pytest.mark.parametrize("spans", [True, False], ids=["armed", "off"])
def test_measure_on_the_cpu(spans):
    got = progspans.measure("life.padded", 2 ** 31 + 11, 0.2, spans,
                            time.perf_counter(), device="cpu",
                            traffic=SMALL["padded"])
    assert got["correct"] and got["spans_armed"] is spans
    rows = got["program_spans"]["spans"]
    passes = rows.get("engine.pass", {}).get("count", 0)
    if spans:
        assert passes >= 4
        assert all(rows[n]["count"] == passes for n in progspans.SEAM_SPANS)
    else:
        assert passes == 0 and not set(rows) & set(progspans.SEAM_SPANS)
    # on the CPU the profiler sees no device operation
    assert got["seam"] == {} and got["program_spans"]["device_s"] == 0
