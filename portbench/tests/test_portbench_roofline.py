"""The roofline's arithmetic on fixed numbers."""

import pytest

from portbench import roofline
from portbench.devtrace import Trace
from portbench.metrics._share import kernel_roofline

PEAK = 132 * 64 * 1.98e9  # an H100 SXM at its 1.98 GHz boost clock


def test_frozen_counts():
    assert roofline.word_gen_ops({"rule": "B3/S23"}) == 15
    assert roofline.word_gen_ops({"rule": "r5,c0,m1,s34..58,b34..45"}) == 7
    # the table wins; a rule it lacks takes its configuration's count
    assert roofline.word_gen_ops({"rule": "B3/S23",
                                  "word_generation_ops": 99}) == 15
    assert roofline.word_gen_ops({"rule": "B36/S23",
                                  "word_generation_ops": 17}) == 17
    with pytest.raises(KeyError):
        roofline.word_gen_ops({"rule": "B36/S23"})


def test_life_flagship_pass_is_bound_by_instructions():
    cells, gens = 65536 ** 2, 8
    ops = cells * gens / 32 * 15
    nbytes = 2 * cells // 8
    assert roofline.least_time_s(ops, nbytes, PEAK) == pytest.approx(
        ops / PEAK)
    assert ops == 16106127360 and PEAK == pytest.approx(16.72704e12)
    assert ops / PEAK == pytest.approx(0.962880e-3, rel=1e-5)


def test_bosco_flagship_pass_is_bound_by_bytes():
    cells = 65536 ** 2
    ops, nbytes = cells / 32 * 7, 2 * cells // 8
    assert roofline.least_time_s(ops, nbytes, PEAK) == pytest.approx(
        nbytes / 3.35e12)
    assert nbytes / 3.35e12 == pytest.approx(0.32052e-3, rel=1e-4)


def test_kernel_share_from_a_trace():
    t = Trace(window_s=1.0, busy_s=1.0,
              ops={"void bit_step_kernel<8>(int*)": (100, 0.13113)})
    work = {"word_gen_ops": 15, "cells": 65536 ** 2, "gens_per_pass": 8,
            "board_bytes": 65536 * 2048 * 4, "int32_ops_per_s": PEAK,
            "hbm_bytes_per_s": roofline.HBM_BYTES_PER_S}
    assert kernel_roofline(t, work, "K1") == pytest.approx(
        100 * 0.962880e-3 / 1.3113e-3, rel=1e-5)
    assert kernel_roofline(t, work, "K3") is None
    del work["int32_ops_per_s"]
    assert kernel_roofline(t, work, "K1") is None


def test_no_peak_off_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        roofline.int32_ops_per_s()


@pytest.mark.card
def test_peak_on_the_card(card):
    assert 5e12 < roofline.int32_ops_per_s() < 5e13
