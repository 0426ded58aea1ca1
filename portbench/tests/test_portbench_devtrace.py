"""The trace reduction on records of known shape."""

import pytest

from portbench.devtrace import Capture, reduce_records


def test_busy_gaps_and_clipping():
    host = [(100, 1100, "window"), (100, 600, "engine.step"),
            (120, 580, "aten::empty"), (600, 1090, "check.copy")]
    device = [(50, 200, "void bit_step_kernel<8>"),  # clipped to 100..200
              (150, 300, "void bit_step_kernel<8>"),
              (700, 800, "Memcpy DtoD (Device -> Device)"),
              (1050, 1200, "dense_narrow_kernel")]
    t = reduce_records(host, device)
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx((200 + 100 + 50) * 1e-9)
    assert t.kernel("K1") == (2, pytest.approx(250e-9))
    assert t.kernel("K2") == (1, pytest.approx(50e-9))
    assert t.kernel("K3") == (0, 0)
    # 300..700 began inside engine.step's aten::empty, 800..1050 inside
    # check.copy
    assert t.gaps == {"engine.step:aten::empty": pytest.approx(400e-9),
                      "check.copy": pytest.approx(250e-9)}
    b = t.breakdown()
    assert b["device_ops"][0][0] == "void bit_step_kernel<8>"
    assert [n for n, _ in b["idle_gaps"]] == ["engine.step:aten::empty",
                                              "check.copy"]


def test_one_window():
    with pytest.raises(RuntimeError):
        reduce_records([(0, 1, "engine.step")], [])


def test_untraced_capture_has_no_trace():
    cap = Capture(False, False)
    with cap, cap.span("window"):
        pass
    assert cap.reduce() is None
