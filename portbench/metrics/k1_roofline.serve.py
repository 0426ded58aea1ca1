"""Batched K1's share of its roofline over the served window: the least
time for every board-pass the completed requests took (a launch steps a
whole batch), over K1's device time in the traced window."""

from portbench.metrics._share import kernel_roofline


def read(trace, work):
    return kernel_roofline(trace, work, "K1",
                           board_passes=work.get("board_passes"))
