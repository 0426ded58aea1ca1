"""K1's share of its roofline: the least time for the Life generations its
launches in the traced window computed, over K1's device time there."""

from portbench.metrics._share import kernel_roofline


def read(trace, work):
    return kernel_roofline(trace, work, "K1")
