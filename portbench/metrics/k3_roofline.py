"""K3's share of its roofline: the least time for the generations its
launches in the traced window computed, over K3's device time there."""

from portbench.metrics._share import kernel_roofline


def read(trace, work):
    return kernel_roofline(trace, work, "K3")
