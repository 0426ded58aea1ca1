"""The share of the traced window in which the card ran no operation."""


def read(trace, work):
    if trace.window_s <= 0:
        return None
    return 100 * (1 - trace.busy_s / trace.window_s)
