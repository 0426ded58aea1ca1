"""Milliseconds a serving round in which the card ran nothing: the traced
window less its device-busy time, over the micro-batcher's dispatches in
the window."""


def read(trace, work):
    rounds = work.get("rounds")
    if not rounds:
        return None
    return 1e3 * (trace.window_s - trace.busy_s) / rounds
