"""The seam band's share of the device time in the traced window: every
device operation that is neither K1 nor a copy or a set (the band's
extraction, its K2 step and its stitch), over all device time."""


def read(trace, work):
    total = trace.device_seconds()
    other = sum(t for name, (_, t) in trace.ops.items()
                if name.startswith(("Memcpy", "Memset")))
    band = total - trace.kernel("K1")[1] - other
    if total <= 0 or band <= 0:
        return None
    return 100 * band / total
