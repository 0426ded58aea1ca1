"""Boards a dispatch of the serving layer carried over the window: the
micro-batcher's boards over its dispatches (``MicroBatcher.stats()``,
batched and solo), so boards a kernel launch steps."""


def read(trace, work):
    rounds = work.get("rounds")
    if not rounds:
        return None
    return work["boards_dispatched"] / rounds
