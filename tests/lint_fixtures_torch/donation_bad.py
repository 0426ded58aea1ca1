"""Known-bad donation-safety cases: a grid read after an engine step
consumed it.  The engine keeps a consumed grid's buffer as the spare of
its ping-pong pair and the next step writes into it, so every read below
sees a buffer the engine may already have overwritten.  Lines expected
to be flagged carry ``# expect: donation-safety``."""


def read_after_step(engine, g, n):
    out = engine.step(g, n)
    band = g[0:2, :]                        # expect: donation-safety
    return out, band


def read_after_units(eng, g):
    h = eng.step_units(g, 3)
    return h, g.sum()                       # expect: donation-safety


def attribute_grid(session, n):
    grid = session.engine.step(session.grid, n)
    count = session.grid.sum()              # expect: donation-safety
    session.grid = grid
    return count


def batched(self, grids, n):
    out = self.engine.step_batched(grids, n)
    first = grids[0]                        # expect: donation-safety
    more = self.engine.step_batched_units(out, 1)
    return more, first, out                 # expect: donation-safety


def stepper_bound(engine, stacked, B):
    stepper = engine.batched_stepper(B)
    out = stepper(stacked, 1)
    return out, stacked                     # expect: donation-safety


def stepper_through_cache(cache, engine, sig, stacked, B):
    stepper, _hit = cache.get_or_build_batched(
        sig, B, lambda: engine.batched_stepper(B))
    out = stepper(stacked, 2)
    return out, stacked.shape               # expect: donation-safety


def consumed_in_one_branch(engine, g, unit):
    if unit:
        out = engine.step_units(g, 2)
    else:
        out = engine.step(g.clone(), 2)
    return out, g                           # expect: donation-safety
