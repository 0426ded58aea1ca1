"""Clean donation-safety idioms the rule must NOT flag."""


def rebind(engine, g, n):
    """The safe idiom: the name is rebound by the consuming statement."""
    g = engine.step(g, n)
    return g.sum()


def rebind_attribute(session, n):
    session.grid = session.engine.step(session.grid, n)
    return session.grid


def branches(session, steps, unit):
    """Each branch consumes ``session.grid``; neither reads it after,
    and the rebind comes once both are done."""
    if unit:
        grid = session.engine.step_units(session.grid, steps)
    else:
        grid = session.engine.step(session.grid, steps)
    session.grid = session.engine.block_until_ready(grid)
    return session.grid


def early_return(engine, live, n):
    """A branch that returns passes nothing on; the comprehension's ``s``
    is its own name."""
    if len(live) == 1:
        s = live[0]
        g = engine.step_units(s.grid, n)
        return [g]
    return [s.grid for s in live]


def session_manager(mgr, sid, n):
    """``SessionManager.step`` takes a session id and consumes nothing."""
    mgr.step(sid, n)
    return mgr.step(sid, n), sid


def other_receivers(self, manager, sid, grid):
    """Only an engine's steps consume: ``self.step`` in the engine, a
    manager's, and a subscripted argument are out of scope."""
    a = self.step(grid, 1)
    b = manager.step(sid, 1)
    grids = [grid]
    c = self.engine.step(grids[0], 1)
    return a, b, grid, grids, c


def stepper_rebind(engine, stacked, B):
    stepper = engine.batched_stepper(B)
    for _ in range(3):
        stacked = stepper(stacked, 1)
    return stacked
