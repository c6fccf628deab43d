"""Time per pair in which no card of the cell is busy while the harness's
thread is inside the "speckle" range (the sharded speckle filter and its
one host join a batch), from the trace's idle gaps; 0 where the range ran
and no gap fell inside it."""


def read(r):
    if r.trace is None or "speckle" not in r.trace.range_s or not r.window.issued:
        return None
    gaps = dict(r.trace.idle_gaps)
    return 1e3 * gaps.get("speckle", 0.0) / r.window.issued
