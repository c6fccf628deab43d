"""Device time per pair of the items launched inside the "speckle" range:
the sharded speckle filter's labels, sizes, boundary records and keep masks,
and the copies of its join (profiler trace, summed over the cards)."""


def read(r):
    if r.trace is None or "speckle" not in r.trace.range_s or not r.window.issued:
        return None
    return 1e3 * r.trace.range_s["speckle"] / r.window.issued
