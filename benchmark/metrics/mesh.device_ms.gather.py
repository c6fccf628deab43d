"""Device time per pair of the items launched inside the "gather" range: each
data row's maps gathered onto the row's own cards (profiler trace, summed
over the cards)."""


def read(r):
    if r.trace is None or "gather" not in r.trace.range_s or not r.window.issued:
        return None
    return 1e3 * r.trace.range_s["gather"] / r.window.issued
