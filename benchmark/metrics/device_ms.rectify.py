"""Device time per pair of the items launched inside the "rectify" range
(profiler trace, each item owned by the range open where it was launched)."""


def read(r):
    if r.trace is None or "rectify" not in r.trace.range_s or not r.window.issued:
        return None
    return 1e3 * r.trace.range_s["rectify"] / r.window.issued
