"""Device time per pair of the items launched inside the "sgbm" range:
block matching's whole disparity layer, the items its graph replays
included (profiler trace, each item owned by the innermost range open
where it was launched)."""


def read(r):
    if r.trace is None or "sgbm" not in r.trace.range_s or not r.window.issued:
        return None
    return 1e3 * r.trace.range_s["sgbm"] / r.window.issued
