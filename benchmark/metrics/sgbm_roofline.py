"""The SGBM layer's share of its roofline, %: the least time of one frame's
SGBM work counted from the configuration's shapes (benchmark/work.py) over
the device time per pair inside the "sgbm" range."""

from benchmark import work


def read(r):
    if r.trace is None or not r.trace.range_s.get("sgbm") or not r.window.issued:
        return None
    least_s = work.sgbm_work(r.config["height"], r.config["width"], r.config["sgbm"])["least_s"]
    return 100.0 * least_s / (r.trace.range_s["sgbm"] / r.window.issued)
