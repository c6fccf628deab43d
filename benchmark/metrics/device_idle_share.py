"""1 - (union of the device's kernel, copy and set intervals / the traced
window), %."""


def read(r):
    if r.trace is None or not r.trace.items or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
