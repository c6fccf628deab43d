"""Kernels, copies and sets in the traced window, per pair (host dispatch)."""


def read(r):
    if r.trace is None or not r.trace.items or not r.window.issued:
        return None
    return r.trace.items / r.window.issued
