"""The consumer's wall time blocked in the loader's iterator (input layer:
PrefetchLoader + native decode), per pair of the window (harness span)."""


def read(r):
    if r.window.loader_wait_s is None or r.trace is None or not r.window.issued:
        return None
    return 1e3 * r.window.loader_wait_s / r.window.issued
