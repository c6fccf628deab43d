"""Device time per pair of block matching's WTA pass over the cost volume:
the items of the kernel ``wta_cost_kernel`` (csrc/wta.cu's form with no
delta volume) among the trace's device operations. Read by name, since the
frame's graph replay launches it without a call of its wrapper."""

KERNEL = "wta_cost_kernel<"


def read(r):
    if r.trace is None or not r.window.issued:
        return None
    seconds = [s for name, s in r.trace.device_ops if KERNEL in name]
    if not seconds:
        return None
    return 1e3 * sum(seconds) / r.window.issued
