"""The WTA pass's share of its roofline, %: the least time of one frame's
pass over a stored cost volume (``work_bm.wta_work``) over the pass's
device time per pair (``device_ms.bm.wta``)."""

from benchmark import harness, work_bm


def read(r):
    device_ms = harness.reader("device_ms.bm.wta")(r)
    if not device_ms:
        return None
    least_s = work_bm.wta_work(r.config["height"], r.config["width"], r.config["sgbm"])["least_s"]
    return 100.0 * least_s / (device_ms * 1e-3)
