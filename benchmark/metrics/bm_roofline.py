"""Block matching's disparity layer's share of its roofline, %: the least
time of one frame's work counted from the configuration's shapes
(``work.sgbm_work``, which counts zero paths) over the device time per pair
inside the "sgbm" range (``device_ms.bm``)."""

from benchmark import harness, work


def read(r):
    device_ms = harness.reader("device_ms.bm")(r)
    if not device_ms:
        return None
    least_s = work.sgbm_work(r.config["height"], r.config["width"], r.config["sgbm"])["least_s"]
    return 100.0 * least_s / (device_ms * 1e-3)
