"""95th percentile, over every pair of the window, of the time from handing
its host frames to the chain until its cloud's copy to the host completed
(closed loops only)."""

import numpy as np


def read(r):
    if not r.window.latencies_s:
        return None
    return 1e3 * float(np.percentile(r.window.latencies_s, 95))
