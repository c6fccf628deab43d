"""The "bm" chain: block matching's pair -> cloud path, the "sgbm" chain's
(``chains/sgbm.py``) with a configuration of no path (``num_directions``
0): ``ops/disparity.sgbm_disparity`` runs the cost, the WTA over the cost
volume alone, the LR check and the speckle filter. Its plain reference is
``reference/bm.py``.

A traced run opens "sgbm" around ``sgbm_disparity`` and "cloud" around the
reprojection, as the "sgbm" chain does. On the card the frame is replayed
from a CUDA graph, which calls none of its stages' functions, so the WTA
pass's device time is read by its kernel's name (``metrics/device_ms.bm.wta``).
"""

from __future__ import annotations

from benchmark import harness


class Chain(harness.piece("chains", "sgbm").Chain):
    pass
