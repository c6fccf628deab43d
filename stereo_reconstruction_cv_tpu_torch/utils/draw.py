"""Display helpers (a copy of what the CLI uses from ``stereo_reconstruction_cv_tpu/utils/draw.py``)."""

from __future__ import annotations

import numpy as np


def colormap_jet(x: np.ndarray) -> np.ndarray:
    """Jet colormap of a float map -> (H, W, 3) uint8, for disparity display."""
    x = np.asarray(x, np.float32)
    lo, hi = np.nanmin(x), np.nanmax(x)
    v = (x - lo) / (hi - lo + 1e-12)
    r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)
