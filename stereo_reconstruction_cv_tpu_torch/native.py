"""Exact host speckle filter: the reference's ``native/speckle.cc`` via ctypes.

cv2.filterSpeckles semantics: union-find over 4-connectivity where
|d(p) - d(q)| <= max_diff; components of at most ``max_size`` pixels are
invalidated. The library is compiled from ``native/speckle.cc`` alone at first
use (``_build.speckle_library``); a failed build raises instead of falling
back to a slow Python search.
"""

from __future__ import annotations

import numpy as np

from stereo_reconstruction_cv_tpu_torch import _build


def filter_speckles(
    disp: np.ndarray, valid: np.ndarray, max_size: int, max_diff: float
) -> np.ndarray:
    """(H, W) float disparity + bool valid -> the updated valid mask (copy)."""
    disp = np.ascontiguousarray(disp, np.float32)
    out = np.ascontiguousarray(valid, np.uint8).copy()
    if disp.ndim != 2 or disp.shape != out.shape:
        raise ValueError(f"disp {disp.shape} and valid {out.shape} must be one (H, W) shape")
    h, w = disp.shape
    _build.speckle_library().stereo_native_filter_speckles(
        disp.ctypes.data, out.ctypes.data, h, w, int(max_size), float(max_diff)
    )
    return out.astype(bool)
