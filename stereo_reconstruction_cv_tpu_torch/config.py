"""Configuration of the dense path, with the reference's exact defaults.

The port's own copy of ``SGBMConfig`` from ``stereo_reconstruction_cv_tpu/
config.py``: the same fields, defaults and ``with_``, so a configuration
written for the reference reads the same here (``convert.sgbm_config``
carries one across field by field). The other configuration classes come
with the slices that need them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SGBMConfig:
    """Dense disparity, exact cv2.StereoSGBM parameter set (main.ipynb cell 10).

    blockSize=11, P1=8*3*11^2, P2=32*3*11^2, disp12MaxDiff=1, preFilterCap=63,
    uniquenessRatio=10, speckleWindowSize=100, speckleRange=32, /16 output.
    """

    min_disparity: int = 0
    num_disparities: int = 128
    block_size: int = 11
    p1: int = 8 * 3 * 11 * 11
    p2: int = 32 * 3 * 11 * 11
    disp12_max_diff: int = 1
    pre_filter_cap: int = 63
    uniqueness_ratio: int = 10
    speckle_window_size: int = 100
    speckle_range: int = 32
    # 5 = cv2 default MODE_SGBM paths {L, R, UL, U, UR} (reference parity);
    # 8 = full SGM.
    num_directions: int = 5
    # Chunked DP scans were a TPU option of the reference; the port's scans
    # are exact and it refuses any scan_chunk but None.
    scan_chunk: int | None = None
    scan_halo: int = 32
    # The reference's aggregation backend ('pallas', 'xla', 'auto'); the
    # port has one backend per device and ignores it.
    backend: str = "auto"
    # Speckle backend: 'propagate' = component labels on the device (the
    # CUDA union-find on CUDA tensors, the reference's flood on CPU tensors);
    # 'exact' = the host union-find (one device -> host -> device round trip
    # of the maps).
    speckle_backend: str = "propagate"

    def with_(self, **kw) -> "SGBMConfig":
        return dataclasses.replace(self, **kw)
