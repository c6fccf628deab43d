"""Configuration tree, with the reference's exact defaults.

The port's own copy of the classes of ``stereo_reconstruction_cv_tpu/
config.py``: the same fields, defaults and ``with_``, so a configuration
written for the reference reads the same here (``convert.sgbm_config`` and
``convert.pipeline_config`` carry one across field by field). The
calibration classes are carried for that parity: the port's calibration
(``calib/``) takes the same defaults as arguments and reads
no configuration object, as the reference's does not either.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ChessboardConfig:
    """Calibration target: inner-corner grid and subpixel refinement."""

    cols: int = 9
    rows: int = 7
    subpix_max_iter: int = 30
    subpix_eps: float = 0.001
    subpix_win: int = 11
    save_corner_annotations: bool = False


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """Zhang calibration + LM refinement (OpenCV's defaults)."""

    chessboard: ChessboardConfig = dataclasses.field(default_factory=ChessboardConfig)
    num_dist_coeffs: int = 5
    lm_max_iter: int = 30
    lm_eps: float = 2.220446049250313e-16


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Feature detection + matching."""

    # cv2 SIFT contrastThreshold.
    contrast_threshold: float = 0.04
    # Lowe ratio: 0.7 on the geometry path, 0.75 on the inspection path.
    ratio_geometry: float = 0.7
    ratio_inspect: float = 0.75
    # Keypoints kept per image (a static shape).
    max_keypoints: int = 4096
    # Learned descriptor length (SIFT's is 128).
    descriptor_dim: int = 64
    # Learned matcher: mutual NN + minimum cosine similarity.
    learned_min_cossim: float = 0.5
    # Learned matches: LK subpixel refinement, window and iterations.
    lk_refine: bool = True
    lk_win: int = 9
    lk_iters: int = 16


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Robust two-view estimation."""

    # F by LMedS (cv2.FM_LMEDS).
    f_method: str = "lmeds"
    # E by RANSAC, prob 0.999, threshold 1 px.
    e_prob: float = 0.999
    e_threshold_px: float = 1.0
    # Hypotheses drawn, solved and scored together (a static shape).
    num_hypotheses: int = 1024
    # Points per minimal sample of the 8-point solver.
    sample_size: int = 8


@dataclasses.dataclass(frozen=True)
class RectifyConfig:
    """Stereo rectification and the fallback camera matrix."""

    # alpha 1 keeps every source pixel visible.
    alpha: float = 1.0
    default_fx: float = 1000.0
    default_fy: float = 1000.0
    default_cx: float = 960.0
    default_cy: float = 540.0


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


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    calibration: CalibrationConfig = dataclasses.field(default_factory=CalibrationConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    robust: RobustConfig = dataclasses.field(default_factory=RobustConfig)
    rectify: RectifyConfig = dataclasses.field(default_factory=RectifyConfig)
    sgbm: SGBMConfig = dataclasses.field(default_factory=SGBMConfig)
    # (width, height); None derives it from the image.
    image_size: Tuple[int, int] | None = None


DEFAULT = PipelineConfig()
