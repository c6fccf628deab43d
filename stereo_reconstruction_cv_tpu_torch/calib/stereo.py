"""Two-camera calibration from synchronised chessboard views (cv2.stereoCalibrate).

A port of ``stereo_reconstruction_cv_tpu/calib/stereo.py``: each camera is
first calibrated alone (Zhang and 20 LM steps), the relative pose starts at
the per-view medians of (R2 R1^T, t2 - R t1), and 40 joint LM steps refine
[K1, dist1, K2, dist2, R, T, camera 1's per-view poses] against the
reprojection in both images. Float64 on the device of the corners, no host
sync in the loops (``calib.zhang.levenberg_marquardt``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from stereo_reconstruction_cv_tpu_torch.calib import zhang as Z
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G


class StereoCalibrationResult(NamedTuple):
    K1: torch.Tensor
    dist1: torch.Tensor
    K2: torch.Tensor
    dist2: torch.Tensor
    R: torch.Tensor       # camera 1 -> camera 2 rotation (x2 = R x1 + T)
    T: torch.Tensor       # camera 1 -> camera 2 translation
    rvecs: torch.Tensor   # (V, 3) board pose in camera 1
    tvecs: torch.Tensor
    rms: torch.Tensor


def _pack(K1, d1, K2, d2, rT, tT, rvecs, tvecs) -> torch.Tensor:
    return torch.cat([torch.stack([K1[0, 0], K1[1, 1], K1[0, 2], K1[1, 2]]), d1,
                      torch.stack([K2[0, 0], K2[1, 1], K2[0, 2], K2[1, 2]]), d2,
                      rT, tT, rvecs.reshape(-1), tvecs.reshape(-1)])


def _unpack(theta: torch.Tensor, V: int):
    return (Z.camera_matrix(theta[0:4]), theta[4:9], Z.camera_matrix(theta[9:13]), theta[13:18],
            theta[18:21], theta[21:24], theta[24:24 + 3 * V].reshape(V, 3),
            theta[24 + 3 * V:].reshape(V, 3))


def _residuals(theta, obj, img1, img2) -> torch.Tensor:
    """Per view, camera 1's then camera 2's residuals: (V * 4N,)."""
    V = img1.shape[0]
    K1, d1, K2, d2, rT, tT, rvecs, tvecs = _unpack(theta, V)
    Rrel = G.rodrigues_to_matrix(rT)
    p1 = G.project_points(obj, rvecs, tvecs, K1, d1)
    # board -> camera 2 through the stereo extrinsics
    R2 = Rrel @ G.rodrigues_to_matrix(rvecs)
    t2 = tvecs @ Rrel.T + tT
    p2 = G.project_points(obj, G.matrix_to_rodrigues(R2), t2, K2, d2)
    return torch.cat([(p1 - img1).reshape(V, -1), (p2 - img2).reshape(V, -1)], dim=1).reshape(-1)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median along dim 0, averaging the two middle values of an even
    count, as jnp.median does (torch.median takes the lower one)."""
    s = torch.sort(x, dim=0).values
    n = s.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def calibrate_stereo(obj_pts: torch.Tensor, img_pts1: torch.Tensor, img_pts2: torch.Tensor,
                     image_size: Tuple[int, int], max_iters: int = 40) -> StereoCalibrationResult:
    """Joint calibration of a rig: obj_pts (N, 3), img_pts1 / img_pts2 (V,
    N, 2) of the same boards; image_size (W, H)."""
    dev = img_pts1.device
    obj = torch.as_tensor(obj_pts).to(device=dev, dtype=torch.float64)
    img1, img2 = img_pts1.to(torch.float64), img_pts2.to(dev, torch.float64)
    V = img1.shape[0]
    c1 = Z.calibrate_camera(obj, img1, image_size, max_iters=20)
    c2 = Z.calibrate_camera(obj, img2, image_size, max_iters=20)
    # the relative pose of each view; its medians start the joint fit
    R1, R2 = G.rodrigues_to_matrix(c1.rvecs), G.rodrigues_to_matrix(c2.rvecs)
    Rr = R2 @ R1.transpose(-1, -2)
    Tr = c2.tvecs - (Rr @ c1.tvecs[..., None])[..., 0]
    rT0 = _median(G.matrix_to_rodrigues(Rr))
    tT0 = _median(Tr)
    theta0 = _pack(c1.K, c1.dist, c2.K, c2.dist, rT0, tT0, c1.rvecs, c1.tvecs)
    res_fn = lambda th: _residuals(th, obj, img1, img2)  # noqa: E731
    theta = Z.levenberg_marquardt(res_fn, theta0, max_iters)
    K1, d1, K2, d2, rT, tT, rvecs, tvecs = _unpack(theta, V)
    r = res_fn(theta)
    rms = torch.sqrt(torch.mean(torch.sum(r.reshape(-1, 2) ** 2, dim=-1)))
    return StereoCalibrationResult(K1, d1, K2, d2, G.rodrigues_to_matrix(rT), tT, rvecs, tvecs, rms)
