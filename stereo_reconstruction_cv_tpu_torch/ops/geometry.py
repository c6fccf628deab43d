"""Camera geometry on tensors: the functions the dense path needs.

Ports of ``stereo_reconstruction_cv_tpu/ops/geometry.py`` (cv2.Rodrigues,
distortion, cv2.reprojectImageTo3D parity). Conventions follow OpenCV: points
are (x, y) = (col, row); distortion is (k1, k2, p1, p2, k3). Every function
keeps the dtype and device of its inputs.
"""

from __future__ import annotations

import torch


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., D+1) with a trailing 1."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def rodrigues_to_matrix(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (3,) -> rotation matrix (3, 3), cv2.Rodrigues; series
    expansions near theta = 0."""
    rvec = rvec.reshape(3)
    theta2 = torch.dot(rvec, rvec)
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-16
    one = torch.ones_like(theta)
    s = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / torch.where(small, one, theta))
    c1 = torch.where(small, 0.5 - theta2 / 24.0,
                     (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    kx, ky, kz = rvec[0], rvec[1], rvec[2]
    z = torch.zeros_like(kx)
    K = torch.stack([torch.stack([z, -kz, ky]), torch.stack([kz, z, -kx]),
                     torch.stack([-ky, kx, z])])
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + s * K + c1 * (K @ K)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (3, 3) -> unit quaternion (w, x, y, z), w >= 0
    (Shepperd's method: the largest of the four pivots)."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    t0 = 1.0 + m00 + m11 + m22
    t1 = 1.0 + m00 - m11 - m22
    t2 = 1.0 - m00 + m11 - m22
    t3 = 1.0 - m00 - m11 + m22
    qs = torch.stack([
        torch.stack([t0, m21 - m12, m02 - m20, m10 - m01]),
        torch.stack([m21 - m12, t1, m01 + m10, m02 + m20]),
        torch.stack([m02 - m20, m01 + m10, t2, m12 + m21]),
        torch.stack([m10 - m01, m20 + m02, m12 + m21, t3]),
    ])
    ts = torch.stack([t0, t1, t2, t3])
    i = torch.argmax(ts)
    q = qs[i] * (0.5 / torch.sqrt(torch.clamp(ts[i], min=1e-30)))
    q = q / torch.linalg.norm(q)
    return q * torch.where(q[0] < 0, -1.0, 1.0)


def matrix_to_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (3, 3) -> axis-angle (3,), cv2.Rodrigues."""
    q = matrix_to_quaternion(R)
    w, v = q[0], q[1:]
    vn = torch.linalg.norm(v)
    theta = 2.0 * torch.atan2(vn, w)
    tiny = vn < 1e-30
    axis = v / torch.where(tiny, torch.ones_like(vn), vn)
    return torch.where(tiny, torch.zeros_like(v), axis * theta)


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Apply (k1, k2, p1, p2, k3) distortion to normalized coords (..., 2)."""
    dist = dist.reshape(-1)
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    k3 = dist[4] if dist.shape[0] > 4 else torch.zeros_like(k1)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy2 = 2.0 * x * y
    xd = x * radial + p1 * xy2 + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + p2 * xy2
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xy_dist: torch.Tensor, dist: torch.Tensor,
                         num_iters: int = 10) -> torch.Tensor:
    """Invert the distortion by fixed-point iteration (cv2.undistortPoints)."""
    xy = xy_dist
    for _ in range(num_iters):
        xy = xy - (distort_normalized(xy, dist) - xy_dist)
    return xy


def reproject_image_to_3d(disparity: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """(H, W) disparity -> (H, W, 3): [X Y Z W]^T = Q [x y d 1]^T, output
    (X, Y, Z)/W, W == 0 mapped to inf (cv2.reprojectImageTo3D,
    handleMissingValues=False)."""
    H, W = disparity.shape
    dt, dev = disparity.dtype, disparity.device
    Q = Q.to(dtype=dt, device=dev)
    y = torch.arange(H, dtype=dt, device=dev)[:, None]
    x = torch.arange(W, dtype=dt, device=dev)[None, :]
    out = [x * Q[i, 0] + y * Q[i, 1] + disparity * Q[i, 2] + Q[i, 3] for i in range(4)]
    w = torch.where(out[3] == 0, torch.full_like(out[3], float("inf")), out[3])
    return torch.stack([out[0] / w, out[1] / w, out[2] / w], dim=-1)


def valid_point_mask(points_3d: torch.Tensor, disparity: torch.Tensor) -> torch.Tensor:
    """Finite 3D coordinates and strictly positive disparity."""
    return torch.isfinite(points_3d).all(dim=-1) & (disparity > 0)
