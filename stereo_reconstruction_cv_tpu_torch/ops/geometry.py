"""Camera geometry on tensors.

Ports of ``stereo_reconstruction_cv_tpu/ops/geometry.py`` (cv2.Rodrigues,
distortion, cv2.projectPoints, cv2.computeCorrespondEpilines, epipolar and
Sampson errors, cv2.triangulatePoints and cv2.reprojectImageTo3D parity).
Conventions follow OpenCV: points are (x, y) = (col, row); distortion is
(k1, k2, p1, p2, k3). Every function keeps the dtype and device of its
inputs; the epipolar errors also take a batch of matrices (M, 3, 3) and then
return (M, N).
"""

from __future__ import annotations

import torch

from stereo_reconstruction_cv_tpu_torch.ops.cuda import cloud as CL


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., D+1) with a trailing 1."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def from_homogeneous(pts: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """(..., D+1) -> (..., D), dividing by the last coordinate; |w| < eps is
    pushed out to eps with w's sign (+eps at 0)."""
    w = pts[..., -1:]
    if eps:
        w = torch.where(w.abs() < eps, torch.sign(w) * eps + (w == 0).to(w.dtype) * eps, w)
    return pts[..., :-1] / w


def rodrigues_to_matrix(rvecs: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), cv2.Rodrigues;
    series expansions near theta = 0. Indexes no tensor by a value, so it
    runs under torch.func.vmap and jacfwd (the calibration's Jacobians)."""
    theta2 = (rvecs * rvecs).sum(-1)[..., None, None]
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-16
    one = torch.ones_like(theta)
    s = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / torch.where(small, one, theta))
    c1 = torch.where(small, 0.5 - theta2 / 24.0,
                     (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    kx, ky, kz = rvecs[..., 0], rvecs[..., 1], rvecs[..., 2]
    z = torch.zeros_like(kx)
    K = torch.stack([torch.stack([z, -kz, ky], -1), torch.stack([kz, z, -kx], -1),
                     torch.stack([-ky, kx, z], -1)], -2)
    eye = torch.eye(3, dtype=rvecs.dtype, device=rvecs.device)
    return eye + s * K + c1 * (K @ K)


def matrix_to_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3), cv2.Rodrigues,
    through the unit quaternion of Shepperd's method (the largest of the
    four pivots, w >= 0); the pivot is gathered, not indexed, so it runs
    under torch.func.vmap and jacfwd."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t0 = 1.0 + m00 + m11 + m22
    t1 = 1.0 + m00 - m11 - m22
    t2 = 1.0 - m00 + m11 - m22
    t3 = 1.0 - m00 - m11 + m22
    qs = torch.stack([
        torch.stack([t0, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, t1, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, t2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m12 + m21, t3], -1),
    ], -2)
    ts = torch.stack([t0, t1, t2, t3], -1)
    i = torch.argmax(ts, dim=-1, keepdim=True)
    ti = torch.gather(ts, -1, i)
    q = torch.gather(qs, -2, i[..., None].expand(*i.shape[:-1], 1, 4))[..., 0, :]
    q = q * (0.5 / torch.sqrt(torch.clamp(ti, min=1e-30)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w, v = q[..., 0], q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    tiny = (vn < 1e-30)[..., None]
    axis = v / torch.where(tiny, torch.ones_like(vn[..., None]), vn[..., None])
    return torch.where(tiny, torch.zeros_like(v), axis * theta[..., None])


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


def project_points(object_points: torch.Tensor, rvec: torch.Tensor, tvec: torch.Tensor,
                   K: torch.Tensor, dist: torch.Tensor | None = None) -> torch.Tensor:
    """3D points (N, 3) -> pixels (N, 2) (cv2.projectPoints); with V poses,
    (V, 3) rvecs and tvecs, -> (V, N, 2) (vmap- and jacfwd-safe)."""
    R = rodrigues_to_matrix(rvec)
    cam = object_points @ R.transpose(-1, -2) + tvec[..., None, :]
    xy = cam[..., :2] / cam[..., 2:3]
    if dist is not None:
        xy = distort_normalized(xy, dist)
    u = K[0, 0] * xy[..., 0] + K[0, 1] * xy[..., 1] + K[0, 2]
    v = K[1, 1] * xy[..., 1] + K[1, 2]
    return torch.stack([u, v], dim=-1)


def compute_epilines(pts: torch.Tensor, F: torch.Tensor, which_image: int) -> torch.Tensor:
    """Epipolar lines (a, b, c), a^2 + b^2 = 1, of points (N, 2)
    (cv2.computeCorrespondEpilines): which_image 1 gives lines in image 2
    (l = F x), 2 gives lines in image 1 (l = F^T x)."""
    lines = to_homogeneous(pts) @ (F.transpose(-1, -2) if which_image == 1 else F)
    nrm = torch.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2)
    nrm = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    return lines / nrm[..., None]


def epipolar_distance(F: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """Symmetric point-to-epiline distance of each correspondence (N,)."""
    x1, x2 = to_homogeneous(pts1), to_homogeneous(pts2)
    l2 = x1 @ F.transpose(-1, -2)
    l1 = x2 @ F
    num = (x2 * l2).sum(-1).abs()
    d2 = num / torch.sqrt(l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-30)
    d1 = num / torch.sqrt(l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-30)
    return 0.5 * (d1 + d2)


def sampson_error(F: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) error of each correspondence (N,)."""
    x1, x2 = to_homogeneous(pts1), to_homogeneous(pts2)
    Fx1 = x1 @ F.transpose(-1, -2)
    Ftx2 = x2 @ F
    num = (x2 * Fx1).sum(-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / (den + 1e-30)


def triangulate_points(P1: torch.Tensor, P2: torch.Tensor, pts1: torch.Tensor,
                       pts2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation (cv2.triangulatePoints up to each point's scale):
    P1, P2 (3, 4), pts (N, 2) -> unit homogeneous points (N, 4), each the
    right singular vector of its 4x4 system's smallest singular value."""
    A = torch.stack([pts1[:, :1] * P1[2] - P1[0], pts1[:, 1:] * P1[2] - P1[1],
                     pts2[:, :1] * P2[2] - P2[0], pts2[:, 1:] * P2[2] - P2[1]], dim=1)
    return torch.linalg.svd(A).Vh[:, -1, :]


def triangulate_to_3d(P1: torch.Tensor, P2: torch.Tensor, pts1: torch.Tensor,
                      pts2: torch.Tensor) -> torch.Tensor:
    """Triangulate and dehomogenise -> (N, 3)."""
    return from_homogeneous(triangulate_points(P1, P2, pts1, pts2), eps=1e-30)


def reproject_image_to_3d(disparity: torch.Tensor, Q, out: torch.Tensor | None = None) -> torch.Tensor:
    """(H, W) disparity -> (H, W, 3): [X Y Z W]^T = Q [x y d 1]^T, output
    (X, Y, Z)/W, W == 0 mapped to inf (cv2.reprojectImageTo3D,
    handleMissingValues=False); written into `out` (H, W, 3) when given.

    A CPU disparity takes the plain torch ops; a CUDA one the kernel, one
    launch with Q's values as its arguments, which takes a float32 map only
    (ops/cuda/cloud.py). Give Q on the host (numpy or a CPU tensor): a CUDA
    Q is read back first, which waits for the device."""
    if disparity.device.type == "cpu":
        return CL.reproject_plain(disparity, Q, out)
    return CL.reproject_cuda(disparity, Q, out)


def valid_point_mask(points_3d: torch.Tensor, disparity: torch.Tensor) -> torch.Tensor:
    """Finite 3D coordinates and strictly positive disparity."""
    return torch.isfinite(points_3d).all(dim=-1) & (disparity > 0)
