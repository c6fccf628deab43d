"""Zhang calibration with Levenberg-Marquardt refinement (cv2.calibrateCamera).

A port of ``stereo_reconstruction_cv_tpu/calib/zhang.py``: view homographies
by normalised DLT, K in closed form from them (Zhang's B matrix), each view's
pose from its homography, then a fixed number of LM steps over [fx, fy, cx,
cy, k1, k2, p1, p2, k3, rvecs, tvecs] with exact forward-mode Jacobians
(``torch.func.jacfwd``). Everything runs in float64 on the device of the
corners, and the LM loop makes no host sync: acceptance is a
``torch.where`` and the solve skips the singularity check that would read
back its status.

Model: K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], distortion (k1, k2, p1,
p2, k3), no skew (OpenCV's default). The reference's accuracy anchor is a
mean reprojection error of 0.14876 px on its 44-view 4K set.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from stereo_reconstruction_cv_tpu_torch.ops import epipolar as EP
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G


def build_object_points(cols: int = 9, rows: int = 7, square: float = 1.0,
                        device="cpu") -> torch.Tensor:
    """(cols * rows, 3) float64 planar grid, z = 0, x fastest (the
    reference's np.mgrid layout)."""
    xs = torch.arange(cols, dtype=torch.float64, device=device) * square
    ys = torch.arange(rows, dtype=torch.float64, device=device) * square
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), torch.zeros_like(gx.reshape(-1))], dim=-1)


def homography_dlt(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Normalised DLT homography dst ~ H src: (..., N, 2) points (src
    broadcast against dst) -> (..., 3, 3) with H[2, 2] = 1, which also
    removes the eigenvector's sign."""
    src = src.expand_as(dst)
    s, Ts = EP.normalize_points(src)
    d, Td = EP.normalize_points(dst)
    x, y = s[..., 0], s[..., 1]
    u, v = d[..., 0], d[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    vec = torch.linalg.eigh(A.transpose(-1, -2) @ A).eigenvectors[..., :, 0]
    H = torch.linalg.inv(Td) @ vec.reshape(vec.shape[:-1] + (3, 3)) @ Ts
    return H / H[..., 2:, 2:]


def _v(H: torch.Tensor, i: int, j: int) -> torch.Tensor:
    h = lambda r, c: H[..., r, c]  # noqa: E731
    return torch.stack([
        h(0, i) * h(0, j),
        h(0, i) * h(1, j) + h(1, i) * h(0, j),
        h(1, i) * h(1, j),
        h(2, i) * h(0, j) + h(0, i) * h(2, j),
        h(2, i) * h(1, j) + h(1, i) * h(2, j),
        h(2, i) * h(2, j),
    ], dim=-1)


def zhang_intrinsics(Hs: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
    """Closed-form K from (V, 3, 3) view homographies (Zhang's B matrix).
    The formulas are invariant to the sign of the null vector b. When the
    conic is not positive (degenerate motion), K falls back to the image
    centre and one focal length from the same b."""
    W, H_img = image_size
    Vm = torch.stack([_v(Hs, 0, 1), _v(Hs, 0, 0) - _v(Hs, 1, 1)], dim=1).reshape(-1, 6)
    b = torch.linalg.eigh(Vm.T @ Vm).eigenvectors[:, 0]
    B11, B12, B22, B13, B23, B33 = b.unbind()
    den = B11 * B22 - B12 * B12
    cy = (B12 * B13 - B11 * B23) / den
    lam = B33 - (B13 * B13 + cy * (B12 * B13 - B11 * B23)) / B11
    fx2 = lam / B11
    fy2 = lam * B11 / den
    fx = torch.sqrt(torch.abs(fx2))
    fy = torch.sqrt(torch.abs(fy2))
    cx = -B13 * fx * fx / lam
    ok = (fx2 > 0) & (fy2 > 0)
    fx_fb = torch.sqrt(torch.abs(lam / torch.where(B11 == 0, torch.full_like(B11, 1e-12), B11)))
    z, one = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([torch.stack([fx, z, cx]), torch.stack([z, fy, cy]), torch.stack([z, z, one])])
    K_fb = torch.stack([torch.stack([fx_fb, z, z + (W - 1) / 2.0]),
                        torch.stack([z, fx_fb, z + (H_img - 1) / 2.0]),
                        torch.stack([z, z, one])])
    return torch.where(ok, K, K_fb)


def extrinsics_from_homography(H: torch.Tensor, K: torch.Tensor):
    """Pose (rvec, tvec) of a planar target from H = K [r1 r2 t], for one
    (3, 3) homography or a batch (..., 3, 3): [r1 r2 r1 x r2] projected onto
    SO(3) by SVD; a target behind the camera (t_z < 0) flips to the pose in
    front (R's first two columns and t negated)."""
    M = torch.linalg.inv(K) @ H
    lam = 1.0 / torch.linalg.norm(M[..., :, 0], dim=-1)
    r1 = lam[..., None] * M[..., :, 0]
    r2 = lam[..., None] * M[..., :, 1]
    t = lam[..., None] * M[..., :, 2]
    R = torch.stack([r1, r2, torch.linalg.cross(r1, r2)], dim=-1)
    U, _, Vh = torch.linalg.svd(R)
    R = U @ Vh
    R = R * torch.sign(torch.linalg.det(R))[..., None, None]
    flip = t[..., 2] < 0
    cols = torch.tensor([-1.0, -1.0, 1.0], dtype=R.dtype, device=R.device)
    R = torch.where(flip[..., None, None], R * cols, R)
    t = torch.where(flip[..., None], -t, t)
    return G.matrix_to_rodrigues(R), t


class CalibrationResult(NamedTuple):
    K: torch.Tensor               # (3, 3)
    dist: torch.Tensor            # (5,) k1 k2 p1 p2 k3
    rvecs: torch.Tensor           # (V, 3)
    tvecs: torch.Tensor           # (V, 3)
    rms: torch.Tensor             # sqrt(mean squared residual), cv2's return
    per_view_error: torch.Tensor  # (V,) L2 norm of a view's residuals / N
    mean_error: torch.Tensor      # the reference's metric (gui.py:68-73)


def camera_matrix(v: torch.Tensor) -> torch.Tensor:
    """K from (fx, fy, cx, cy), differentiable in them."""
    fx, fy, cx, cy = v.unbind()
    z, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, z, cx]), torch.stack([z, fy, cy]),
                        torch.stack([z, z, one])])


def _pack(K, dist, rvecs, tvecs) -> torch.Tensor:
    return torch.cat([torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]), dist,
                      rvecs.reshape(-1), tvecs.reshape(-1)])


def _unpack(theta: torch.Tensor, V: int):
    return (camera_matrix(theta[0:4]), theta[4:9], theta[9:9 + 3 * V].reshape(V, 3),
            theta[9 + 3 * V:].reshape(V, 3))


def _residuals(theta, obj_pts, img_pts) -> torch.Tensor:
    """(V * N * 2,) reprojection residuals."""
    K, dist, rvecs, tvecs = _unpack(theta, img_pts.shape[0])
    return (G.project_points(obj_pts, rvecs, tvecs, K, dist) - img_pts).reshape(-1)


def levenberg_marquardt(res_fn: Callable[[torch.Tensor], torch.Tensor], theta0: torch.Tensor,
                        steps: int) -> torch.Tensor:
    """`steps` LM steps on sum(res_fn(theta)^2) from theta0, as the
    reference's lax.scan runs them: damping lam diag(J^T J + 1e-12), lam
    from 1e-3, halved on a step that lowers the cost (taken) and x4 on one
    that does not (kept). No host sync: the solve does not check for a
    singular system, and the choice is a torch.where."""
    jac = torch.func.jacfwd(lambda th: (res_fn(th),) * 2, has_aux=True)
    lam = torch.full((), 1e-3, dtype=theta0.dtype, device=theta0.device)  # a fill, no copy
    cost = torch.sum(res_fn(theta0) ** 2)
    theta = theta0
    for _ in range(steps):
        J, r = jac(theta)
        JtJ = J.T @ J
        A = JtJ + lam * torch.diag(torch.diagonal(JtJ) + 1e-12)
        delta = torch.linalg.solve_ex(A, -(J.T @ r), check_errors=False).result
        theta_new = theta + delta
        new_cost = torch.sum(res_fn(theta_new) ** 2)
        accept = new_cost < cost
        theta = torch.where(accept, theta_new, theta)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cost = torch.where(accept, new_cost, cost)
    return theta


def calibrate_camera(obj_pts: torch.Tensor, img_pts: torch.Tensor,
                     image_size: Tuple[int, int], max_iters: int = 30) -> CalibrationResult:
    """Zhang's initialisation, then max_iters LM steps, in float64 on the
    device of img_pts. obj_pts: (N, 3) planar target (z = 0), shared by the
    views; img_pts: (V, N, 2) detected corners; image_size: (W, H)."""
    dev = img_pts.device
    obj = torch.as_tensor(obj_pts).to(device=dev, dtype=torch.float64)
    img = img_pts.to(torch.float64)
    V = img.shape[0]
    Hs = homography_dlt(obj[:, :2], img)
    K0 = zhang_intrinsics(Hs, image_size)
    rvecs0, tvecs0 = extrinsics_from_homography(Hs, K0)
    theta0 = _pack(K0, torch.zeros(5, dtype=torch.float64, device=dev), rvecs0, tvecs0)
    res_fn = lambda th: _residuals(th, obj, img)  # noqa: E731
    theta = levenberg_marquardt(res_fn, theta0, max_iters)
    K, dist, rvecs, tvecs = _unpack(theta, V)
    r = res_fn(theta).reshape(V, -1, 2)
    rms = torch.sqrt(torch.mean(torch.sum(r ** 2, dim=-1)))
    # the reference's metric (gui.py:68-73): per view the L2 norm of the
    # residuals over the point count, then the mean over views
    per_view = torch.linalg.norm(r.reshape(V, -1), dim=-1) / r.shape[1]
    return CalibrationResult(K, dist, rvecs, tvecs, rms, per_view, per_view.mean())
