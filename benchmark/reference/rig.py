"""Plain rectification, reprojection and point clouds: the benchmark's reference.

cv2.stereoRectify (Bouguet, no distortion), cv2.initUndistortRectifyMap and
cv2.remap (INTER_LINEAR, BORDER_CONSTANT = 0), cv2.reprojectImageTo3D and
the cloud of a pair (the points with valid & finite & disp > 0, in row-major
order), as the port states them: a frozen copy of their arithmetic, with the
distortion terms dropped (the benchmark's rigs have none). The rig's maps and
Q are worked out here from K, R and T. Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class Rectification(NamedTuple):
    R1: torch.Tensor
    R2: torch.Tensor
    P1: torch.Tensor
    P2: torch.Tensor
    Q: torch.Tensor


def _homogeneous(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def rodrigues_to_matrix(rvecs: torch.Tensor) -> torch.Tensor:
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


def _to_plane(pts, K, R=None, P=None):
    xy = torch.stack([(pts[..., 0] - K[0, 2]) / K[0, 0],
                      (pts[..., 1] - K[1, 2]) / K[1, 1]], dim=-1)
    if R is not None:
        v = _homogeneous(xy) @ R.T
        xy = v[..., :2] / v[..., 2:3]
    if P is not None:
        xy = torch.stack([P[0, 0] * xy[..., 0] + P[0, 2],
                          P[1, 1] * xy[..., 1] + P[1, 2]], dim=-1)
    return xy


def _rectangles(K, R, P, image_size: Tuple[int, int]):
    W, H = image_size
    N = 9
    gx = torch.arange(N, dtype=K.dtype, device=K.device) * ((W - 1) / (N - 1))
    gy = torch.arange(N, dtype=K.dtype, device=K.device) * ((H - 1) / (N - 1))
    mx, my = torch.meshgrid(gx, gy, indexing="xy")
    pts = torch.stack([mx, my], dim=-1).reshape(-1, 2)
    q = _to_plane(pts, K, R, P).reshape(N, N, 2)
    outer = torch.stack([q[..., 0].min(), q[..., 1].min(), q[..., 0].max(), q[..., 1].max()])
    inner = torch.stack([q[:, 0, 0].max(), q[0, :, 1].max(), q[:, -1, 0].min(), q[-1, :, 1].min()])
    return inner, outer


def stereo_rectify(K1, K2, image_size: Tuple[int, int], R, T, alpha: float) -> Rectification:
    """Bouguet rectification of the rig x2 = R x1 + T; image_size (W, H);
    float64 tensors in, as the rig's constants are worked out on the host."""
    W, H = image_size
    nW, nH = W, H
    dt, dev = K1.dtype, K1.device
    T = T.reshape(3).to(dt)
    R = R.to(dt)
    om = matrix_to_rodrigues(R)
    r_r = rodrigues_to_matrix(om * -0.5)
    t = r_r @ T
    idx = 0 if abs(float(t[0])) > abs(float(t[1])) else 1
    c = t[idx]
    uu = torch.zeros(3, dtype=dt, device=dev)
    uu[idx] = 1.0 if float(c) > 0 else -1.0
    ww = torch.linalg.cross(t, uu)
    nw = torch.linalg.norm(ww)
    nt = torch.linalg.norm(t)
    ang = torch.arccos(torch.abs(c) / nt)
    if float(nw) > 0:
        ww = ww * (ang / nw)
    wR = rodrigues_to_matrix(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T
    ratio = (nW / W / 2.0) if idx == 1 else (nH / H / 2.0)
    fc_new = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * ratio
    corners = torch.tensor([[0.0, 0.0], [W - 1.0, 0.0], [0.0, H - 1.0], [W - 1.0, H - 1.0]],
                           dtype=dt, device=dev)
    centre = torch.tensor([(W - 1) / 2, (H - 1) / 2], dtype=dt, device=dev)
    cc = []
    for K, Rk in ((K1, R1), (K2, R2)):
        n = _to_plane(corners, K)
        v = _homogeneous(n) @ Rk.T
        proj = fc_new * v[:, :2] / v[:, 2:3]
        cc.append(centre - proj.mean(dim=0))
    cc1 = cc2 = (cc[0] + cc[1]) * 0.5

    def make_P(fc, cpt, tterm):
        P = torch.zeros((3, 4), dtype=dt, device=dev)
        P[0, 0] = fc
        P[1, 1] = fc
        P[2, 2] = 1.0
        P[0, 2] = cpt[0]
        P[1, 2] = cpt[1]
        if tterm is not None:
            P[idx, 3] = tterm
        return P

    if alpha < 0:
        scale_xy = torch.tensor([nW / W, nH / H], dtype=dt, device=dev)
        cc1 = cc1 * scale_xy
        cc2 = cc2 * scale_xy
    P1 = make_P(fc_new, cc1, None)
    P2 = make_P(fc_new, cc2, t[idx] * fc_new)
    if alpha >= 0:
        a = min(float(alpha), 1.0)
        inner1, outer1 = _rectangles(K1, R1, P1, image_size)
        inner2, outer2 = _rectangles(K2, R2, P2, image_size)
        cx1_0, cy1_0 = cc1[0], cc1[1]
        cx2_0, cy2_0 = cc2[0], cc2[1]
        cx1, cy1 = nW * cx1_0 / W, nH * cy1_0 / H
        cx2, cy2 = nW * cx2_0 / W, nH * cy2_0 / H

        def s_of(rect, cx_0, cy_0, cx, cy):
            x0, y0, x1, y1 = rect[0], rect[1], rect[2], rect[3]
            return torch.stack([cx / (cx_0 - x0), cy / (cy_0 - y0),
                                (nW - 1 - cx) / (x1 - cx_0), (nH - 1 - cy) / (y1 - cy_0)])

        s0 = torch.maximum(s_of(inner1, cx1_0, cy1_0, cx1, cy1).max(),
                           s_of(inner2, cx2_0, cy2_0, cx2, cy2).max())
        s1 = torch.minimum(s_of(outer1, cx1_0, cy1_0, cx1, cy1).min(),
                           s_of(outer2, cx2_0, cy2_0, cx2, cy2).min())
        s = s0 * (1.0 - a) + s1 * a
        fc_new = fc_new * s
        cc1 = torch.stack([cx1, cy1])
        cc2 = torch.stack([cx2, cy2])
        P1 = make_P(fc_new, cc1, None)
        P2 = make_P(fc_new, cc2, t[idx] * fc_new)
    Q = torch.zeros((4, 4), dtype=dt, device=dev)
    Q[0, 0] = 1.0
    Q[1, 1] = 1.0
    Q[0, 3] = -cc1[0]
    Q[1, 3] = -cc1[1]
    Q[2, 3] = fc_new
    Q[3, 2] = -1.0 / t[idx]
    Q[3, 3] = (cc1[0] - cc2[0]) / t[idx]
    return Rectification(R1, R2, P1, P2, Q)


def rectify_map(K, R, P, out_size: Tuple[int, int], device) -> torch.Tensor:
    """Source pixel (x, y) of every rectified pixel, (H, W, 2) float32."""
    W, H = out_size
    dtype = torch.float32
    K, R, P = (a.to(dtype=dtype, device=device) for a in (K, R, P))
    u = torch.arange(W, dtype=dtype, device=device)[None, :].expand(H, W)
    v = torch.arange(H, dtype=dtype, device=device)[:, None].expand(H, W)
    x = (u - P[0, 2]) / P[0, 0]
    y = (v - P[1, 2]) / P[1, 1]
    Rinv = torch.linalg.inv(R)
    X = Rinv[0, 0] * x + Rinv[0, 1] * y + Rinv[0, 2]
    Y = Rinv[1, 0] * x + Rinv[1, 1] * y + Rinv[1, 2]
    Wh = Rinv[2, 0] * x + Rinv[2, 1] * y + Rinv[2, 2]
    xn = X / Wh
    yn = Y / Wh
    return torch.stack([K[0, 0] * xn + K[0, 2], K[1, 1] * yn + K[1, 2]], dim=-1)


def remap_bilinear(img: torch.Tensor, src_map: torch.Tensor,
                   weight_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Four-tap bilinear resample of an (H, W) uint8 image, taps outside read
    0, rounded back to uint8. `weight_dtype` below float32 is the control's
    lower precision."""
    H, W = img.shape
    x = src_map[..., 0]
    y = src_map[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).to(weight_dtype).to(torch.float32)
    fy = (y - y0).to(weight_dtype).to(torch.float32)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        val = img[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)].to(torch.float32)
        return torch.where(inb, val, torch.zeros_like(val))

    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    acc = (tap(x0i, y0i) * w00 + tap(x0i + 1, y0i) * w10
           + tap(x0i, y0i + 1) * w01 + tap(x0i + 1, y0i + 1) * w11)
    return torch.round(acc).to(img.dtype)


def reproject(disp: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """(H, W) disparity -> (H, W, 3) points (X, Y, Z) / W, W == 0 -> inf."""
    H, W = disp.shape
    dt, dev = disp.dtype, disp.device
    Q = Q.to(dtype=dt, device=dev)
    y = torch.arange(H, dtype=dt, device=dev)[:, None]
    x = torch.arange(W, dtype=dt, device=dev)[None, :]
    out = [x * Q[i, 0] + y * Q[i, 1] + disp * Q[i, 2] + Q[i, 3] for i in range(4)]
    w = torch.where(out[3] == 0, torch.full_like(out[3], float("inf")), out[3])
    return torch.stack([out[0] / w, out[1] / w, out[2] / w], dim=-1)


def cloud(disp: torch.Tensor, valid: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """The pair's cloud: (N, 3) points with valid & finite & disp > 0, row-major."""
    pts = reproject(disp, Q)
    mask = valid & torch.isfinite(pts).all(dim=-1) & (disp > 0)
    return pts[mask]
