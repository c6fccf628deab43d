"""Stereo rectification (Bouguet) and the undistort-rectify remap.

Ports of ``stereo_reconstruction_cv_tpu/ops/rectify.py``: cv2.stereoRectify
parity in closed form (run it in float64, as the reference does on the host),
the inverse rectification map and the four-tap bilinear remap
(cv2.remap INTER_LINEAR, BORDER_CONSTANT = 0). The remap is plain tensor code
(gathers) on the device of the image; the reference's banded-matmul and packed
one-gather paths were TPU gather workarounds and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from stereo_reconstruction_cv_tpu_torch.ops import geometry as G


class RectifyResult(NamedTuple):
    R1: Optional[torch.Tensor]  # (3, 3) rectification rotation, camera 1
    R2: Optional[torch.Tensor]
    P1: Optional[torch.Tensor]  # (3, 4) rectified projection, camera 1
    P2: Optional[torch.Tensor]
    Q: torch.Tensor             # (4, 4) disparity-to-depth reprojection


def _undistort_to_plane(pts, K, dist, R=None, P=None):
    """cv2.undistortPoints: pixels (N, 2) -> normalized, or re-projected
    through R, P when given."""
    xy = torch.stack([(pts[..., 0] - K[0, 2]) / K[0, 0],
                      (pts[..., 1] - K[1, 2]) / K[1, 1]], dim=-1)
    if dist is not None:
        xy = G.undistort_normalized(xy, dist, num_iters=20)
    if R is not None:
        v = G.to_homogeneous(xy) @ R.T
        xy = v[..., :2] / v[..., 2:3]
    if P is not None:
        xy = torch.stack([P[0, 0] * xy[..., 0] + P[0, 2],
                          P[1, 1] * xy[..., 1] + P[1, 2]], dim=-1)
    return xy


def _rectangles(K, dist, R, P, image_size: Tuple[int, int]):
    """OpenCV icvGetRectangles: undistort-rectify a 9x9 pixel grid and return
    the (inner, outer) rectangles as (x0, y0, x1, y1)."""
    W, H = image_size
    N = 9
    gx = torch.arange(N, dtype=K.dtype, device=K.device) * ((W - 1) / (N - 1))
    gy = torch.arange(N, dtype=K.dtype, device=K.device) * ((H - 1) / (N - 1))
    mx, my = torch.meshgrid(gx, gy, indexing="xy")
    pts = torch.stack([mx, my], dim=-1).reshape(-1, 2)
    q = _undistort_to_plane(pts, K, dist, R, P).reshape(N, N, 2)
    outer = torch.stack([q[..., 0].min(), q[..., 1].min(), q[..., 0].max(), q[..., 1].max()])
    inner = torch.stack([q[:, 0, 0].max(), q[0, :, 1].max(), q[:, -1, 0].min(), q[-1, :, 1].min()])
    return inner, outer


def stereo_rectify(K1, dist1, K2, dist2, image_size: Tuple[int, int], R, T,
                   alpha: float = -1.0, zero_disparity: bool = True,
                   new_image_size: Tuple[int, int] | None = None) -> RectifyResult:
    """Bouguet stereo rectification, cv2.stereoRectify parity.

    image_size is (width, height); T is the cam1 -> cam2 translation and R the
    relative rotation (x2 = R x1 + T)."""
    W, H = image_size
    nW, nH = new_image_size if new_image_size is not None else image_size
    dt, dev = K1.dtype, K1.device
    T = T.reshape(3).to(dt)
    R = R.to(dt)

    # Split the relative rotation evenly between the two cameras.
    om = G.matrix_to_rodrigues(R)
    r_r = G.rodrigues_to_matrix(om * -0.5)
    t = r_r @ T

    # Rotate the averaged baseline onto the dominant image axis.
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
    wR = G.rodrigues_to_matrix(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T

    ratio = (nW / W / 2.0) if idx == 1 else (nH / H / 2.0)
    fc_new = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * ratio

    # New principal points: centre the projected corners of the ORIGINAL size.
    corners = torch.tensor([[0.0, 0.0], [W - 1.0, 0.0], [0.0, H - 1.0], [W - 1.0, H - 1.0]],
                           dtype=dt, device=dev)
    centre = torch.tensor([(W - 1) / 2, (H - 1) / 2], dtype=dt, device=dev)
    cc = []
    for K, dist, Rk in ((K1, dist1, R1), (K2, dist2, R2)):
        n = _undistort_to_plane(corners, K, dist)
        v = G.to_homogeneous(n) @ Rk.T
        proj = fc_new * v[:, :2] / v[:, 2:3]
        cc.append(centre - proj.mean(dim=0))
    cc1, cc2 = cc
    if zero_disparity:
        cc1 = cc2 = (cc1 + cc2) * 0.5
    else:
        k = 1 if idx == 0 else 0
        m = (cc1[k] + cc2[k]) * 0.5
        cc1 = cc1.clone()
        cc2 = cc2.clone()
        cc1[k] = m
        cc2[k] = m

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

    # cc carries the new-size ratio exactly once: here for alpha < 0, or in
    # the alpha branch (which starts from the unscaled cc) otherwise.
    if alpha < 0:
        scale_xy = torch.tensor([nW / W, nH / H], dtype=dt, device=dev)
        cc1 = cc1 * scale_xy
        cc2 = cc2 * scale_xy
    P1 = make_P(fc_new, cc1, None)
    P2 = make_P(fc_new, cc2, t[idx] * fc_new)

    if alpha >= 0:
        a = min(float(alpha), 1.0)
        inner1, outer1 = _rectangles(K1, dist1, R1, P1, image_size)
        inner2, outer2 = _rectangles(K2, dist2, R2, P2, image_size)
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
    return RectifyResult(R1, R2, P1, P2, Q)


def rectify_map(K, dist, R, P, out_size: Tuple[int, int],
                dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Inverse rectification map (cv2.initUndistortRectifyMap, CV_32FC2):
    the source pixel (x, y) of every destination pixel -> (H, W, 2)."""
    W, H = out_size
    device = device if device is not None else K.device
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
    if dist is not None:
        d = G.distort_normalized(torch.stack([xn, yn], dim=-1),
                                 dist.to(dtype=dtype, device=device))
        xn, yn = d[..., 0], d[..., 1]
    return torch.stack([K[0, 0] * xn + K[0, 2], K[1, 1] * yn + K[1, 2]], dim=-1)


def remap_bilinear(img: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
    """Four-tap bilinear resample, out-of-range taps read 0.
    img (H, W) or (H, W, C); src_map (Ho, Wo, 2) of source (x, y)."""
    H, W = img.shape[:2]
    x = src_map[..., 0]
    y = src_map[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        val = img[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)].to(torch.float32)
        if img.dim() == 3:
            inb = inb[..., None]
        return torch.where(inb, val, torch.zeros_like(val))

    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    if img.dim() == 3:
        w00, w10, w01, w11 = (w[..., None] for w in (w00, w10, w01, w11))
    acc = (tap(x0i, y0i) * w00 + tap(x0i + 1, y0i) * w10
           + tap(x0i, y0i + 1) * w01 + tap(x0i + 1, y0i + 1) * w11)
    if not img.dtype.is_floating_point:
        return torch.round(acc).to(img.dtype)
    return acc.to(img.dtype)


def rectify_remap(img: torch.Tensor, K, dist, R, P,
                  out_size: Tuple[int, int] | None = None) -> torch.Tensor:
    """Map generation + bilinear sample on the image's device."""
    if out_size is None:
        out_size = (img.shape[1], img.shape[0])
    m = rectify_map(K, dist, R, P, out_size, device=img.device)
    return remap_bilinear(img, m)
