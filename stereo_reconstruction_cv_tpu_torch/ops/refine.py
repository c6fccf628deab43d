"""Subpixel refinement of matches: batched inverse-compositional Lucas-Kanade.

A port of ``stereo_reconstruction_cv_tpu/ops/refine.py``. The learned
detector places keypoints to ~0.5-1 px; the geometry path then holds each
left point fixed and slides the right patch to the offset that best aligns
the two images, for all matches at once: a fixed number of 2x2 solves on
bilinearly sampled, zero-mean patches, the Hessian taken once from the
template (the left patch).
"""

from __future__ import annotations

import torch


def _bilinear_patch(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                    off: torch.Tensor) -> torch.Tensor:
    """(N, n, n) patches centred at (cx, cy) (N,), offsets off (n,),
    bilinearly sampled; coordinates clipped to the bilinear domain."""
    H, W = img.shape
    xs = torch.clamp(cx[:, None, None] + off[None, None, :], 0.0, W - 1.001)  # (N, 1, n)
    ys = torch.clamp(cy[:, None, None] + off[None, :, None], 0.0, H - 1.001)  # (N, n, 1)
    x0 = torch.floor(xs).to(torch.int64)
    y0 = torch.floor(ys).to(torch.int64)
    fx = xs - x0
    fy = ys - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)


def refine_matches_lk(imgL: torch.Tensor, imgR: torch.Tensor, pts_l: torch.Tensor,
                      pts_r: torch.Tensor, win: int = 7, iters: int = 8,
                      max_shift: float = 3.0):
    """Refine the right points of matches by LK alignment of the right patch
    to the left one: (refined pts_r (N, 2), moved (N, 2)), float32.

    imgL, imgR: (H, W) grayscale (uint8 or float); pts_l, pts_r: (N, 2) xy.
    A match keeps its input (and moves 0) unless its template is textured
    (det > 1e-6), the drift stays within max_shift on both axes and both
    points lie at least win from the border."""
    L = imgL.to(torch.float32)
    R = imgR.to(torch.float32)
    H, W = L.shape
    off = torch.arange(-win, win + 1, dtype=torch.float32, device=L.device)
    pl = pts_l.to(torch.float32)
    pr0 = pts_r.to(torch.float32)
    tx, ty = pl[:, 0], pl[:, 1]
    T = _bilinear_patch(L, tx, ty, off)
    gx = _bilinear_patch(L, tx + 0.5, ty, off) - _bilinear_patch(L, tx - 0.5, ty, off)
    gy = _bilinear_patch(L, tx, ty + 0.5, off) - _bilinear_patch(L, tx, ty - 0.5, off)
    T = T - T.mean((1, 2), keepdim=True)
    a = (gx * gx).sum((1, 2))
    b = (gx * gy).sum((1, 2))
    c = (gy * gy).sum((1, 2))
    det = a * c - b * b
    ok0 = det > 1e-6
    inv = torch.where(ok0, 1.0 / torch.clamp(det, min=1e-6), torch.zeros_like(det))
    px, py = pr0[:, 0], pr0[:, 1]
    for _ in range(iters):
        I = _bilinear_patch(R, px, py, off)
        e = (I - I.mean((1, 2), keepdim=True)) - T
        bx = (gx * e).sum((1, 2))
        by = (gy * e).sum((1, 2))
        # solve H d = b; I(x + d) ~ T, so move against the residual
        px = px - (c * bx - b * by) * inv
        py = py - (a * by - b * bx) * inv
    pr = torch.stack([px, py], dim=-1)
    d = pr - pr0
    good = (ok0 & (d.abs() <= max_shift).all(-1)
            & (pr[:, 0] >= win) & (pr[:, 0] <= W - 1 - win)
            & (pr[:, 1] >= win) & (pr[:, 1] <= H - 1 - win)
            & (pl[:, 0] >= win) & (pl[:, 0] <= W - 1 - win)
            & (pl[:, 1] >= win) & (pl[:, 1] <= H - 1 - win))
    return (torch.where(good[:, None], pr, pr0),
            torch.where(good[:, None], d, torch.zeros_like(d)))
