"""Corner refinement: the batched, patch-resident cornerSubPix.

A port of ``corner_subpix_patch`` from
``stereo_reconstruction_cv_tpu/calib/chessboard.py``, the refinement the
learned detector runs on every keypoint (``models/xfeat.py``). The rest of
that module (the chessboard detector and its lattice) is not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _interp_weights(c_patch: torch.Tensor, moff: torch.Tensor, kk: torch.Tensor) -> torch.Tensor:
    """(N, m, P) separable bilinear weights of positions c_patch + moff in
    patch coordinates [0, P)."""
    pos = c_patch[:, None] + moff                     # (N, m)
    f0 = torch.floor(pos)
    fr = (pos - f0)[..., None]
    d = kk - f0[..., None]                            # (N, m, P)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    return torch.where(d == 0, 1.0 - fr, zero) + torch.where(d == 1, fr, zero)


def corner_subpix_patch(img: torch.Tensor, corners: torch.Tensor, win: int = 3,
                        max_iter: int = 5, max_drift: float = 3.0) -> torch.Tensor:
    """cv2.cornerSubPix's gradient-weighted 2x2 normal solve, for all N
    corners at once: an (H, W) image with (N, 2) xy -> refined (N, 2), or
    a batch of images (B, H, W) with (B, N, 2) -> (B, N, 2) in one pass.

    Each corner takes one (P, P) patch around its starting pixel, P = 2 (win
    + 2 + ceil(max_drift)) + 1, from the image edge-padded by P // 2 (so a
    border keypoint's patch stays centred on it), and every iteration
    resamples the shifted window inside the patch as two batched products,
    S = Wy @ patch @ Wx^T with separable bilinear weights. The iteration
    count is fixed, each step moves at most 2 px and the centre stays where
    every sample lies inside the patch. Computes in float64 when `corners`
    is float64, else in float32 (the reference's type)."""
    dt = torch.float64 if corners.dtype == torch.float64 else torch.float32
    dev = corners.device
    batched = img.dim() == 3
    if not batched:
        img, corners = img[None], corners[None]
    imgf = img.to(dt)
    B, H, W = imgf.shape
    off = torch.arange(-win, win + 1, dtype=dt, device=dev)
    wx = 1.0 - off.abs() / (win + 1)
    weight = wx[:, None] * wx[None, :]
    gy_off, gx_off = torch.meshgrid(off, off, indexing="ij")

    # Samples reach win + 1 around the centre (the gradients' extra texel),
    # the centre may drift by ceil(max_drift), and bilinear reads one texel
    # past the floor.
    half = win + 2 + int(math.ceil(max_drift))
    P = 2 * half + 1
    padded = F.pad(imgf[:, None], (half, half, half, half), mode="replicate")[:, 0]
    bi = torch.arange(B, device=dev).repeat_interleave(corners.shape[1])
    corners = corners.to(dt).reshape(-1, 2)
    x0 = torch.clamp(torch.floor(corners[:, 0]).to(torch.int64), 0, W - 1)
    y0 = torch.clamp(torch.floor(corners[:, 1]).to(torch.int64), 0, H - 1)
    rng = torch.arange(P, device=dev)
    # one gather: patch midpoint = image pixel (x0, y0)
    patches = padded[bi[:, None, None], y0[:, None, None] + rng[None, :, None],
                     x0[:, None, None] + rng[None, None, :]]

    kk = torch.arange(P, dtype=dt, device=dev)
    moff = torch.arange(-(win + 1), win + 2, dtype=dt, device=dev)
    lim = float(half - win - 2)
    ox, oy = x0.to(dt), y0.to(dt)
    cx = corners[:, 0] - ox + half  # patch coordinates, midpoint at `half`
    cy = corners[:, 1] - oy + half
    for _ in range(max_iter):
        cxp = torch.clamp(cx, half - lim, half + lim)
        cyp = torch.clamp(cy, half - lim, half + lim)
        S = _interp_weights(cyp, moff, kk) @ patches @ _interp_weights(cxp, moff, kk).transpose(1, 2)
        gx = (S[:, 1:-1, 2:] - S[:, 1:-1, :-2]) * 0.5   # (N, n, n)
        gy = (S[:, 2:, 1:-1] - S[:, :-2, 1:-1]) * 0.5
        xs = cxp[:, None, None] + gx_off
        ys = cyp[:, None, None] + gy_off
        a = (weight * gx * gx).sum((1, 2))
        b = (weight * gx * gy).sum((1, 2))
        c = (weight * gy * gy).sum((1, 2))
        bx = (weight * (gx * gx * xs + gx * gy * ys)).sum((1, 2))
        by = (weight * (gx * gy * xs + gy * gy * ys)).sum((1, 2))
        det = a * c - b * b
        ok = det.abs() > 1e-12
        safe = torch.where(ok, det, torch.ones_like(det))
        nx = torch.where(ok, (c * bx - b * by) / safe, cxp)
        ny = torch.where(ok, (a * by - b * bx) / safe, cyp)
        cx = torch.minimum(torch.maximum(nx, cxp - 2.0), cxp + 2.0)
        cy = torch.minimum(torch.maximum(ny, cyp - 2.0), cyp + 2.0)
    out = torch.stack([cx - half + ox, cy - half + oy], dim=-1).reshape(B, -1, 2)
    return out if batched else out[0]
