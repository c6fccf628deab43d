"""Chessboard corner detection and subpixel refinement.

A port of ``stereo_reconstruction_cv_tpu/calib/chessboard.py``
(cv2.findChessboardCorners + cv2.cornerSubPix of the calibration tab). On
the device: the saddle-point response (the negative Hessian determinant of
the smoothed image), non-maximum suppression, and the refinement of every
corner at once, ``corner_subpix`` (the full-image refiner of the detector)
and ``corner_subpix_patch`` (the patch-resident one the learned detector
runs on every keypoint). On the host, in numpy: growing the cols x rows
lattice from the 256 candidates (``_grow_grid``), whose one device-to-host
copy per try is those candidates.

Corners come out row-major along the board's (cols, rows) grid, x fastest,
so they pair with ``calib.zhang.build_object_points``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _gauss_kernel(sigma: float, radius: int) -> torch.Tensor:
    """Normalised float32 Gaussian taps, computed on the host so that every
    device convolves with the same weights."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _sep_conv(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable 2D convolution of an (H, W) image with edge padding: columns
    first, then rows. The kernel is symmetric, so correlation is convolution;
    the taps are summed in one fixed order (no cuDNN), the same on every
    device."""
    r = (k.shape[0] - 1) // 2
    H, W = img.shape
    k = k.to(img.device)
    p = F.pad(img[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    out = k[0] * p[0:H]
    for i in range(1, 2 * r + 1):
        out = out + k[i] * p[i:i + H]
    p = F.pad(out[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    out = k[0] * p[:, 0:W]
    for i in range(1, 2 * r + 1):
        out = out + k[i] * p[:, i:i + W]
    return out


def saddle_response(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """The negative Hessian determinant of the Gaussian-smoothed image,
    clamped at 0: chessboard X-corners are strong saddles (det H < 0), blobs
    and edges are not. (H, W) -> (H, W) float32."""
    g = _sep_conv(img.to(torch.float32), _gauss_kernel(sigma, int(3 * sigma)))
    dy, dx = torch.gradient(g)
    dyy, dyx = torch.gradient(dy)
    dxy, dxx = torch.gradient(dx)
    det = dxx * dyy - 0.25 * (dxy + dyx) ** 2
    return torch.clamp(-det, min=0.0)


def nms_candidates(response: torch.Tensor, num: int = 256,
                   radius: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `num` strongest local maxima of a response that is >= 0: ((num,
    2) float32 xy, (num,) scores), padded with score 0. A maximum is >= its
    (2 radius + 1)^2 window and > 0; ties in score keep the lower flat index
    first (a stable sort, as jax.lax.top_k orders them)."""
    H, W = response.shape
    peak = F.max_pool2d(response[None, None], 2 * radius + 1, 1, radius)[0, 0]
    is_max = (response == peak) & (response > 0)
    flat = torch.where(is_max, response, torch.zeros_like(response)).reshape(-1)
    scores, idx = torch.sort(flat, descending=True, stable=True)
    scores, idx = scores[:num], idx[:num]
    return torch.stack([idx % W, idx // W], dim=-1).to(torch.float32), scores


def _window_sums(q: torch.Tensor) -> torch.Tensor:
    """Sums over the last two axes in one fixed pairwise order (zero-padded
    to a power of two, then halved), so that every device adds the same
    float32 pairs: torch's CUDA and CPU reductions order their adds
    differently, and at 4K coordinates the normal equations amplify that
    to ~1e-3 px."""
    q = q.reshape(q.shape[:-2] + (-1,))
    n = 1 << (q.shape[-1] - 1).bit_length()
    q = F.pad(q, (0, n - q.shape[-1]))
    while q.shape[-1] > 1:
        h = q.shape[-1] // 2
        q = q[..., :h] + q[..., h:]
    return q[..., 0]


def corner_subpix(img: torch.Tensor, corners: torch.Tensor, win: int = 11,
                  max_iter: int = 30) -> torch.Tensor:
    """cv2.cornerSubPix's gradient-weighted least squares for all N corners
    of an (H, W) image at once: (N, 2) xy -> refined (N, 2) float32.

    Each of max_iter fixed steps samples the (2 win + 1)^2 window around
    the current centre bilinearly from the full image (indices clamped to
    [0, W - 2] x [0, H - 2], the reference's border rule), takes central
    differences, and solves the 2x2 normal system; a step moves at most 2
    px, a singular system keeps the centre. The four shifted samples of a
    step go through one gather, and the window sums add in one fixed order
    (``_window_sums``), so the card's corners equal the CPU's."""
    imgf = img.to(torch.float32)
    H, W = imgf.shape
    flat = imgf.reshape(-1)
    dev = imgf.device
    # the window's weights on the host: CUDA divides by a scalar as a product
    # with its reciprocal, one ulp off the CPU's quotient
    off = torch.arange(-win, win + 1, dtype=torch.float32)
    wx = 1.0 - off.abs() / (win + 1)
    weight = (wx[:, None] * wx[None, :]).to(dev)
    gy_off, gx_off = (g.to(dev) for g in torch.meshgrid(off, off, indexing="ij"))
    # the four samples of a step: (y, x + 1), (y, x - 1), (y + 1, x), (y - 1, x)
    dys = torch.tensor([0.0, 0.0, 1.0, -1.0], device=dev)[:, None, None, None]
    dxs = torch.tensor([1.0, -1.0, 0.0, 0.0], device=dev)[:, None, None, None]

    def bilinear(y, x):
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        x0c = torch.clamp(x0.to(torch.int64), 0, W - 2)
        y0c = torch.clamp(y0.to(torch.int64), 0, H - 2)
        i = y0c * W + x0c
        v00, v10, v01, v11 = flat[i], flat[i + 1], flat[i + W], flat[i + W + 1]
        return (v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy)
                + v01 * (1 - fx) * fy + v11 * fx * fy)

    q = corners.to(device=dev, dtype=torch.float32)
    cx, cy = q[:, 0], q[:, 1]
    for _ in range(max_iter):
        ys = cy[:, None, None] + gy_off                  # (N, n, n)
        xs = cx[:, None, None] + gx_off
        s = bilinear(ys + dys, xs + dxs)                 # (4, N, n, n)
        gx = (s[0] - s[1]) * 0.5
        gy = (s[2] - s[3]) * 0.5
        a, b, c, bx, by = _window_sums(torch.stack([
            weight * gx * gx, weight * gx * gy, weight * gy * gy,
            weight * (gx * gx * xs + gx * gy * ys), weight * (gx * gy * xs + gy * gy * ys)]))
        det = a * c - b * b
        ok = det.abs() > 1e-12
        safe = torch.where(ok, det, torch.ones_like(det))
        nx = torch.where(ok, (c * bx - b * by) / safe, cx)
        ny = torch.where(ok, (a * by - b * bx) / safe, cy)
        nx = torch.minimum(torch.maximum(nx, cx - 2.0), cx + 2.0)
        ny = torch.minimum(torch.maximum(ny, cy - 2.0), cy + 2.0)
        cx, cy = nx, ny
    return torch.stack([cx, cy], dim=-1)


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


def _grow_grid(cands: np.ndarray, scores: np.ndarray, cols: int, rows: int):
    """Assemble a cols x rows corner lattice from candidates (host, numpy;
    a copy of the reference's).

    Strategy: seed at the strongest central candidate, estimate the two
    lattice vectors from its nearest neighbors, then repeatedly predict
    missing grid positions by local linear extrapolation and snap to the
    nearest unused candidate. Returns (cols*rows, 2) ordered row-major, or
    None if the full grid can't be assembled."""
    n = (scores > 0).sum()
    cands = cands[:n]
    scores = scores[:n]
    if n < cols * rows:
        return None
    # Weak saddles also fire between squares (diagonal crossings); true
    # corners form a clear score plateau. Keep candidates within a relative
    # band of the expected-corner median score.
    thresh = 0.3 * np.median(scores[: cols * rows])
    keep = scores >= thresh
    cands = cands[keep]
    scores = scores[keep]
    n = len(cands)
    if n < cols * rows:
        return None
    # Seed: strongest candidate near the centroid of all candidates.
    center = cands.mean(axis=0)
    d2c = np.linalg.norm(cands - center, axis=1)
    seed = int(np.argmin(d2c - 1e-3 * scores))
    # Lattice vectors: the two shortest, non-collinear neighbor offsets.
    d = cands - cands[seed]
    dist = np.linalg.norm(d, axis=1)
    order = np.argsort(dist)
    v1 = None
    v2 = None
    for i in order[1:]:
        if dist[i] < 1e-3:
            continue
        if v1 is None:
            v1 = d[i]
            continue
        cosang = abs(np.dot(v1, d[i])) / (np.linalg.norm(v1) * dist[i])
        if cosang < 0.7 and dist[i] < 2.5 * np.linalg.norm(v1):
            v2 = d[i]
            break
    if v1 is None or v2 is None:
        return None

    # Integer coordinates by greedy BFS growth with local prediction.
    coords = {seed: (0, 0)}  # candidate index -> lattice coordinate
    occupied = {(0, 0): seed}
    frontier = [(0, 0)]
    basis = {(0, 0): (v1.copy(), v2.copy())}
    snap_tol = 0.35 * min(np.linalg.norm(v1), np.linalg.norm(v2))
    used = np.zeros(n, bool)
    used[seed] = True

    def neighbors(ij):
        i, j = ij
        return [(i + 1, j), (i - 1, j), (i, j + 1), (i, j - 1)]

    while frontier:
        cur = frontier.pop(0)
        ci = occupied[cur]
        b1, b2 = basis[cur]
        for nb in neighbors(cur):
            if nb in occupied:
                continue
            di, dj = nb[0] - cur[0], nb[1] - cur[1]
            pred = cands[ci] + di * b1 + dj * b2
            d2 = np.linalg.norm(cands - pred, axis=1)
            d2[used] = np.inf
            j = int(np.argmin(d2))
            if d2[j] > snap_tol:
                continue
            occupied[nb] = j
            coords[j] = nb
            used[j] = True
            # Update local basis from the actual step taken.
            step = cands[j] - cands[ci]
            nb1, nb2 = b1.copy(), b2.copy()
            if di:
                nb1 = step / di
            else:
                nb2 = step / dj
            basis[nb] = (nb1, nb2)
            frontier.append(nb)

    if len(occupied) < cols * rows:
        return None
    ij = np.array(list(occupied.keys()))
    imin, jmin = ij.min(axis=0)
    imax, jmax = ij.max(axis=0)
    span_i = imax - imin + 1
    span_j = jmax - jmin + 1
    # Find a full cols x rows (or rows x cols) sub-window.
    for (ci_, cj_), transpose in (((cols, rows), False), ((rows, cols), True)):
        for i0 in range(imin, imax - ci_ + 2):
            for j0 in range(jmin, jmax - cj_ + 2):
                want = [(i0 + a, j0 + b) for b in range(cj_) for a in range(ci_)]
                if all(w in occupied for w in want):
                    pts = np.array([cands[occupied[w]] for w in want])
                    grid = pts.reshape(cj_, ci_, 2)
                    if transpose:
                        grid = grid.transpose(1, 0, 2)
                        grid = grid.reshape(rows, cols, 2)
                    else:
                        grid = grid.reshape(rows, cols, 2)
                    return _canonical_order(grid)
    return None


def _canonical_order(grid: np.ndarray) -> np.ndarray:
    """Orient a (rows, cols, 2) grid canonically: first row is the top edge
    (smaller mean y), first column the left edge (smaller mean x). Matches
    the deterministic ordering calibrate_camera pairs with object points."""
    if grid[0, :, 1].mean() > grid[-1, :, 1].mean():
        grid = grid[::-1]
    if grid[:, 0, 0].mean() > grid[:, -1, 0].mean():
        grid = grid[:, ::-1]
    return grid.reshape(-1, 2)


def _detect_grid(img: torch.Tensor, s: int, cols: int, rows: int, num_candidates: int):
    """Response and NMS on the image box-averaged by s, then the lattice on
    the host from one copy of the candidates: (rows * cols, 2) at scale s,
    or None."""
    H, W = img.shape
    small = (img[: H - H % s, : W - W % s].to(torch.float32)
             .reshape(H // s, s, W // s, s).mean((1, 3)))
    cands, scores = nms_candidates(saddle_response(small, sigma=2.0), num=num_candidates, radius=4)
    both = torch.cat([cands, scores[:, None]], dim=1).cpu().numpy()
    return _grow_grid(both[:, :2], both[:, 2], cols, rows)


def find_chessboard_corners(img, cols: int = 9, rows: int = 7, num_candidates: int = 256,
                            detect_scale: int = 4,
                            subpix_win: int = 11) -> Tuple[bool, Optional[torch.Tensor]]:
    """Find the cols x rows inner corners of a chessboard in an (H, W) or
    (H, W, 3) image (a tensor, or a numpy array taken to the CPU): the
    response and NMS at 1 / detect_scale, the lattice on the host (a retry at
    scale 2 when detect_scale > 2 finds none), and the refinement at full
    resolution. RGB becomes luma rounded half to even, computed in float64.

    Returns (found, corners): (cols * rows, 2) float32 on the image's
    device, row-major with x fastest, or (False, None)."""
    img = torch.as_tensor(img)
    if img.dim() == 3:
        rgb = img.to(torch.float64)
        img = torch.round(0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2])
    s = detect_scale
    grid = _detect_grid(img, s, cols, rows, num_candidates)
    if grid is None and s > 2:
        # small boards in large images
        s = 2
        grid = _detect_grid(img, s, cols, rows, num_candidates)
    if grid is None:
        return False, None
    full = torch.from_numpy(np.asarray(grid * s + (s - 1) / 2.0, dtype=np.float32))
    return True, corner_subpix(img, full.to(img.device), win=subpix_win)
