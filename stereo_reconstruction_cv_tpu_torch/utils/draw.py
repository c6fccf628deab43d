"""Display rasterisers on the host (numpy; no OpenCV).

A copy of ``stereo_reconstruction_cv_tpu/utils/draw.py``: the epiline,
keypoint and match overlays that the rectify and match stages draw, and the
jet colormap of a disparity map.
"""

from __future__ import annotations

import numpy as np


def _to_rgb(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        return np.stack([img] * 3, axis=-1).astype(np.uint8)
    return img.astype(np.uint8).copy()


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 2) -> None:
    """In-place anti-alias-free line (dense sampling; fine for overlays)."""
    H, W = img.shape[:2]
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    t = np.linspace(0.0, 1.0, n)
    xs = np.round(x0 + (x1 - x0) * t).astype(int)
    ys = np.round(y0 + (y1 - y0) * t).astype(int)
    r = thickness // 2
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            xi = np.clip(xs + dx, 0, W - 1)
            yi = np.clip(ys + dy, 0, H - 1)
            keep = (xs + dx >= 0) & (xs + dx < W) & (ys + dy >= 0) & (ys + dy < H)
            img[yi[keep], xi[keep]] = color


def draw_circle(img: np.ndarray, center, radius: int, color, thickness: int = 2) -> None:
    H, W = img.shape[:2]
    cx, cy = float(center[0]), float(center[1])
    n = max(int(2 * np.pi * radius) * 2, 16)
    t = np.linspace(0, 2 * np.pi, n)
    for rr in range(max(radius - thickness // 2, 1), radius + thickness // 2 + 1):
        xs = np.round(cx + rr * np.cos(t)).astype(int)
        ys = np.round(cy + rr * np.sin(t)).astype(int)
        keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        img[ys[keep], xs[keep]] = color


def draw_epilines(img1, img2, lines, pts1, pts2, seed: int = 0):
    """Reference draw_epilines parity (gui.py:78-89): for each epiline
    a x + b y + c = 0 in img1, draw it border-to-border with a random color,
    plus matching colored circles on both images."""
    im1 = _to_rgb(img1)
    im2 = _to_rgb(img2)
    W = im1.shape[1]
    rng = np.random.default_rng(seed)
    for l, p1, p2 in zip(np.asarray(lines), np.asarray(pts1), np.asarray(pts2)):
        color = tuple(int(c) for c in rng.integers(0, 255, 3))
        a, b, c = float(l[0]), float(l[1]), float(l[2])
        if abs(b) < 1e-12:
            continue
        x0, y0 = 0, int(-c / b)
        x1, y1 = W, int(-(c + a * W) / b)
        draw_line(im1, (x0, y0), (x1, y1), color, 2)
        draw_circle(im1, p1, 8, color, 3)
        draw_circle(im2, p2, 8, color, 3)
    return im1, im2


def draw_keypoints(img, kpts, scores=None, color=(0, 255, 0)) -> np.ndarray:
    """DRAW_RICH_KEYPOINTS-style circles (radius from score rank)."""
    out = _to_rgb(img)
    kpts = np.asarray(kpts)
    for i, kp in enumerate(kpts):
        draw_circle(out, kp, 6, color, 2)
    return out


def draw_matches(img1, kpts1, img2, kpts2, pairs, max_draw: int = 200) -> np.ndarray:
    """Side-by-side match visualization (cv2.drawMatches analog)."""
    im1 = _to_rgb(img1)
    im2 = _to_rgb(img2)
    H = max(im1.shape[0], im2.shape[0])
    canvas = np.zeros((H, im1.shape[1] + im2.shape[1], 3), np.uint8)
    canvas[: im1.shape[0], : im1.shape[1]] = im1
    canvas[: im2.shape[0], im1.shape[1] :] = im2
    rng = np.random.default_rng(1)
    off = im1.shape[1]
    for i, j in list(pairs)[:max_draw]:
        color = tuple(int(c) for c in rng.integers(0, 255, 3))
        p1 = np.asarray(kpts1[i])
        p2 = np.asarray(kpts2[j]) + np.array([off, 0])
        draw_line(canvas, p1, p2, color, 1)
        draw_circle(canvas, p1, 5, color, 2)
        draw_circle(canvas, p2, 5, color, 2)
    return canvas


def resize_nearest(img: np.ndarray, size_wh) -> np.ndarray:
    """Cheap resize for display artifacts (reference resizes to 640x360)."""
    W, H = size_wh
    ys = (np.arange(H) * img.shape[0] / H).astype(int)
    xs = (np.arange(W) * img.shape[1] / W).astype(int)
    return img[ys][:, xs]


def colormap_jet(x: np.ndarray) -> np.ndarray:
    """Jet colormap of a float map -> (H, W, 3) uint8, for disparity display."""
    x = np.asarray(x, np.float32)
    lo, hi = np.nanmin(x), np.nanmax(x)
    v = (x - lo) / (hi - lo + 1e-12)
    r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)
