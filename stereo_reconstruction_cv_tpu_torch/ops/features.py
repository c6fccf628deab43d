"""Classical feature detection and description with SIFT semantics.

A port of ``stereo_reconstruction_cv_tpu/ops/features.py``: DoG keypoints
(``ops/sift.py``; the multi-scale Harris detector as ``detector="harris"``),
a dominant orientation from a 36-bin histogram, and a 4x4x8 gradient
histogram descriptor (128-d, L2-normalised, clipped at 0.2), all float32
and of static shape.

The histograms are float64 sums of weights times one-hot bins over the
sample axis, not scatter-adds: a GPU's atomic adds land in no fixed order,
and the 36-bin argmax (with it the descriptor) could flip on a near-tie.
The transcendentals go through float64 too, the sampling windows are made on
the CPU, and a division by a constant is a product with its reciprocal, so a
GPU and the CPU describe a keypoint with the same bits but for a rare
last-bit tie.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from stereo_reconstruction_cv_tpu_torch.ops import sift as SIFT


class Features(NamedTuple):
    keypoints: torch.Tensor    # (N, 2) xy
    scores: torch.Tensor       # (N,)
    descriptors: torch.Tensor  # (N, 128)
    mask: torch.Tensor         # (N,) valid


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of (..., H, W) images, radius int(3 sigma): columns,
    then rows."""
    k = SIFT.gauss_taps(sigma, max(int(3.0 * sigma), 1), img.device)
    return SIFT.blur_axis(SIFT.blur_axis(img, k, -2), k, -1)


def _harris(img: torch.Tensor, sigma_i: float = 2.0, k: float = 0.04) -> torch.Tensor:
    """Harris response of (..., H, W) float32 images."""
    dy, dx = torch.gradient(img, dim=(-2, -1))
    sxx = _blur(dx * dx, sigma_i)
    syy = _blur(dy * dy, sigma_i)
    sxy = _blur(dx * dy, sigma_i)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def _topk_nms(resp: torch.Tensor, num: int, radius: int, threshold: float):
    """The `num` strongest local maxima over a (2 radius + 1)^2 window (a
    pixel is one where it is >= every neighbour), as (xy (num, 2), scores)."""
    W = resp.shape[1]
    window_max = F.max_pool2d(resp[None, None], 2 * radius + 1, stride=1, padding=radius)[0, 0]
    is_max = (resp >= window_max) & (resp > threshold)
    flat = torch.where(is_max, resp, torch.full_like(resp, -torch.inf)).reshape(-1)
    order = torch.sort(flat, descending=True, stable=True)
    scores, idx = order.values[:num], order.indices[:num]
    return torch.stack([(idx % W).to(torch.float32), (idx // W).to(torch.float32)], -1), scores


def detect_and_describe(img: torch.Tensor, max_keypoints: int = 2048,
                        contrast_threshold: float = 0.04, num_scales: int = 3,
                        nms_radius: int = 4, detector: str = "dog") -> Features:
    """Keypoints and descriptors of an (H, W) uint8 image.

    detector 'dog': DoG extrema with cv2's absolute contrastThreshold,
    detected from a 2x upsampled first octave up to 800 px on the short
    side and from the image itself above. 'harris': the multi-scale Harris
    detector, contrast_threshold a relative response floor."""
    if detector == "dog":
        H, W = img.shape
        res = SIFT.detect_scale_space(img, contrast_threshold, max_keypoints,
                                      first_octave=-1 if min(H, W) <= 800 else 0)
        return _describe(img.to(torch.float32) * (1.0 / 255.0), res.keypoints, res.scores,
                         torch.clamp(res.sigmas, min=0.8), res.scores > 0)
    if detector != "harris":
        raise ValueError(f"unknown detector {detector!r}")
    imgf = img.to(torch.float32) * (1.0 / 255.0)
    per_scale = max_keypoints // num_scales
    pts, scores, sigmas = [], [], []
    for s in range(num_scales):
        sigma = 1.6 * 2.0 ** s
        resp = _harris(_blur(imgf, sigma), sigma_i=2.0 * sigma)
        # Per-scale normalisation; the threshold is a relative floor.
        resp = resp / (resp.abs().max() + 1e-30)
        p, sc = _topk_nms(resp, per_scale, nms_radius, contrast_threshold * 0.001)
        pts.append(p)
        scores.append(sc)
        sigmas.append(torch.full((per_scale,), sigma, device=img.device))
    kpts, scores, sigmas = torch.cat(pts), torch.cat(scores), torch.cat(sigmas)
    valid = torch.isfinite(scores) & (scores > 0)
    return _describe(imgf, kpts, torch.where(valid, scores, torch.zeros_like(scores)), sigmas, valid)


def _sample(m: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of map m at (ys, xs), clamped to the image."""
    H, W = m.shape
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, H - 2)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    flat = m.reshape(-1)
    i = y0 * W + x0
    return (flat[i] * (1 - fx) * (1 - fy) + flat[i + 1] * fx * (1 - fy)
            + flat[i + W] * (1 - fx) * fy + flat[i + W + 1] * fx * fy)


@functools.lru_cache(maxsize=None)
def _windows(device):
    """The sampling windows, computed on the CPU and copied to `device` once:
    the orientation window's offsets (17, 17) and Gaussian weights (0
    outside radius 8), the descriptor grid's offsets (16, 16) and weights."""
    R, G = 8, 16
    r = torch.arange(-R, R + 1, dtype=torch.float32)
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    circ = (ox ** 2 + oy ** 2) <= R * R
    gweight = torch.exp(-(ox ** 2 + oy ** 2) / (2.0 * (R / 1.5) ** 2)) * circ
    g = torch.arange(G, dtype=torch.float32) - (G - 1) / 2
    gy_off, gx_off = torch.meshgrid(g, g, indexing="ij")
    dweight = torch.exp(-(gx_off ** 2 + gy_off ** 2) / (2.0 * (G / 2) ** 2))
    return tuple(t.to(device) for t in (oy, ox, gweight, gy_off, gx_off, dweight))


def _f32(fn, *args):
    """fn of float32 tensors, evaluated in float64 and rounded once: a GPU's
    and the CPU's float32 sqrt and transcendentals differ in the last bit,
    which moves a sample across a histogram bin now and then."""
    return fn(*(a.to(torch.float64) for a in args)).to(torch.float32)


def _histogram(weights: torch.Tensor, bins: torch.Tensor, n: int) -> torch.Tensor:
    """sum over the last axis of weights x onehot(bins, n): (..., S) ->
    (..., n), in float64 (float32 weights add exactly in any order)."""
    onehot = bins[..., None] == torch.arange(n, device=bins.device)
    return (weights.to(torch.float64)[..., None] * onehot).sum(-2)


def _describe(imgf: torch.Tensor, kpts: torch.Tensor, scores: torch.Tensor,
              sigmas: torch.Tensor, valid: torch.Tensor) -> Features:
    """Dominant orientation and 128-d descriptor of the given keypoints."""
    H, W = imgf.shape
    dev = imgf.device
    gy, gx = torch.gradient(_blur(imgf, 1.0))
    mag = _f32(torch.sqrt, gx * gx + gy * gy)
    ang = _f32(torch.atan2, gy, gx)
    kx, ky = kpts[:, 0, None, None], kpts[:, 1, None, None]
    scale = (sigmas * (1.0 / 1.6))[:, None, None]
    oy, ox, gweight, gy_off, gx_off, dweight = _windows(dev)

    # Dominant orientation: 36 bins over a circular window of radius 8.
    ys, xs = ky + oy * scale, kx + ox * scale
    m = _sample(mag, ys, xs) * gweight
    a = _sample(ang, ys, xs)
    bins = torch.remainder(torch.floor((a + math.pi) * (1.0 / (2 * math.pi)) * 36).to(torch.int64), 36)
    hist = _histogram(m.reshape(m.shape[0], -1), bins.reshape(bins.shape[0], -1), 36)
    hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) * (1.0 / 3.0)
    b = torch.argmax(hist, dim=-1)
    thetas = (b.to(torch.float32) + 0.5) * (1.0 / 36.0) * 2 * math.pi - math.pi

    # Descriptor: a rotated 16x16 grid -> 4x4 cells x 8 orientations. The
    # samples are grouped by cell, so each cell's 8 bins sum its 16 samples.
    c, s = _f32(torch.cos, thetas)[:, None, None], _f32(torch.sin, thetas)[:, None, None]
    ys = ky + (s * gx_off + c * gy_off) * scale
    xs = kx + (c * gx_off - s * gy_off) * scale
    m = _sample(mag, ys, xs) * dweight
    a = _sample(ang, ys, xs) - thetas[:, None, None]
    ob = torch.remainder(torch.floor((a + 3 * math.pi) * (1.0 / (2 * math.pi)) * 8).to(torch.int64), 8)

    def by_cell(t):  # (K, 16, 16) grid -> (K, 16 cells, 16 samples), cell = 4 row + column
        return t.reshape(-1, 4, 4, 4, 4).permute(0, 1, 3, 2, 4).reshape(-1, 16, 16)

    desc = _histogram(by_cell(m), by_cell(ob), 8).reshape(-1, 128).to(torch.float32)
    desc = torch.clamp(desc / (torch.linalg.norm(desc, dim=-1, keepdim=True) + 1e-8), max=0.2)
    desc = desc / (torch.linalg.norm(desc, dim=-1, keepdim=True) + 1e-8)
    # A window that leaves the image samples clamped pixels: mask such
    # keypoints instead.
    margin = 8.0
    inb = ((kpts[:, 0] >= margin) & (kpts[:, 0] < W - margin)
           & (kpts[:, 1] >= margin) & (kpts[:, 1] < H - margin))
    return Features(kpts, scores, desc, valid & inb)
