"""DoG scale-space keypoint detection with OpenCV's SIFT semantics.

A port of ``stereo_reconstruction_cv_tpu/ops/sift.py``, in float32 as the
reference: a Gaussian pyramid (sigma0 1.6, 3 layers an octave, the first
octave at 2x when asked), extrema of the differences of Gaussians over their
26 neighbours, one quadratic Newton refinement, cv2's absolute contrast test
on [0, 1] images and its edge test (r = 10), then the top `max_keypoints` by
refined contrast.

Every stage is dense and of static shape. The blurs are sums of the
replicate-padded image's shifted windows (``unfold`` times the taps):
no convolution routine, so no TF32 on a GPU whatever cuDNN's flags say. They
and the 2x upsampling sum in float64 and round once to float32, and a
division by a constant is a product with its reciprocal (a GPU's division
by a scalar is one), so the pyramid, and with it every keypoint, has the
same bits on a GPU and on the CPU. The three layers of an octave are tested at once, their 26 neighbours
read as shifted windows of the circularly padded stack (the reference's
``roll``).
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple

import torch
import torch.nn.functional as F

SIGMA0 = 1.6          # cv2 SIFT base sigma
N_LAYERS = 3          # cv2 nOctaveLayers default
EDGE_R = 10.0         # cv2 edgeThreshold default
INIT_SIGMA = 0.5      # assumed blur of the input image (cv2 SIFT_INIT_SIGMA)
BORDER = 5            # cv2 SIFT_IMG_BORDER


@functools.lru_cache(maxsize=None)
def gauss_taps(sigma: float, radius: int, device) -> torch.Tensor:
    """Normalised float32 Gaussian taps at -radius..radius, computed on the
    CPU for every device (so they are the same bits everywhere), one copy
    a device."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).to(device)


def blur_axis(x: torch.Tensor, taps: torch.Tensor, dim: int) -> torch.Tensor:
    """Correlation of a (H, W) float32 image with `taps` along `dim`, edges
    replicated. Each output is the float64 sum of its window times the taps
    (every product exact), rounded once to float32: the same bits on every
    device and in any summation order, so keypoints and descriptors do not
    move between a GPU and the CPU."""
    r = (taps.numel() - 1) // 2
    size = list(x.shape)
    size[dim] = r
    x64 = x.to(torch.float64)
    first = x64.narrow(dim, 0, 1).expand(size)
    last = x64.narrow(dim, x.shape[dim] - 1, 1).expand(size)
    padded = torch.cat([first, x64, last], dim=dim)
    return (padded.unfold(dim, taps.numel(), 1) * taps.to(torch.float64)).sum(-1).to(x.dtype)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian, radius ceil(3 sigma): rows, then columns."""
    if sigma <= 0:
        return img
    k = gauss_taps(sigma, max(int(math.ceil(3.0 * sigma)), 1), img.device)
    return blur_axis(blur_axis(img, k, 1), k, 0)


def _upsample2(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling, half-pixel centres, edges clamped (weights
    1/4 and 3/4 along each axis), exact in float64 and rounded once."""

    def along(x, dim):
        n = x.shape[dim]
        prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim=dim)
        nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim=dim)
        pair = torch.stack([0.25 * prev + 0.75 * x, 0.75 * x + 0.25 * nxt], dim=dim + 1)
        return pair.flatten(dim, dim + 1)

    return along(along(img.to(torch.float64), 1), 0).to(img.dtype)


def num_octaves(H: int, W: int, first_octave: int = -1) -> int:
    """cv2: round(log2(min side)) - 2 octaves, counted from the base octave."""
    base = min(H, W) * (2 if first_octave < 0 else 1)
    return max(1, int(round(math.log2(max(base, 8)))) - 2)


def gaussian_pyramid(img: torch.Tensor, n_oct: int, first_octave: int = -1) -> List[List[torch.Tensor]]:
    """[octave][layer] Gaussian images, N_LAYERS + 3 a octave: incremental
    blurs from each octave's base; octave o + 1 starts from octave o's layer
    N_LAYERS decimated 2x (cv2 buildGaussianPyramid)."""
    imgf = img if img.dtype == torch.float32 else img.to(torch.float32) * (1.0 / 255.0)
    if first_octave < 0:
        base = _upsample2(imgf)
        sig_diff = math.sqrt(max(SIGMA0 ** 2 - 4.0 * INIT_SIGMA ** 2, 0.01))
    else:
        base = imgf
        sig_diff = math.sqrt(max(SIGMA0 ** 2 - INIT_SIGMA ** 2, 0.01))
    base = _blur(base, sig_diff)
    k = 2.0 ** (1.0 / N_LAYERS)
    incr, sig_prev = [], SIGMA0
    for s in range(1, N_LAYERS + 3):
        sig_total = SIGMA0 * k ** s
        incr.append(math.sqrt(sig_total ** 2 - sig_prev ** 2))
        sig_prev = sig_total
    pyr: List[List[torch.Tensor]] = []
    for o in range(n_oct):
        g = base if o == 0 else pyr[o - 1][N_LAYERS][::2, ::2]
        levels = [g]
        for s in range(N_LAYERS + 2):
            g = _blur(g, incr[s])
            levels.append(g)
        pyr.append(levels)
    return pyr


class OctaveExtrema(NamedTuple):
    score: torch.Tensor   # (N_LAYERS * H * W,) |contrast|, 0 where rejected
    x: torch.Tensor       # refined x in input-image pixels
    y: torch.Tensor       # refined y
    sigma: torch.Tensor   # keypoint scale in input-image pixels


def _octave_extrema(dogs: torch.Tensor, octave: int, first_octave: int,
                    contrast_threshold: float) -> OctaveExtrema:
    """Extremum test and one-Newton-step refinement of layers 1..N_LAYERS of
    one octave's differences of Gaussians (N_LAYERS + 2, H, W), layer-major."""
    _, H, W = dogs.shape
    P = F.pad(dogs[None], (1, 1, 1, 1), mode="circular")[0]   # the reference's roll

    def at(layer, dy, dx):
        """Layers 1..N_LAYERS offset by `layer` - 1, read at (y + dy, x + dx)."""
        return P[layer:layer + N_LAYERS, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    lo, cur, hi = at(0, 0, 0), at(1, 0, 0), at(2, 0, 0)
    neigh = torch.stack([at(layer, dy, dx) for layer in range(3) for dy in (-1, 0, 1)
                         for dx in (-1, 0, 1) if (layer, dy, dx) != (1, 0, 0)])
    prelim = 0.5 * contrast_threshold / N_LAYERS
    is_ext = (((cur > neigh.amax(0)) | (cur < neigh.amin(0))) & (cur.abs() > prelim))
    del neigh
    yy = torch.arange(H, device=dogs.device)[:, None]
    xx = torch.arange(W, device=dogs.device)[None, :]
    is_ext &= (yy >= BORDER) & (yy < H - BORDER) & (xx >= BORDER) & (xx < W - BORDER)

    # Gradient and Hessian of D(x, y, s).
    gx = 0.5 * (at(1, 0, 1) - at(1, 0, -1))
    gy = 0.5 * (at(1, 1, 0) - at(1, -1, 0))
    gs = 0.5 * (hi - lo)
    hxx = at(1, 0, 1) + at(1, 0, -1) - 2 * cur
    hyy = at(1, 1, 0) + at(1, -1, 0) - 2 * cur
    hss = hi + lo - 2 * cur
    hxy = 0.25 * (at(1, 1, 1) - at(1, 1, -1) - at(1, -1, 1) + at(1, -1, -1))
    hxs = 0.25 * (at(2, 0, 1) - at(2, 0, -1) - at(0, 0, 1) + at(0, 0, -1))
    hys = 0.25 * (at(2, 1, 0) - at(2, -1, 0) - at(0, 1, 0) + at(0, -1, 0))
    # H @ off = -g by the adjugate.
    c00 = hyy * hss - hys * hys
    c01 = hxs * hys - hxy * hss
    c02 = hxy * hys - hxs * hyy
    c11 = hxx * hss - hxs * hxs
    c12 = hxy * hxs - hxx * hys
    c22 = hxx * hyy - hxy * hxy
    det = hxx * c00 + hxy * c01 + hxs * c02
    safe = torch.where(det.abs() > 1e-30, det, torch.full_like(det, 1e-30))
    off_x = -(c00 * gx + c01 * gy + c02 * gs) / safe
    off_y = -(c01 * gx + c11 * gy + c12 * gs) / safe
    off_s = -(c02 * gx + c12 * gy + c22 * gs) / safe
    # One step keeps the well-centred extrema only (cv2 walks to the
    # neighbour; the walked-to candidate is an extremum at its own pixel).
    centered = (off_x.abs() < 0.6) & (off_y.abs() < 0.6) & (off_s.abs() < 0.6)
    contr = cur + 0.5 * (gx * off_x + gy * off_y + gs * off_s)
    pass_contrast = contr.abs() * N_LAYERS >= contrast_threshold
    tr = hxx + hyy
    det2 = hxx * hyy - hxy * hxy
    pass_edge = (det2 > 0) & (tr * tr * EDGE_R < (EDGE_R + 1) ** 2 * det2)
    keep = is_ext & centered & pass_contrast & pass_edge

    scale = float(2.0 ** (octave + first_octave))
    layer = torch.arange(1, N_LAYERS + 1, dtype=torch.float32, device=dogs.device)[:, None, None]
    kx = (xx.to(torch.float32) + off_x) * scale
    ky = (yy.to(torch.float32) + off_y) * scale
    # exp2 in float64, rounded once: a GPU's and the CPU's float32 exp2 differ in
    # the last bit.
    ksig = SIGMA0 * torch.exp2((layer + off_s).to(torch.float64) * (1.0 / N_LAYERS)).to(torch.float32) * scale
    return OctaveExtrema(torch.where(keep, contr.abs(), torch.zeros_like(contr)).reshape(-1),
                         kx.reshape(-1), ky.reshape(-1), ksig.reshape(-1))


class ScaleSpaceResult(NamedTuple):
    keypoints: torch.Tensor     # (K, 2) xy input-image pixels
    scores: torch.Tensor        # (K,) |contrast| (0 = invalid slot)
    sigmas: torch.Tensor        # (K,)
    num_detected: torch.Tensor  # () extrema passing every test


def detect_scale_space(img: torch.Tensor, contrast_threshold: float = 0.04,
                       max_keypoints: int = 4096, first_octave: int = -1) -> ScaleSpaceResult:
    """cv2.SIFT-semantics keypoints of an (H, W) uint8 or [0, 1] float32
    image: the top `max_keypoints` by refined contrast (equal scores in
    candidate order, as the reference's top-k), and the count of all
    extrema that pass cv2's contrast and edge tests."""
    H, W = img.shape
    pyr = gaussian_pyramid(img, num_octaves(H, W, first_octave), first_octave)
    per_oct = []
    for o, levels in enumerate(pyr):
        dogs = torch.stack([levels[i + 1] - levels[i] for i in range(N_LAYERS + 2)])
        per_oct.append(_octave_extrema(dogs, o, first_octave, contrast_threshold))
    score, xs, ys, sig = (torch.cat(parts) for parts in zip(*per_oct))
    num = (score > 0).sum().to(torch.int32)
    order = torch.sort(score, descending=True, stable=True)
    top, idx = order.values[:max_keypoints], order.indices[:max_keypoints]
    return ScaleSpaceResult(torch.stack([xs[idx], ys[idx]], dim=-1), top, sig[idx], num)
