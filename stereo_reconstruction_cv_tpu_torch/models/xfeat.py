"""XFeat-style learned detector and descriptor: the serving path.

A port of ``stereo_reconstruction_cv_tpu/models/xfeat.py`` (the net,
``heatmap_from_logits``, ``detect``, ``detect_pair``, ``_detect_post``; its
training lives in the reference alone). A keypoint branch (8x8
space-to-depth, three 1x1 convolutions -> 65 logits a cell) and a descriptor
branch (a strided pyramid of 3x3 convolutions with channel LayerNorm to 1/8
resolution, a skip from 1/4) give logits, 64-d descriptors and a reliability
map at 1/8 resolution.

Numerics follow the reference's float32 forward on the geometry path:

- the net runs in float32 with TF32 off inside
  ``torch.backends.cudnn.flags`` (cuDNN's default would run the convolutions
  in TF32), restoring the caller's flags on exit;
- 3x3 convolutions pad as XLA's SAME does (the odd pixel of a stride-2
  convolution at the end), by ``F.pad`` then no padding;
- LayerNorm normalises over the channels with the variance E[x^2] - E[x]^2
  clamped at 0 (flax's fast variance), eps 1e-6;
- the 1/4 -> 1/8 skip resize is bilinear with antialiasing
  (``jax.image.resize``'s default);
- detection keeps static shapes (N = max_keypoints with a mask) and takes its
  top-k by a stable descending sort, so ties go to the lower index as in
  ``jax.lax.top_k``.

Activations are channels_last, so the norm reduces over contiguous memory.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stereo_reconstruction_cv_tpu_torch.calib.chessboard import corner_subpix_patch

CELL = 8  # keypoint cell size (1/8 resolution)


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA's SAME padding of a k x k, stride-s convolution: per axis total =
    max((ceil(n / s) - 1) s + k - n, 0), low = total // 2, high the rest."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ChannelLayerNorm(nn.Module):
    """flax.linen.LayerNorm over the channel axis of an NCHW tensor."""

    def __init__(self, ch: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(1, keepdim=True)
        var = torch.clamp((x * x).mean(1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None, None]
        return (x - mean) * mul + self.bias[:, None, None]


class ConvBlock(nn.Module):
    """3x3 convolution (SAME, no bias) -> channel LayerNorm -> ReLU."""

    def __init__(self, cin: int, ch: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, ch, 3, stride=stride, padding=0, bias=False)
        self.norm = ChannelLayerNorm(ch)
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(self.conv(_same_pad(x, 3, self.stride))))


class XFeatNet(nn.Module):
    """Grayscale (B, H, W) or (B, 1, H, W) in [0, 1], H and W multiples of
    8 -> (logits (B, H/8, W/8, 65), descriptors (B, H/8, W/8, desc_dim),
    reliability (B, H/8, W/8)), in the reference's channels-last layout."""

    def __init__(self, desc_dim: int = 64):
        super().__init__()
        c = CELL * CELL
        self.kpt = nn.ModuleList([nn.Conv2d(c, 64, 1), nn.Conv2d(64, 64, 1),
                                  nn.Conv2d(64, c + 1, 1)])
        self.blocks = nn.ModuleList([
            ConvBlock(1, 8), ConvBlock(8, 24, 2), ConvBlock(24, 24), ConvBlock(24, 48, 2),
            ConvBlock(48, 48), ConvBlock(48, 96, 2), ConvBlock(96, 96), ConvBlock(96, 96)])
        self.skip = nn.Conv2d(48, 96, 1)
        self.desc = nn.Conv2d(96, desc_dim, 1)
        self.rel = nn.Conv2d(96, 1, 1)

    def forward(self, x: torch.Tensor):
        if x.dim() == 3:
            x = x[:, None]
        x = x.to(torch.float32).contiguous(memory_format=torch.channels_last)
        with torch.backends.cudnn.flags(enabled=True, benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=False):
            # keypoint branch: channel dy * 8 + dx of each 8x8 cell
            k = F.relu(self.kpt[0](F.pixel_unshuffle(x, CELL)))
            k = F.relu(self.kpt[1](k))
            logits = self.kpt[2](k)
            # descriptor branch: H, H/2, H/2, H/4 (d2); H/4, H/8, H/8, H/8 (d)
            d2 = x
            for block in self.blocks[:4]:
                d2 = block(d2)
            d = d2
            for block in self.blocks[4:]:
                d = block(d)
            d2 = F.interpolate(d2, size=d.shape[-2:], mode="bilinear", align_corners=False,
                               antialias=True)
            fused = d + self.skip(d2)
            desc = self.desc(fused)
            # rsqrt(sum^2 + eps) as the reference, not F.normalize
            desc = desc * torch.rsqrt((desc * desc).sum(1, keepdim=True) + 1e-12)
            rel = torch.sigmoid(self.rel(fused))[:, 0]
        return logits.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1), rel


class Features(NamedTuple):
    keypoints: torch.Tensor    # (N, 2) xy, full-resolution pixels
    scores: torch.Tensor       # (N,)
    descriptors: torch.Tensor  # (N, D) L2-normalised
    mask: torch.Tensor         # (N,) valid


def heatmap_from_logits(kpt_logits: torch.Tensor) -> torch.Tensor:
    """(B, Hc, Wc, 65) -> (B, H, W) full-resolution keypoint probability
    (softmax over the 65, the dustbin dropped)."""
    prob = torch.softmax(kpt_logits, dim=-1)[..., :-1]
    B, Hc, Wc, _ = prob.shape
    prob = prob.reshape(B, Hc, Wc, CELL, CELL).permute(0, 1, 3, 2, 4)
    return prob.reshape(B, Hc * CELL, Wc * CELL)


def _unit(img: torch.Tensor) -> torch.Tensor:
    return img.to(torch.float32) / 255.0


def detect(model: XFeatNet, img: torch.Tensor, max_keypoints: int = 1024, nms_radius: int = 4,
           image_refine: bool = True) -> Features:
    """Static-shape detection on one (H, W) uint8 or float image (0-255):
    the top-k NMS peaks of the heatmap, descriptors sampled bilinearly from
    the 1/8 grid."""
    logits, desc, rel = model(_unit(img)[None])
    heat = heatmap_from_logits(logits)[0]
    return _detect_post(img, heat, desc[0], rel[0], max_keypoints, nms_radius, image_refine)


def detect_pair(model: XFeatNet, img_left: torch.Tensor, img_right: torch.Tensor,
                max_keypoints: int = 1024, nms_radius: int = 4,
                image_refine: bool = True) -> Tuple[Features, Features]:
    """Detection on a pair of one shape with one B=2 forward and one corner
    refinement of both images' keypoints; the same features as two
    `detect` calls."""
    imgs = torch.stack([img_left, img_right])
    logits, desc, rel = model(_unit(imgs))
    heats = heatmap_from_logits(logits)
    found = [peaks(heats[i], max_keypoints, nms_radius) for i in range(2)]
    kpts = torch.stack([k for _, k in found])
    if image_refine:
        kpts = refine_keypoints(imgs, kpts)
    return tuple(describe(kpts[i], found[i][0], desc[i], rel[i]) for i in range(2))


def _frac(center, lo, hi):
    """Vertex offset of the parabola through (-1, lo), (0, center), (1, hi),
    clipped to half a pixel."""
    denom = lo + hi - 2.0 * center
    off = 0.5 * (lo - hi) / torch.where(denom.abs() > 1e-12, denom, torch.ones_like(denom))
    return torch.clamp(off, -0.5, 0.5)


def _detect_post(img, heat, desc, reliability, max_keypoints: int, nms_radius: int,
                 image_refine: bool) -> Features:
    top, kpts = peaks(heat, max_keypoints, nms_radius)
    if image_refine:
        kpts = refine_keypoints(img, kpts)
    return describe(kpts, top, desc, reliability)


def peaks(heat: torch.Tensor, max_keypoints: int, nms_radius: int = 4):
    """The max_keypoints strongest NMS peaks of an (H, W) heatmap: (scores
    (N,), 0 past the last peak; xy (N, 2) with a quadratic subpixel offset)."""
    H, W = heat.shape
    # NMS by max-pool equality (the pool pads with -inf, as SAME max_pool)
    k = 2 * nms_radius + 1
    pooled = F.max_pool2d(heat[None, None], k, stride=1, padding=nms_radius)[0, 0]
    is_peak = (heat == pooled) & (heat > 0)
    scores = torch.where(is_peak, heat, torch.zeros_like(heat))
    # NMS peaks lie > nms_radius apart, so a t x t tile (t <= nms_radius)
    # holds at most one: the top-k runs over the tile maxima, unless the
    # tiles cannot supply max_keypoints.
    t = min(4, max(1, nms_radius))
    if H % t == 0 and W % t == 0 and (H // t) * (W // t) >= max_keypoints:
        tiles = scores.reshape(H // t, t, W // t, t).permute(0, 2, 1, 3).reshape(H // t, W // t, t * t)
        tmax, targ = tiles.max(dim=-1)  # the first maximum, as jnp.argmax
        order = torch.sort(tmax.reshape(-1), descending=True, stable=True)
        top, tidx = order.values[:max_keypoints], order.indices[:max_keypoints]
        sub = targ.reshape(-1)[tidx]
        yi = (tidx // (W // t)) * t + sub // t
        xi = (tidx % (W // t)) * t + sub % t
    else:
        order = torch.sort(scores.reshape(-1), descending=True, stable=True)
        top, idx = order.values[:max_keypoints], order.indices[:max_keypoints]
        yi, xi = idx // W, idx % W
    # quadratic subpixel offset on the heatmap
    xc = torch.clamp(xi, 1, W - 2)
    yc = torch.clamp(yi, 1, H - 2)
    ox = _frac(heat[yc, xc], heat[yc, xc - 1], heat[yc, xc + 1])
    oy = _frac(heat[yc, xc], heat[yc - 1, xc], heat[yc + 1, xc])
    xs = xi.to(torch.float32) + torch.where(xi == xc, ox, torch.zeros_like(ox))
    ys = yi.to(torch.float32) + torch.where(yi == yc, oy, torch.zeros_like(oy))
    return top, torch.stack([xs, ys], dim=-1)


def refine_keypoints(img: torch.Tensor, kpts: torch.Tensor) -> torch.Tensor:
    """Gradient-weighted corner refinement of heatmap keypoints on the
    image ((H, W) with (N, 2), or (B, H, W) with (B, N, 2)); a keypoint that
    moves more than 1.5 px (an edge, a blob) keeps its place."""
    refined = corner_subpix_patch(img, kpts, win=3, max_iter=5, max_drift=5.0)
    keep = (refined - kpts).abs().amax(dim=-1) <= 1.5
    return torch.where(keep[..., None], refined, kpts)


def describe(kpts: torch.Tensor, top: torch.Tensor, desc: torch.Tensor,
             reliability: torch.Tensor) -> Features:
    """Features of keypoints: descriptors sampled bilinearly from the
    (Hc, Wc, D) grid and renormalised, scores top * reliability of the
    keypoint's cell, valid where top > 0."""
    xs, ys = kpts[:, 0], kpts[:, 1]
    gx = xs / CELL - 0.5
    gy = ys / CELL - 0.5
    Hc, Wc = desc.shape[:2]
    x0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, Wc - 2)
    y0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, Hc - 2)
    fx = torch.clamp(gx - x0, 0.0, 1.0)[:, None]
    fy = torch.clamp(gy - y0, 0.0, 1.0)[:, None]
    v = (desc[y0, x0] * (1 - fx) * (1 - fy) + desc[y0, x0 + 1] * fx * (1 - fy)
         + desc[y0 + 1, x0] * (1 - fx) * fy + desc[y0 + 1, x0 + 1] * fx * fy)
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-8)
    rel = reliability[torch.clamp(ys.to(torch.int64) // CELL, 0, Hc - 1),
                      torch.clamp(xs.to(torch.int64) // CELL, 0, Wc - 1)]
    return Features(kpts, top * rel, v, top > 0)
