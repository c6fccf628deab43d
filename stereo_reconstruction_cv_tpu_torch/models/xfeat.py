"""XFeat-style learned detector and descriptor: serving and training.

A port of ``stereo_reconstruction_cv_tpu/models/xfeat.py``: the net,
``heatmap_from_logits``, ``detect``, ``detect_pair``, ``_detect_post``, and
the self-supervised losses, train state and step (below the serving path;
the training loop is ``models/xfeat_train.py``). A keypoint branch (8x8
space-to-depth, three 1x1 convolutions -> 65 logits a cell) and a descriptor
branch (a strided pyramid of 3x3 convolutions with channel LayerNorm to 1/8
resolution, a skip from 1/4) give logits, 64-d descriptors and a reliability
map at 1/8 resolution.

Numerics follow the reference's float32 forward on the geometry path:

- the net runs in float32 with TF32 off inside ``float32_math`` (cuDNN's
  default would run the convolutions in TF32), restoring the caller's flags
  on exit;
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

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from stereo_reconstruction_cv_tpu_torch.calib.chessboard import corner_subpix_patch

CELL = 8  # keypoint cell size (1/8 resolution)


@contextlib.contextmanager
def float32_math():
    """cuDNN convolutions and cuBLAS products in float32 (TF32 off), as the
    reference computes them; the caller's flags are restored on exit. The
    net's forward runs inside it, but autograd runs the backward after the
    forward's context has closed: train_step runs the losses and their
    backward inside it too."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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
        with float32_math():
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


# ---------------------------------------------------------------------------
# Training: flax's initialisation, homographic pairs, the losses, the step
# ---------------------------------------------------------------------------
#
# JAX's threefry streams cannot be reproduced in torch, so every random
# function is split in two: the draws, made from a torch.Generator, and a
# pure function of the draws, which the tests feed the reference's draws.
# The warps are made of elementwise tensor ops (each one rounding, in one
# fixed order) with their transcendentals in float64, and a division by a
# constant is a product with its reciprocal (CUDA divides a tensor by a
# scalar that way, the CPU does not), so a GPU and the CPU warp an image and
# compute its Harris targets to the same bits: torch.linalg calls a
# different library on each, and an input that differs in its last bit can
# flip a Harris target, which moves the loss by a step.

_INV_255 = 1.0 / 255.0
_INV_T = 1.0 / 0.1  # the InfoNCE temperature's reciprocal

# Standard deviation of a unit normal truncated to [-2, 2]: flax's
# lecun_normal divides by it so that the truncated draws have variance
# 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(model: XFeatNet, generator: torch.Generator) -> XFeatNet:
    """Flax's initialisation of the net, drawn from `generator` (on its
    device, then copied to the model's): every convolution kernel from
    lecun_normal, a normal of std sqrt(1 / fan_in) / 0.8796 truncated to
    +-2 std (fan_in = cin * kh * kw), every bias 0, LayerNorm scale 1 and
    bias 0. Returns the model."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
            w = torch.empty(m.weight.shape, device=generator.device)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, ChannelLayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


class WarpDraws(NamedTuple):
    """The random draws of one xfeat_loss over B images."""
    shift: torch.Tensor  # (B, 4, 2) corner jitter, a fraction of (W, H)
    angle: torch.Tensor  # (B,) rotation, radians
    scale: torch.Tensor  # (B,) isotropic scale
    gain: torch.Tensor   # (B, 1, 1) the warped view's photometric gain
    bias: torch.Tensor   # (B, 1, 1) and bias


def _uniform(generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=generator.device)


def draw_warps(generator: torch.Generator, batch: int, max_shift: float = 0.15,
               max_rot: float = 0.35, scale_range: float = 0.25) -> WarpDraws:
    """xfeat_loss's draws for `batch` images, on the generator's device:
    corner shifts in +-max_shift, angles in +-max_rot, scales in 1 +-
    scale_range, gains in [0.75, 1.3], biases in [-18, 18]."""
    return WarpDraws(_uniform(generator, (batch, 4, 2), -max_shift, max_shift),
                     _uniform(generator, (batch,), -max_rot, max_rot),
                     _uniform(generator, (batch,), 1.0 - scale_range, 1.0 + scale_range),
                     _uniform(generator, (batch, 1, 1), 0.75, 1.3),
                     _uniform(generator, (batch, 1, 1), -18.0, 18.0))


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x of A x = b for (..., n, n) systems: Gaussian elimination with
    partial pivoting (the first largest pivot), in elementwise ops."""
    n = A.shape[-1]
    M = torch.cat([A, b[..., None]], dim=-1)
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        p = M[..., k:, k].abs().argmax(dim=-1, keepdim=True) + k
        perm = torch.where(rows == k, p, torch.where(rows == p, k, rows))
        M = M.gather(-2, perm[..., None].expand(M.shape))
        f = M[..., k + 1:, k] / M[..., k, None, k]
        M = torch.cat([M[..., :k + 1, :], M[..., k + 1:, :] - f[..., None] * M[..., k, None, :]], -2)
    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = M[..., i, n]
        for j in range(i + 1, n):
            acc = acc - M[..., i, j] * x[j]
        x[i] = acc / M[..., i, i]
    return torch.stack(x, dim=-1)


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Inverses of (..., 3, 3) matrices: the adjugate over the determinant,
    in elementwise ops."""
    a, b, c, d, e, f, g, h, i = m.flatten(-2).unbind(-1)
    co = [e * i - f * h, c * h - b * i, b * f - c * e,
          f * g - d * i, a * i - c * g, c * d - a * f,
          d * h - e * g, b * g - a * h, a * e - b * d]
    det = a * co[0] + b * co[3] + c * co[6]
    return torch.stack([x / det for x in co], dim=-1).unflatten(-1, (3, 3))


def homography_from_draws(shift: torch.Tensor, angle: torch.Tensor, scale: torch.Tensor,
                          H: int, W: int) -> torch.Tensor:
    """Homographies mapping image A coordinates to image B's, (..., 3, 3)
    float32, from shift (..., 4, 2), angle (...) and scale (...): the image
    corners jittered by shift * (W, H), rotated by angle and scaled about
    the image centre, then the 4-point homography with h33 = 1 by an 8x8
    solve in float32 (elementwise; see above)."""
    f32 = dict(dtype=torch.float32, device=shift.device)
    corners = torch.tensor([[0.0, 0.0], [W, 0.0], [0.0, H], [W, H]], **f32)
    target = corners + shift.to(torch.float32) * torch.tensor([W, H], **f32)
    angle64 = angle.to(torch.float64)
    scale = scale.to(torch.float32)
    ca = (torch.cos(angle64).to(torch.float32) * scale)[..., None]
    sa = (torch.sin(angle64).to(torch.float32) * scale)[..., None]
    ctr = torch.tensor([W / 2.0, H / 2.0], **f32)
    rel = target - ctr
    target = ctr + torch.stack([ca * rel[..., 0] - sa * rel[..., 1],
                                sa * rel[..., 0] + ca * rel[..., 1]], -1)
    x, y = corners[:, 0].expand_as(target[..., 0]), corners[:, 1].expand_as(target[..., 0])
    u, v = target[..., 0], target[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    # rows 2i and 2i + 1 of the system for corner i
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    A = torch.stack([r1, r2], -2).flatten(-3, -2)
    b = torch.stack([u, v], -1).flatten(-2)
    h = _solve(A, b)
    return torch.cat([h, torch.ones_like(h[..., :1])], -1).unflatten(-1, (3, 3))


def random_homography(generator: torch.Generator, H: int, W: int, max_shift: float = 0.15,
                      max_rot: float = 0.35, scale_range: float = 0.25) -> torch.Tensor:
    """One random perspective warp (3, 3), A -> B, on the generator's
    device: rotation (+- max_rot rad), isotropic scale (1 +- scale_range)
    and per-corner jitter (+- max_shift of the size)."""
    d = draw_warps(generator, 1, max_shift, max_rot, scale_range)
    return homography_from_draws(d.shift[0], d.angle[0], d.scale[0], H, W)


def _project(Hm: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """(x', y') of the points (x, y) (two broadcastable 2-d grids) under
    (B, 3, 3) homographies: (B, ...) each, by a precise division."""
    h = Hm[..., None, None]
    den = h[:, 2, 0] * x + h[:, 2, 1] * y + h[:, 2, 2]
    return ((h[:, 0, 0] * x + h[:, 0, 1] * y + h[:, 0, 2]) / den,
            (h[:, 1, 0] * x + h[:, 1, 1] * y + h[:, 1, 2]) / den)


def warp_image(img: torch.Tensor, Hm: torch.Tensor) -> torch.Tensor:
    """Inverse warp of (H, W) or (B, H, W) float images by homographies
    (3, 3) or (B, 3, 3): bilinear, zero outside the source image."""
    single = img.dim() == 2
    if single:
        img, Hm = img[None], Hm[None]
    B, H, W = img.shape
    yy = torch.arange(H, dtype=torch.float32, device=img.device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=img.device)[None, :]
    sx, sy = _project(_inv3(Hm.to(torch.float32)), xx, yy)
    x0 = torch.floor(sx).to(torch.int64)
    y0 = torch.floor(sy).to(torch.int64)
    fx = sx - x0
    fy = sy - y0
    flat = img.reshape(B, H * W)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
        v = flat.gather(1, idx.reshape(B, -1)).reshape(B, H, W)
        return torch.where(inb, v, torch.zeros_like(v))

    out = (tap(x0, y0) * (1 - fx) * (1 - fy) + tap(x0 + 1, y0) * fx * (1 - fy)
           + tap(x0, y0 + 1) * (1 - fx) * fy + tap(x0 + 1, y0 + 1) * fx * fy)
    return out[0] if single else out


def _cell_centers(Hc: int, Wc: int, device) -> torch.Tensor:
    """(Hc, Wc, 2) xy centres of the 8-px cells."""
    ys = (torch.arange(Hc, dtype=torch.float32, device=device) + 0.5) * CELL
    xs = (torch.arange(Wc, dtype=torch.float32, device=device) + 0.5) * CELL
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _cell_keypointness(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits, dim=-1)[..., :-1].sum(-1)


def _cells_loss(da, db, la, lb, ra, pb, valid_in, bank: bool = False) -> torch.Tensor:
    """Cell-correspondence loss of B image pairs A/B, (B,): for every A
    cell centre, its position pb (B, Hc, Wc, 2) in image B and a validity
    mask valid_in (B, Hc, Wc). InfoNCE of each A cell's descriptor against
    its B cell among the negatives (bank: every B cell of the batch, the
    reference's cross-batch bank; else the image's own B cells), heatmap
    consistency between the views, and the reliability regressed onto
    whether the A cell's best match is its B cell (a target without
    gradient). da, db (B, Hc, Wc, D); la, lb (B, Hc, Wc, 65); ra (B, Hc, Wc)."""
    B, Hc, Wc, D = da.shape
    N = Hc * Wc
    cb = torch.round(pb / CELL - 0.5).to(torch.int64)
    valid = (valid_in & (cb[..., 0] >= 0) & (cb[..., 0] < Wc)
             & (cb[..., 1] >= 0) & (cb[..., 1] < Hc)).reshape(B, N)
    idx = (torch.clamp(cb[..., 1], 0, Hc - 1) * Wc + torch.clamp(cb[..., 0], 0, Wc - 1)).reshape(B, N)
    a = da.reshape(B, N, D)
    dbf = db.reshape(B, N, D)
    pos = dbf.gather(1, idx[..., None].expand(B, N, D))
    if bank:
        logits = (a.reshape(B * N, D) @ dbf.reshape(B * N, D).T).reshape(B, N, B * N) * _INV_T
        pos_idx = idx + N * torch.arange(B, device=idx.device)[:, None]
    else:
        logits = torch.bmm(a, dbf.transpose(1, 2)) * _INV_T
        pos_idx = idx
    pos_sim = (a * pos).sum(-1) * _INV_T
    validf = valid.to(a.dtype)
    n_valid = validf.sum(-1) + 1e-6
    nce = (torch.logsumexp(logits, dim=-1) - pos_sim) * validf
    desc_loss = nce.sum(-1) / n_valid
    pa = _cell_keypointness(la).reshape(B, N)
    pb_at_a = _cell_keypointness(lb).reshape(B, N).gather(1, idx)
    kpt_loss = (((pa - pb_at_a) ** 2) * validf).sum(-1) / n_valid
    correct = (torch.argmax(logits.detach(), dim=-1) == pos_idx).to(a.dtype)
    rel_loss = ((ra.reshape(B, N) - correct) ** 2 * validf).mean(-1)
    return desc_loss + kpt_loss + 0.5 * rel_loss


def harris_cell_targets(imgs: torch.Tensor, dustbin_rel: float = 0.02):
    """Per-cell keypoint targets from the Harris response of (B, H, W)
    images in [0, 255]: (targets (B, Hc, Wc) int64 in [0, 64], the in-cell
    position of the response's first maximum, 64 (the dustbin) where the
    cell's maximum is not above dustbin_rel times the image's largest; the
    response (B, H, W)). The consistency term alone is minimised by a
    constant heatmap; the classical corner teacher anchors the peaks."""
    from stereo_reconstruction_cv_tpu_torch.ops.features import _harris

    B, H, W = imgs.shape
    Hc, Wc = H // CELL, W // CELL
    resp = _harris(imgs.to(torch.float32) * _INV_255)
    cells = resp.reshape(B, Hc, CELL, Wc, CELL).permute(0, 1, 3, 2, 4).reshape(B, Hc, Wc, CELL * CELL)
    pos = torch.argmax(cells, dim=-1)
    cmax = cells.amax(dim=-1)
    thr = dustbin_rel * cmax.amax(dim=(1, 2), keepdim=True)
    return torch.where(cmax > thr, pos, torch.full_like(pos, CELL * CELL)), resp


def _kpt_teacher_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the 65-way cell logits against the targets."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def _forward_views(model: XFeatNet, xa: torch.Tensor, xb: torch.Tensor):
    """The net on both views' (B, H, W) images in [0, 1] with one forward."""
    logits, desc, rel = model(torch.cat([xa, xb]))
    B = xa.shape[0]
    return (logits[:B], desc[:B], rel[:B]), (logits[B:], desc[B:], rel[B:])


def xfeat_loss(model: XFeatNet, imgs: torch.Tensor, draws: WarpDraws) -> torch.Tensor:
    """Self-supervised homography loss over (B, H, W) images in [0, 255]:
    each image warped by the homography of its draws, the warped view with
    its own gain and bias; the cells' InfoNCE against the batch's B cells,
    heatmap consistency and reliability, plus the Harris teacher's
    cross-entropy on both views (cells of B whose 8x8 footprint leaves the
    warped image go to the dustbin). On a card, run it and its backward
    inside float32_math, as train_step does."""
    B, H, W = imgs.shape
    imgs = imgs.to(torch.float32)
    Hms = homography_from_draws(draws.shift, draws.angle, draws.scale, H, W)
    warped = torch.clamp(warp_image(imgs, Hms) * draws.gain + draws.bias, 0.0, 255.0)
    cover = warp_image(torch.ones_like(imgs), Hms)
    (la, da, ra), (lb, db, _) = _forward_views(model, imgs * _INV_255, warped * _INV_255)
    Hc, Wc = da.shape[1:3]
    centers = _cell_centers(Hc, Wc, imgs.device)
    pb = torch.stack(_project(Hms, centers[..., 0], centers[..., 1]), dim=-1)
    losses = _cells_loss(da, db, la, lb, ra, pb, torch.ones(pb.shape[:3], dtype=torch.bool,
                                                             device=imgs.device), bank=True)
    ta, _ = harris_cell_targets(imgs)
    tb, _ = harris_cell_targets(warped)
    cov_cells = cover.reshape(B, Hc, CELL, Wc, CELL).amin(dim=(2, 4)) > 0.999
    tb = torch.where(cov_cells, tb, torch.full_like(tb, CELL * CELL))
    kpt_ce = _kpt_teacher_ce(la, ta) + _kpt_teacher_ce(lb, tb)
    return losses.mean() + 0.5 * kpt_ce


def xfeat_stereo_loss(model: XFeatNet, imgsA: torch.Tensor, imgsB: torch.Tensor,
                      disp: torch.Tensor, dvalid: torch.Tensor) -> torch.Tensor:
    """Cross-view loss on rectified stereo crops (B, H, W each, sharing
    their origins) with dense disparity as the correspondence: left cell
    centre (u, v) matches right (u - d, v), where the disparity map is
    valid at the centre's pixel. The negatives are each pair's own right
    cells; the Harris teacher runs on both real views. On a card, run it
    and its backward inside float32_math, as train_step does."""
    (la, da, ra), (lb, db, _) = _forward_views(model, imgsA.to(torch.float32) * _INV_255,
                                               imgsB.to(torch.float32) * _INV_255)
    Hc, Wc = da.shape[1:3]
    centers = _cell_centers(Hc, Wc, da.device)
    cyi, cxi = centers[..., 1].to(torch.int64), centers[..., 0].to(torch.int64)
    d_at = disp[:, cyi, cxi]
    v_at = dvalid[:, cyi, cxi]
    pb = torch.stack([centers[..., 0] - d_at, centers[..., 1].expand_as(d_at)], dim=-1)
    losses = _cells_loss(da, db, la, lb, ra, pb, v_at)
    ta, _ = harris_cell_targets(imgsA)
    tb, _ = harris_cell_targets(imgsB)
    kpt_ce = _kpt_teacher_ce(la, ta) + _kpt_teacher_ce(lb, tb)
    return losses.mean() + 0.5 * kpt_ce


@dataclass
class TrainState:
    """The net, its Adam, the learning rate (a constant, or a schedule of
    the update count read before each update), the global-norm clip (None:
    no clip) and the count of updates made."""
    model: XFeatNet
    optimizer: torch.optim.Adam
    lr: Union[float, Callable[[int], float]]
    max_norm: Optional[float] = None
    step: int = 0


def create_train_state(model: XFeatNet, lr: Union[float, Callable[[int], float]] = 1e-3,
                       max_norm: Optional[float] = None) -> TrainState:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root, as optax's
    adam) over the model's parameters; max_norm clips the gradients first,
    as optax.clip_by_global_norm."""
    return TrainState(model, torch.optim.Adam(model.parameters(), lr=0.0), lr, max_norm)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the gradients of `params`, in place:
    each scaled to (g / norm) * max_norm when the global norm is >= max_norm
    (no epsilon; not clip_grad_norm_'s rule), left as they are below it.
    No host sync. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def apply_gradients(state: TrainState) -> None:
    """One update from the gradients held in the parameters: the clip, the
    learning rate at the count before the update (a schedule's step 0 is
    its first value), Adam's step."""
    params = list(state.model.parameters())
    if state.max_norm is not None:
        clip_by_global_norm_(params, state.max_norm)
    lr = state.lr(state.step) if callable(state.lr) else state.lr
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1


def train_step(state: TrainState, imgs: torch.Tensor, draws: WarpDraws,
               stereo: Optional[tuple] = None) -> torch.Tensor:
    """One optimiser step on xfeat_loss(imgs, draws), or with stereo =
    (left, right, disparity, valid) crops on the mean of it and
    xfeat_stereo_loss. Returns the loss (a detached device scalar; no host
    sync)."""
    state.optimizer.zero_grad(set_to_none=True)
    with float32_math():
        loss = xfeat_loss(state.model, imgs, draws)
        if stereo is not None:
            loss = 0.5 * loss + 0.5 * xfeat_stereo_loss(state.model, *stereo)
        loss.backward()
    apply_gradients(state)
    return loss.detach()
