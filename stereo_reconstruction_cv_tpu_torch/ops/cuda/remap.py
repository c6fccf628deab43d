"""Four-tap bilinear remap: the plain PyTorch version and the CUDA kernel.

``remap_bilinear_plain`` is cv2.remap (INTER_LINEAR, BORDER_CONSTANT = 0) in
torch ops, as ``stereo_reconstruction_cv_tpu/ops/rectify.py`` computes it
with XLA gathers. ``remap_bilinear_cuda`` wraps ``csrc/remap.cu``, one
launch a frame and bit-equal to the plain version; it replaces no TPU
kernel. ``ops/rectify.remap_bilinear`` dispatches between the two on the
image's device.
"""

from __future__ import annotations

import torch

from stereo_reconstruction_cv_tpu_torch import _build

# Image types the kernel takes, with its is_float flag; channel counts of an
# (H, W, C) image (an (H, W) image has one).
DTYPES = {torch.uint8: 0, torch.float32: 1}
CHANNELS = (1, 3)

# Kernel launches by this module's wrapper: read by the tests, chip_smoke.py
# (which resets them) and utils/timing.graph_ms (which adds a graph's replays).
launches = {"remap": 0}


def remap_bilinear_plain(img: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
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


def remap_bilinear_cuda(img: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
    """The kernel: remap_bilinear_plain's result in one launch.

    img: contiguous (H, W) or (H, W, C) uint8 or float32 on a CUDA device,
    C 1 or 3; src_map: contiguous (Ho, Wo, 2) float32 on the same device.
    Raises ValueError on anything else. Non-finite map values are out of
    scope: the kernel gives them no defined result."""
    if img.dtype not in DTYPES:
        raise ValueError(f"remap: image dtype {img.dtype} not in {list(DTYPES)}")
    if img.dim() not in (2, 3) or (img.dim() == 3 and img.shape[2] not in CHANNELS):
        raise ValueError(f"remap: image must be (H, W) or (H, W, C) with C in {CHANNELS}, "
                         f"got {tuple(img.shape)}")
    if src_map.dtype != torch.float32 or src_map.dim() != 3 or src_map.shape[2] != 2:
        raise ValueError(f"remap: map must be (Ho, Wo, 2) float32, got {src_map.dtype} "
                         f"{tuple(src_map.shape)}")
    dev = _build.cuda_device("remap", img, src_map)
    if not (img.is_contiguous() and src_map.is_contiguous()):
        raise ValueError("remap: image and map must be contiguous on CUDA")
    H, W = img.shape[:2]
    Ho, Wo = src_map.shape[:2]
    if max(H, W, Ho, Wo) >= 2**30:
        raise ValueError(f"remap: sides of at most 2**30 - 1 px, got image {(H, W)}, "
                         f"map {(Ho, Wo)}")
    out = torch.empty((Ho, Wo, *img.shape[2:]), dtype=img.dtype, device=dev)
    _build.launch("srcv_remap_bilinear", dev, img.data_ptr(), src_map.data_ptr(), out.data_ptr(),
                  H, W, Ho, Wo, img.shape[2] if img.dim() == 3 else 1, DTYPES[img.dtype],
                  counts=(launches, "remap"))
    return out
