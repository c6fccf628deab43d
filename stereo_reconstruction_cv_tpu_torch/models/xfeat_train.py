"""XFeat training: the self-supervised training loop of the learned matcher.

A port of ``stereo_reconstruction_cv_tpu/models/xfeat_train.py``. Random
crops are sampled every step from every training image, with photometric
jitter on top of the loss's homographic warps; the learning rate warms up
linearly, then decays on a cosine; gradients are clipped to a global norm
of 1. The image pool is copied to the device once, and every step samples,
augments and optimises there (no per-step host transfer, no host sync
but the logged losses). ``stereo=True`` adds cross-view supervision from
rectified pairs with the dense chain's own disparity (``build_stereo_pool``).

Randomness comes from explicit torch.Generators: the initialisation from a
CPU generator seeded with ``seed`` (the same weights on every device), the
crops, jitter and warps from a generator on the training device.

The reference trains on its calibration boards and pairs d1-d3 by default;
they are not in the repository. The defaults here name the same folders
under ``reference/`` in the working directory; pass folders of *.jpg (or
img1.jpg / img2.jpg pair folders for the stereo pool) instead.
"""

from __future__ import annotations

import glob
import math
import os
import sys
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch import config as C
from stereo_reconstruction_cv_tpu_torch.io.image import load_gray
from stereo_reconstruction_cv_tpu_torch.models import checkpoint as CKPT
from stereo_reconstruction_cv_tpu_torch.models import xfeat as XF

DATA_ROOT = "reference"
DEFAULT_FOLDERS = tuple(os.path.join(DATA_ROOT, d) for d in (
    "calibration_data_logitech_3840x2160", "dataset/d1", "dataset/d2", "dataset/d3"))
DEFAULT_PAIRS = DEFAULT_FOLDERS[1:]
# The reference's rig for the stereo pool: the Logitech 4K intrinsics and a
# 0.14 m baseline.
POOL_K = np.array([[2253.71, 0.0, 1929.69], [0.0, 2244.72, 1057.63], [0.0, 0.0, 1.0]])
POOL_BASELINE = 0.14


def load_training_images(folders: Sequence[str], max_side: int = 1280,
                         max_images: int = 64) -> List[np.ndarray]:
    """Every *.jpg of the folders (sorted within each, at most max_images),
    as float32 grey images box-downscaled by the integer factor that brings
    max(H, W) to <= max_side: a 256-px crop of a 4K frame is mostly flat
    texture."""
    files: List[str] = []
    for d in folders:
        files += sorted(glob.glob(os.path.join(d, "*.jpg")))
    imgs = []
    for f in files[:max_images]:
        g = load_gray(f).astype(np.float32)
        H, W = g.shape
        k = int(np.ceil(max(H, W) / max_side))
        if k > 1:
            g = g[: H - H % k, : W - W % k]
            g = g.reshape(H // k, k, (W - W % k) // k, k).mean((1, 3))
        imgs.append(g)
    return imgs


def _randint(generator, n: int, hi: int) -> torch.Tensor:
    return torch.randint(0, hi, (n,), generator=generator, device=generator.device)


def _crops(arr: torch.Tensor, idx, ys, xs, crop: int) -> torch.Tensor:
    """(n, crop, crop) windows of the (N, H, W) stack at (idx, ys, xs)."""
    r = torch.arange(crop, device=arr.device)
    return arr[idx[:, None, None], (ys[:, None] + r)[:, :, None], (xs[:, None] + r)[:, None, :]]


def _device_batch(pool: torch.Tensor, generator: torch.Generator, batch: int,
                  crop: int) -> torch.Tensor:
    """(batch, crop, crop) random crops of the (N, H, W) pool with a gain in
    [0.7, 1.3], a bias in [-20, 20] and Gaussian noise of std 3, clipped
    to [0, 255], all drawn on the pool's device."""
    N, Hs, Ws = pool.shape
    idx = _randint(generator, batch, N)
    ys = _randint(generator, batch, Hs - crop + 1)
    xs = _randint(generator, batch, Ws - crop + 1)
    crops = _crops(pool, idx, ys, xs, crop)
    gain = XF._uniform(generator, (batch, 1, 1), 0.7, 1.3)
    bias = XF._uniform(generator, (batch, 1, 1), -20.0, 20.0)
    noise = torch.randn(crops.shape, generator=generator, device=generator.device) * 3.0
    return torch.clamp(crops * gain + bias + noise, 0.0, 255.0)


def stereo_labels(left: torch.Tensor, right: torch.Tensor, width: int = 1280, ndisp: int = 64):
    """The stereo pool's entry for one rectified (H, W) uint8 pair: both
    views box-downscaled (float64 means) by the integer factor that brings W
    to <= width, then sgbm_disparity at ndisp disparities and 5 paths on the
    views truncated to uint8 -> (left, right, disparity, valid) float32 on
    the pair's device."""
    rl, rr = left.to(torch.float64), right.to(torch.float64)
    H, W = rl.shape
    k = int(math.ceil(W / width))
    if k > 1:
        def box(x):
            x = x[: H - H % k, : W - W % k]
            return x.reshape(H // k, k, -1, k).sum((1, 3)) / (k * k)
        rl, rr = box(rl), box(rr)
    from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP

    cfg = C.SGBMConfig(num_disparities=ndisp, num_directions=5)
    d, v = DP.sgbm_disparity(torch.clamp(rl, 0, 255).to(torch.uint8),
                             torch.clamp(rr, 0, 255).to(torch.uint8), cfg)
    return rl.to(torch.float32), rr.to(torch.float32), d.to(torch.float32), v.to(torch.float32)


def build_stereo_pool(pairs: Sequence[str] = DEFAULT_PAIRS, width: int = 1280, ndisp: int = 64,
                      cache_dir: str = "checkpoints", device="cuda"):
    """Rectified stereo quadruples for cross-view supervision: each pair
    folder (img1.jpg, img2.jpg) through rectify_pair with the reference's rig
    (POOL_K, POOL_BASELINE), then stereo_labels. Returns stacked (P, Hs, Ws)
    float32 tensors (left, right, disparity, valid) on `device`, cropped to
    the smallest pair, or None when no folder exists. The labels are the
    dense chain's own output: the learned matcher is bootstrapped by the
    classical geometry.

    Cached in {cache_dir}/stereo_pool_{width}_{ndisp}.npz (the reference's
    name); a cache written for other pair folders is rebuilt."""
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages

    dev = stages.resolve_device(device)
    names = np.array([os.path.abspath(p) for p in pairs])
    cache = os.path.join(cache_dir, f"stereo_pool_{width}_{ndisp}.npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            if "pairs" in z.files and np.array_equal(z["pairs"], names):
                return tuple(torch.from_numpy(z[k]).to(dev) for k in ("L", "R", "D", "V"))
    quads = []
    for folder in pairs:
        if not os.path.isdir(folder):
            continue
        res = stages.rectify_pair(folder, baseline=POOL_BASELINE, camera_matrix=POOL_K,
                                  with_visualizations=False, device=dev)
        quads.append(stereo_labels(res["left_rectified"], res["right_rectified"], width, ndisp))
    if not quads:
        return None
    Hs = min(q[0].shape[0] for q in quads)
    Ws = min(q[0].shape[1] for q in quads)
    pool = tuple(torch.stack([q[i][:Hs, :Ws] for q in quads]) for i in range(4))
    os.makedirs(cache_dir, exist_ok=True)
    np.savez_compressed(cache, pairs=names,
                        **{k: t.cpu().numpy() for k, t in zip(("L", "R", "D", "V"), pool)})
    return pool


def _stereo_batch(pool, generator: torch.Generator, batch: int, crop: int):
    """Aligned (left, right, disparity, valid) crops of the pool, sharing
    their origins (so the labels hold in crop coordinates), each side with
    its own gain and bias, the left with Gaussian noise of std 2 after the
    clip."""
    L, R, D, V = pool
    N, Hs, Ws = L.shape
    idx = _randint(generator, batch, N)
    ys = _randint(generator, batch, Hs - crop + 1)
    xs = _randint(generator, batch, Ws - crop + 1)
    cl, cr, cd, cv = (_crops(a, idx, ys, xs, crop) for a in (L, R, D, V))

    def jitter(c):
        gain = XF._uniform(generator, (batch, 1, 1), 0.7, 1.3)
        bias = XF._uniform(generator, (batch, 1, 1), -20.0, 20.0)
        return torch.clamp(c * gain + bias, 0.0, 255.0)

    cl = jitter(cl) + torch.randn(cl.shape, generator=generator, device=generator.device) * 2.0
    return cl, jitter(cr), cd, cv > 0.5


def warmup_cosine(lr: float, warmup: int, steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, steps) as a function
    of the update count: linear from 0 to lr over `warmup` counts, then a
    cosine to 0 at `steps` (which counts the warmup). Where steps <= warmup
    optax refuses the schedule; here every count below `steps` then takes
    the linear part, which is what optax's schedule gives those counts."""
    def schedule(count: int) -> float:
        if count < warmup or steps <= warmup:
            return (0.0 - lr) * (1.0 - min(count, warmup) / warmup) + lr
        t = min(count - warmup, steps - warmup)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t / (steps - warmup)))
    return schedule


def train(folders: Sequence[str] = DEFAULT_FOLDERS, steps: int = 5000, batch: int = 16,
          crop: int = 256, lr: float = 2e-3, warmup: int = 200, seed: int = 0,
          output: str = "checkpoints/xfeat_v1", log_every: int = 100, max_images: int = 64,
          stereo: bool = False, init_from: Optional[str] = None,
          stereo_pairs: Sequence[str] = DEFAULT_PAIRS, cache_dir: str = "checkpoints",
          device="cuda", on_step: Optional[Callable[[int, torch.Tensor], None]] = None):
    """Train and save the weights as an .npz (``checkpoint.save_params``:
    ".npz" is appended to `output` without it); returns the loss history
    [(step, loss)] of the logged steps (every log_every and the last).

    Images smaller than the crop are skipped (FileNotFoundError when none
    is left); the rest are cropped to the smallest one's H x W and copied to
    `device` once. The net starts from init_params (seeded CPU generator)
    or from the .npz init_from. stereo=True adds xfeat_stereo_loss on the
    pool of stereo_pairs (build_stereo_pool, cached in cache_dir) with
    weight 0.5 each. Adam with a global-norm clip of 1.0 on
    warmup_cosine(lr, warmup, steps). on_step(step, loss) is called after
    every step with the loss on the device."""
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages

    dev = stages.resolve_device(device)
    imgs = load_training_images(folders, max_images=max_images)
    imgs = [g for g in imgs if g.shape[0] >= crop and g.shape[1] >= crop]
    if not imgs:
        raise FileNotFoundError(f"no *.jpg of at least {crop}x{crop} under {list(folders)}")
    Hs = min(g.shape[0] for g in imgs)
    Ws = min(g.shape[1] for g in imgs)
    pool = torch.from_numpy(np.stack([g[:Hs, :Ws] for g in imgs])).to(dev)

    model = XF.XFeatNet().to(dev)
    if init_from:
        model.load_state_dict(CKPT.load_params(init_from, dev), strict=True)
    else:
        XF.init_params(model, torch.Generator().manual_seed(seed))
    state = XF.create_train_state(model, warmup_cosine(lr, warmup, steps), max_norm=1.0)
    spool = build_stereo_pool(stereo_pairs, cache_dir=cache_dir, device=dev) if stereo else None
    if stereo and spool is None:
        print(f"no stereo pair folder among {list(stereo_pairs)}; training without the "
              "stereo term", file=sys.stderr)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    history = []
    for it in range(steps):
        data = _device_batch(pool, gen, batch, crop)
        draws = XF.draw_warps(gen, batch)
        sb = _stereo_batch(spool, gen, batch, crop) if spool is not None else None
        loss = XF.train_step(state, data, draws, sb)
        if on_step is not None:
            on_step(it, loss)
        if it % log_every == 0 or it == steps - 1:
            lv = float(loss)
            history.append((it, lv))
            print(f"step {it}: loss {lv:.4f}", flush=True)
    path = CKPT.save_params(output, model)
    print(f"saved checkpoint to {path}")
    return history
