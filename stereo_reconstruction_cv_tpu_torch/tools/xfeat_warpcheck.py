"""The learned matcher's synthetic-warp true-match rate.

A port of the reference's ``tools/xfeat_warpcheck.py``. An image is warped by
known random homographies; the detect + match path runs on both (the
geometry stage's detection scale: the image box-downscaled to at most 2048
px, the mutual matches of cosine similarity >= 0.5), and the rate is the
share of matches within 3 px of the true mapping. A healthy detector and
descriptor pair scores above ~0.6.

    python -m stereo_reconstruction_cv_tpu_torch.tools.xfeat_warpcheck [W.npz] [PAIR ...] [--device D]

W.npz defaults to the shipped weights; each PAIR folder's left image
(img1.jpg) is checked, or, with no folder, a rendered 4K view of the
scene of ``utils/synth.py``. The warps are drawn from a CPU generator
seeded with each seed, so they are the same on every device.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch.models import checkpoint as CKPT
from stereo_reconstruction_cv_tpu_torch.models import xfeat as XF
from stereo_reconstruction_cv_tpu_torch.ops import matching as M
from stereo_reconstruction_cv_tpu_torch.pipeline import stages
from stereo_reconstruction_cv_tpu_torch.utils import synth


def rendered_image(H: int = 2160, W: int = 3840, seed: int = synth.SEED, device="cuda") -> torch.Tensor:
    """The left view of the rendered scene, (H, W) uint8, K_4K scaled to W."""
    K = synth.K_4K.copy()
    K[:2] *= W / 3840.0
    return synth.render_pair(K, np.eye(3), np.array(synth.SCENE_T), H, W, seed=seed,
                             device=stages.resolve_device(device))[0]


def warp_true_rate(checkpoint: str, img: torch.Tensor, seeds=(3, 4, 5), max_kpts: int = 2048,
                   device="cuda"):
    """[(true-match rate, mutual matches)] for each seed's homography of
    the (H, W) uint8 image: the share of matches within 3 px of where the
    homography sends the left keypoint (0.0 with no match)."""
    dev = stages.resolve_device(device)
    img = img.to(dev)
    factor = max(1, math.ceil(max(img.shape) / 2048))
    if factor > 1:
        img = stages._downscale(img, factor)
    imgf = img.to(torch.float32)
    H, W = imgf.shape
    rates = []
    for seed in seeds:
        Hm = XF.random_homography(torch.Generator().manual_seed(seed), H, W).to(dev)
        warped = XF.warp_image(imgf, Hm)
        fl = stages._learned_features(imgf.to(torch.uint8), max_kpts, checkpoint)
        fr = stages._learned_features(warped.to(torch.uint8), max_kpts, checkpoint)
        mres = M.match_learned(fl.descriptors, fr.descriptors, fl.mask, fr.mask, min_cossim=0.5)
        p1, p2, mask = M.gather_correspondences(fl.keypoints, fr.keypoints, mres)
        ph = torch.cat([p1.double(), torch.ones_like(p1[:, :1], dtype=torch.float64)], 1) @ Hm.double().T
        err = torch.linalg.vector_norm(ph[:, :2] / ph[:, 2:3] - p2.double(), dim=1)
        n = int(mask.sum())
        rates.append((float((err[mask] < 3).double().mean()) if n else 0.0, n))
    return rates


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint", nargs="?", default=None, help="weights .npz (default: shipped)")
    p.add_argument("pairs", nargs="*", help="pair folders (default: a rendered 4K view)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    ckpt = args.checkpoint or CKPT.default_checkpoint()
    print(f"checkpoint: {ckpt}")
    images = ([(f, stages._load_pair(f, "cpu")[0]) for f in args.pairs] if args.pairs
              else [("rendered", rendered_image(device=args.device))])
    for name, img in images:
        rates = warp_true_rate(ckpt, img, device=args.device)
        print(f"{name}: " + " ".join(f"{r:.1%}(n={n})" for r, n in rates), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
