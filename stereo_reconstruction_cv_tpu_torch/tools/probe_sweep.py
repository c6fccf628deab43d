"""Probe: the fused sweep + WTA and the speckle labels at configs 2 and 3.

    python -m stereo_reconstruction_cv_tpu_torch.tools.probe_sweep

Builds the kernels of the checkout it is run from, so a scratch copy of the
package with an edited ``csrc/`` times its own variant of a kernel beside
the tree's (run each from its own root, in turns, on one card). For
config 2 (1280x720 x 128, 8 paths) and config 3 (3840x2160 x 256, 5 paths)
it makes the cost volume of a synthetic textured pair with a known shift
and prints one JSON object with, per config:

- for each of ``ops/cuda/sgm.py:FUSED_CANDIDATES``: ``sgm_sweep_wta``'s time
  with that direction last (CUDA events, median of 5), its path sweeps'
  (median of 3), and whether its maps equal the first candidate's;
- the speckle labels of the config's own map (LR-checked, the left margin
  sliced off, as the main path hands it over): each of the three launches'
  device time (``torch.profiler``), their total by CUDA-graph replay, and
  whether the labels equal the plain flood's fixpoint;
- the keep-mask kernels by CUDA-graph replay, each against its plain
  version: ``lr_check`` on the fused sweep's maps, and ``speckle_keep`` on
  the config's own map, a speckled map of the same shape (random
  disparities x60 joined within 5, 40% invalid: components of a few pixels)
  and a map of single-pixel components; each wrapper's time over 20
  back-to-back eager calls as well (its host work included);
- ``sgbm_disparity`` as the config runs it (LR check, device speckle): the
  median and the least of 30 warm runs, synchronised wall clock, and the
  median time the host takes to return from the call (its issue time).

Needs a CUDA device (exit 2 without one).
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops.cuda import cost as CK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import lr as LK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import sgm as SK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import speckle as SPK
from stereo_reconstruction_cv_tpu_torch.utils.timing import (
    card,
    cuda_ms,
    graph_ms,
    kernel_ms,
    launch_ms,
)

CONFIGS = (("config 2", 720, 1280, 128, 8), ("config 3", 2160, 3840, 256, 5))
SHIFT = 40


def textured_pair(rng, H: int, W: int, shift: int):
    """uint8 (H, W) pair with left[y, x] == right[y, x - shift] (3x3-smoothed noise)."""
    n = rng.uniform(0, 255, size=(H + 2, W + shift + 2)).astype(np.float32)
    base = sum(n[i:i + H, j:j + W + shift] for i in range(3) for j in range(3)) / 9.0
    base = np.clip((base - base.mean()) * 3.0 + 128.0, 0, 255).astype(np.uint8)
    return base[:, :W].copy(), base[:, shift:].copy()


def probe(H: int, W: int, D: int, nd: int, dev) -> dict:
    cfg = DP.SGBMConfig(num_disparities=D, num_directions=nd)
    p1, p2, ur = cfg.p1, cfg.p2, cfg.uniqueness_ratio
    left, right = (torch.from_numpy(a).to(dev)
                   for a in textured_pair(np.random.default_rng(0), H, W, SHIFT))
    C = CK.cost_volume(*DP.cost_planes(left, right, cfg.pre_filter_cap), D, 0, cfg.block_size)
    out, first = {}, None
    for fd in SK.FUSED_CANDIDATES:
        vols = SK.path_deltas_cuda(C, nd, p1, p2, fused=fd)
        maps = SK.sweep_wta_cuda(C, vols, nd, p1, p2, ur, 0, fd)
        first = first or maps
        out[f"fused {fd[0]},{fd[1]}"] = {
            "sweep_wta_ms": cuda_ms(lambda: SK.sweep_wta_cuda(C, vols, nd, p1, p2, ur, 0, fd), 5),
            "sweeps_ms": cuda_ms(lambda: SK.path_deltas_cuda(C, nd, p1, p2, fused=fd), 3),
            "equal": all(torch.equal(a, b) for a, b in zip(maps, first)),
        }
        del vols
    del C
    disp, _, best, minS = first
    md, T = cfg.disp12_max_diff, cfg.speckle_window_size
    out["lr_check"] = {
        "equal": torch.equal(LK.lr_check_maps(best, minS, disp, D, 0, md),
                             LK.lr_check_maps_plain(best, minS, disp, D, 0, md)),
        "ms": graph_ms(lambda: LK.lr_check_maps(best, minS, disp, D, 0, md), 10),
    }
    d, v = DP.sgbm_disparity(left, right, cfg.with_(speckle_window_size=0))
    d, v = d[:, D:], v[:, D:]
    diff = float(cfg.speckle_range)
    ref, converged = SPK.speckle_labels_plain(d, v, diff)
    out["speckle_labels"] = {
        "equal": bool(converged) and torch.equal(SPK.speckle_labels_cuda(d, v, diff), ref),
        "ms": graph_ms(lambda: SPK.speckle_labels_cuda(d, v, diff), 10),
        **kernel_ms(lambda: SPK.speckle_labels_cuda(d, v, diff)),
    }
    rng = np.random.default_rng(1)
    h, w = v.shape
    sv = torch.from_numpy(rng.random((h, w)) >= 0.4).to(dev)
    sd = torch.from_numpy((rng.random((h, w)) * 60).astype(np.float32)).to(dev)
    speckled = (SPK.speckle_labels_cuda(sd, sv, 5.0), sv)
    singletons = (torch.arange(h * w, dtype=torch.int32, device=dev).view(h, w),
                  torch.ones((h, w), dtype=torch.bool, device=dev))
    out["speckle_keep"] = {}
    for name, (lab, val) in (("frame", (ref, v)), ("speckled", speckled),
                             ("singletons", singletons)):
        out["speckle_keep"][name] = {
            "equal": torch.equal(SPK.speckle_keep_cuda(lab, val, T),
                                 SPK.speckle_keep_plain(lab, val, T)),
            "ms": graph_ms(lambda: SPK.speckle_keep_cuda(lab, val, T), 10),
        }
    out["lr_check"]["eager_ms"] = launch_ms(
        lambda: LK.lr_check_maps(best, minS, disp, D, 0, md), 20)
    out["speckle_keep"]["frame"]["eager_ms"] = launch_ms(
        lambda: SPK.speckle_keep_cuda(ref, v, T), 20)
    walls, issue = [], []
    for _ in range(31):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        DP.sgbm_disparity(left, right, cfg)
        issue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["sgbm_disparity"] = {"s_per_pair": statistics.median(walls[1:]), "min": min(walls[1:]),
                             "issue_s": statistics.median(issue[1:])}
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_sweep needs a CUDA device")
        return 2
    dev = torch.device("cuda")
    result = {"card": card()}
    for label, H, W, D, nd in CONFIGS:
        result[label] = probe(H, W, D, nd, dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
