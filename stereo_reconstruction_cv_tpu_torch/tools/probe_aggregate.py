"""Probe: the S-volume entry point ``sgm_aggregate`` at config 2's size.

    PYTHONPATH=ROOT python stereo_reconstruction_cv_tpu_torch/tools/probe_aggregate.py

Run as a file, it probes the ``stereo_reconstruction_cv_tpu_torch`` package
of the checkout at ROOT (``.`` for this one, or another checkout, the
parent commit unpacked with ``git archive`` say), whose kernels are built in
ROOT's ``build/``. So one card times two checkouts' routes with the same
code, in turns.

On the cost volume of config 2's synthetic pair (1280x720, 128
disparities, the default SGBM parameters) it prints one JSON object with,
for 5 and 8 paths: the route's time (CUDA events, median of 5 after a warm
call), the peak device memory of one call (what it allocates at its
peak, plus C, which it reads), the launches of each kernel in one
call, and whether ``wta_maps(S)`` equals ``sgm_wta``'s maps; and the card.
Needs a CUDA device (exit 2 without one).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops.cuda import cost as CK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import sgm as SK
from stereo_reconstruction_cv_tpu_torch.tools.probe_sweep import textured_pair
from stereo_reconstruction_cv_tpu_torch.utils.timing import card, cuda_ms

H, W, D, SHIFT = 720, 1280, 128, 40


def probe(dev) -> dict:
    cfg = DP.SGBMConfig(num_disparities=D)
    p1, p2, ur = cfg.p1, cfg.p2, cfg.uniqueness_ratio
    left, right = (torch.from_numpy(a).to(dev)
                   for a in textured_pair(np.random.default_rng(0), H, W, SHIFT))
    C = CK.cost_volume(*DP.cost_planes(left, right, cfg.pre_filter_cap), D, 0, cfg.block_size)
    out = {"card": card(), "C_GiB": C.nbytes / 2**30, "source": SK.__file__}
    for nd in (5, 8):
        dirs = SK.directions_for(nd)
        maps = SK.sgm_wta(C, p1, p2, nd, ur, 0)
        S = SK.sgm_aggregate(C, p1, p2, dirs)  # warm: the build, the allocator's blocks
        equal = all(torch.equal(a, b) for a, b in zip(SK.wta_maps(S, 0, ur), maps))
        del S, maps
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for k in SK.launches:
            SK.launches[k] = 0
        S = SK.sgm_aggregate(C, p1, p2, dirs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches = {k: v for k, v in SK.launches.items() if v}
        del S
        out[f"{nd} paths"] = {
            "ms": cuda_ms(lambda: SK.sgm_aggregate(C, p1, p2, dirs), 5),
            "peak_GiB_with_C": (peak + C.nbytes) / 2**30,
            "launches": launches, "wta_equal": equal,
        }
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_aggregate needs a CUDA device")
        return 2
    print(json.dumps(probe(torch.device("cuda"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
