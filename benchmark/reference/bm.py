"""Plain block matching in PyTorch: the benchmark's reference for the "bm"
chain (StereoBM's semantics as the port states them, SGBMConfig with
num_directions=0).

The stages of ``reference/sgbm.py`` with no path between the cost and the
WTA: the cost volume C (prefilter, Birchfield-Tomasi on the Sobel and raw
planes, the block_size box), then the WTA over S = C (argmin, first on
ties; the uniqueness test; the parabolic subpixel from C[d -+ 1]), the LR
check (disp12MaxDiff), the left margin padded back as invalid
(min_disparity - 1) and the speckle filter. ``sgbm.sgbm(..., dirs=())`` is
not this: its aggregate returns zeros.

Imports nothing of the program. Runs on the device of its inputs.
"""

from __future__ import annotations

import torch

from benchmark.reference.sgbm import cost_volume, lr_keep, speckle_keep, wta


def bm(left: torch.Tensor, right: torch.Tensor, p: dict, uniqueness: int):
    """(H, W) uint8 pair -> (disp f32 (H, W), valid bool (H, W)) with the
    parameters `p` (a configuration's sgbm group) and the uniqueness ratio
    `uniqueness`."""
    D, dmin = p["num_disparities"], p["min_disparity"]
    x0 = dmin + D
    C = cost_volume(left, right, D, dmin, p["block_size"], p["pre_filter_cap"])
    disp, valid, best, minS = wta(C.to(torch.int32), dmin, uniqueness)
    del C
    if p["disp12_max_diff"] >= 0:
        valid = valid & lr_keep(best, minS, disp, D, dmin, p["disp12_max_diff"])
    disp = torch.nn.functional.pad(disp, (x0, 0), value=float(dmin - 1))
    valid = torch.nn.functional.pad(valid, (x0, 0), value=False)
    if p["speckle_window_size"] > 0:
        keep = speckle_keep(disp[:, x0:], valid[:, x0:], p["speckle_window_size"],
                            float(p["speckle_range"]))
        valid = torch.nn.functional.pad(keep, (x0, 0), value=False)
    return disp, valid


def maps(config: dict, left: torch.Tensor, right: torch.Tensor, control: bool = False):
    """The reference of the "bm" chain: the maps of one (H, W) uint8 pair
    with a configuration's ``sgbm`` group (num_directions 0). `control`
    leaves out the uniqueness test (ratio 0), a stage a later change might
    drop (the control of ``correct``)."""
    p = config["sgbm"]
    if p["num_directions"] != 0:
        raise ValueError(f"the bm reference runs no path, got num_directions="
                         f"{p['num_directions']}")
    return bm(left, right, p, 0 if control else p["uniqueness_ratio"])
