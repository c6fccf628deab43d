"""How ``correct`` is decided: the program's sampled pairs against the plain
reference (``benchmark/reference/``), each number beside its limit.

For each sampled pair the reference works out again, from the frames the
benchmark made and the rig's K, R and T:

- mixes of the raw rig: the rig's maps and the rectified frames
  (``rect_px``: pixels of the two rectified frames that differ from the
  program's);
- mixes with files: the decode of the pair's JPEG files by PIL (libjpeg)
  (``decode_mae``, ``decode_max``: the mean and the largest absolute
  difference of the program's decoded frames from it, grey levels). The
  decoders differ by design, so the reference's SGBM follows from the
  program's decoded frames, and the decode is judged by itself; for the
  first sampled pair the reference also runs its SGBM on PIL's decode
  (``pil_bad_px``: pixels valid on one side only, or valid on both with
  disparities more than 1 px apart), which ties the program's map to the
  files end to end. One grey level of decode moves the subpixel disparity
  of most pixels by a little, since the paths carry a cost change across
  the frame, so only a gross difference is counted;
- the disparity map and the validity mask (``map_px``: pixels where either
  differs), and the cloud (``cloud_count_diff``: points more or fewer;
  ``cloud_err``: the largest coordinate difference over the largest
  coordinate of the reference's cloud).

The worst reading over the sampled pairs is compared with its limit (a
configuration's ``limits``); a number passes when it is at most its limit.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import traffic
from benchmark.reference import rig as RR

ORDER = ("rect_px", "decode_mae", "decode_max", "pil_bad_px", "map_px", "cloud_count_diff",
         "cloud_err")


def reference_rig(config: dict, mix: dict, K, R, T, device):
    """The reference's rectification of the rig (float64, on the host) and,
    for a mix whose chain rectifies, its two maps on `device` (else None)."""
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    size = (config["width"], config["height"])
    res = RR.stereo_rectify(f64(K), f64(K), size, f64(R), f64(T), alpha=config["rig"]["alpha"])
    if not traffic.rectifies(mix):
        return res, None
    return res, [RR.rectify_map(f64(K), Rk, Pk, size, device)
                 for Rk, Pk in ((res.R1, res.P1), (res.R2, res.P2))]


def pil_decode(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im.convert("L"))


def judge_pair(config: dict, ref, pair, raw, files, res, maps, device,
               own_decode: bool = False) -> dict:
    """The numbers of one sampled pair. `ref` is the plain reference of the
    configuration's chain (``reference/<chain>.py``), `raw` the pair's host
    frames as rendered, `files` its JPEG files or None, `maps` the
    reference's maps where the chain rectifies (else None); `own_decode`
    adds ``pil_bad_px``."""
    out = {}
    prog_l, prog_r = (f.to(device) for f in pair.frames)
    if maps is not None:
        rect = [RR.remap_bilinear(torch.from_numpy(f).to(device), m)
                for f, m in zip(raw, maps)]
        out["rect_px"] = int((rect[0] != prog_l).sum() + (rect[1] != prog_r).sum())
        left, right = rect
    else:
        left, right = prog_l, prog_r
    pd, pv = pair.disp.to(device), pair.valid.to(device)
    if files is not None:
        decoded = [pil_decode(p) for p in files]
        diffs = [np.abs(d.astype(np.int16) - f.cpu().numpy().astype(np.int16))
                 for d, f in zip(decoded, (prog_l, prog_r))]
        out["decode_mae"] = float(np.mean([d.mean() for d in diffs]))
        out["decode_max"] = int(max(d.max() for d in diffs))
        if own_decode:
            disp, valid = ref.maps(config, *(torch.from_numpy(d).to(device) for d in decoded))
            gross = pv & valid & ((pd - disp).abs() > 1.0)
            out["pil_bad_px"] = int(((pv != valid) | gross).sum())
            del disp, valid
    disp, valid = ref.maps(config, left, right)
    out["map_px"] = int(((pv != valid) | (pd != disp)).sum())
    ref_cloud = RR.cloud(disp, valid, res.Q.to(torch.float32)).cpu()
    n = int(pair.host_n[0])
    out["cloud_count_diff"] = abs(n - ref_cloud.shape[0])
    m = min(n, ref_cloud.shape[0])
    scale = float(ref_cloud.abs().max()) if ref_cloud.numel() else 1.0
    prog_cloud = pair.host_pts[:m]
    out["cloud_err"] = (float((prog_cloud - ref_cloud[:m]).abs().max()) / scale) if m else 0.0
    return out


def worst(readings: list) -> dict:
    keys = [k for k in ORDER if any(k in r for r in readings)]
    return {k: max(r[k] for r in readings if k in r) for k in keys}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value": v, "limit": l}}) in ORDER."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return all(v <= limits[k] for k, v in numbers.items()), checks
