"""Probe: the points layer's two kernels (``ops/cuda/cloud.py``) at 720p and 4K.

    python -m stereo_reconstruction_cv_tpu_torch.tools.probe_cloud [--out FILE]

On a disparity map like an SGBM map of the benchmark's rig (smooth
disparities, 0 where the LR check failed, -1 in the left margin, ~80% valid)
and that rig's Q it checks each kernel against its plain version on the card
(bit for bit), and prints one JSON line a size: each kernel's device time
(CUDA-graph replay over enough copies of the inputs to overflow the 50 MB L2
cache, as the chain finds them after SGBM), the two compaction launches apart
(torch.profiler), the plain versions' times (CUDA events), each kernel's bytes
bound at 3.35 TB/s and its share, and the card. Needs a CUDA device (exit 2
without one); exit 1 where a kernel differs from its plain version.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import sys

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch.ops.cuda import cloud as CL
from stereo_reconstruction_cv_tpu_torch.utils import synth
from stereo_reconstruction_cv_tpu_torch.utils.timing import card, cuda_ms, graph_ms, kernel_ms

PEAK_BYTES_S = 3.35e12
SIZES = ((720, 1280, 128), (2160, 3840, 256))  # H, W, disparities


def sgbm_like(rng, H: int, W: int, D: int):
    """(disparity f32, valid bool) on the host: a smooth surface in (1, D),
    0 where invalid (~20%), -1 over the left D columns, as SGBM leaves them."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    d = (0.3 * D + 0.25 * D * np.sin(x / 97.0) * np.cos(y / 61.0)).astype(np.float32)
    d += rng.integers(0, 16, (H, W)).astype(np.float32) / 16.0
    valid = rng.random((H, W)) > 0.2
    d[~valid] = 0.0
    d[:, :D] = -1.0
    valid[:, :D] = False
    return d, valid


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def measure(dev, H: int, W: int, D: int, seed: int = 0) -> dict:
    _, res = synth.rectified_rig((W, H))
    Q = res.Q.to(torch.float32)
    d_np, v_np = sgbm_like(np.random.default_rng(seed), H, W, D)
    disp, valid = torch.from_numpy(d_np).to(dev), torch.from_numpy(v_np).to(dev)
    pts = CL.reproject_cuda(disp, Q)
    want = CL.reproject_plain(disp, Q)
    equal_card = torch.equal(bits(pts), bits(want))
    equal_cpu = torch.equal(bits(pts).cpu(), bits(CL.reproject_plain(disp.cpu(), Q)))
    got_pts, got_n = CL.compact_cuda(disp, pts, valid)
    want_pts, want_n = CL.compact_plain(disp, pts, valid)
    n = int(want_n)
    equal_compact = int(got_n) == n and torch.equal(bits(got_pts[:n]), bits(want_pts[:n]))
    passed = int((valid & (disp > 0)).sum())

    frame_bytes = H * W * (4 + 1 + 12)
    copies = max(1, math.ceil(150e6 / frame_bytes))
    sets = [(disp.clone(), valid.clone(), pts.clone()) for _ in range(copies)]
    cyc_r, cyc_c = itertools.cycle(sets), itertools.cycle(sets)
    iters = copies * math.ceil(20 / copies)

    def reproject():
        dd, _, pp = next(cyc_r)
        return CL.reproject_cuda(dd, Q, pp)

    def compact():
        dd, vv, pp = next(cyc_c)
        return CL.compact_cuda(dd, pp, vv)

    t_r = graph_ms(reproject, iters=iters)
    t_c = graph_ms(compact, iters=iters)
    t_rp = cuda_ms(lambda: CL.reproject_plain(disp, Q), 5)
    t_cp = cuda_ms(lambda: CL.compact_plain(disp, pts, valid), 5)
    split = kernel_ms(lambda: CL.compact_cuda(disp, pts, valid))
    del sets
    b_r = H * W * (4 + 12) / PEAK_BYTES_S * 1e3
    # Each input byte read once: disparity and mask everywhere, the points
    # where those pass (the finite test), and the kept points written.
    b_c = (H * W * 5 + 12 * passed + 12 * n) / PEAK_BYTES_S * 1e3
    return {
        "size": f"{W}x{H}", "equal": {"reproject_card": equal_card, "reproject_cpu": equal_cpu,
                                      "compact": equal_compact},
        "kept": n, "passed": passed, "pixels": H * W,
        "reproject": {"ms": t_r, "plain_ms": t_rp, "bound_ms": b_r, "share": b_r / t_r},
        "compact": {"ms": t_c, "plain_ms": t_cp, "bound_ms": b_c, "share": b_c / t_c,
                    "launches_ms": split},
        "layer": {"ms": t_r + t_c, "plain_ms": t_rp + t_cp, "bound_ms": b_r + b_c,
                  "share": (b_r + b_c) / (t_r + t_c)},
        "card": card(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_cloud: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    lines = [measure(dev, H, W, D) for H, W, D in SIZES]
    text = "\n".join(json.dumps(line) for line in lines)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0 if all(all(line["equal"].values()) for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
