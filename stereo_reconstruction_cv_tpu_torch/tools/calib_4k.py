"""chip_smoke.py phase 9's calibration set on the card, saved for the JAX reference.

    python -m stereo_reconstruction_cv_tpu_torch.tools.calib_4k --out CALIB.npz

Run on the card. Renders utils/synth.py's calibration set (22 board
poses, each seen by both cameras of the raw rig,
3840x2160), detects every board, and calibrates: calibrate_camera on all 44
views, calibrate_stereo on the 22 pairs. Prints one JSON line (the times,
the errors against the truth) and saves the corners, the object grid and
the port's results; ``python tests/test_torch_calib.py CALIB.npz`` then runs
the reference's calibrate_camera and calibrate_stereo on the same corners,
where JAX is. Exit 2 without a CUDA device, 1 if a board is not found.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="the corners and the port's results (.npz)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calib_4k: no CUDA device", file=sys.stderr)
        return 2
    from stereo_reconstruction_cv_tpu_torch.utils import synth
    from stereo_reconstruction_cv_tpu_torch.utils.timing import card

    dev = torch.device("cuda")
    calib = synth.calibration_set(dev)
    run = synth.calibrate_set(calib, torch.cuda.synchronize)
    if run["missed"]:
        print(f"calib_4k: no board in views (camera, pose) {run['missed']}", file=sys.stderr)
        return 1
    c1, c2 = (c.cpu() for c in run["corners"])
    err = torch.cat([c1 - calib["truth"][0], c2 - calib["truth"][1]]).norm(dim=-1)
    mono, rig = run["mono"], run["rig"]
    r_err, t_err = synth.pose_errors(rig.R.cpu().numpy(), rig.T.cpu().numpy(), calib["R"], calib["T"])
    print(json.dumps({
        "card": card(), "views": 2 * len(c1), "detect_s": run["detect_s"], "lm_s": run["lm_s"],
        "stereo_s": run["stereo_s"], "corner_error_mean_px": float(err.mean()),
        "mean_error": float(mono.mean_error), "rms": float(mono.rms), "K": mono.K.cpu().tolist(),
        "K_true": calib["K"].tolist(), "stereo_R_deg": r_err, "stereo_T_deg": t_err,
    }), flush=True)
    np.savez(args.out, obj=calib["obj"].numpy(), corners1=c1.numpy(), corners2=c2.numpy(),
             truth1=calib["truth"][0].numpy(), truth2=calib["truth"][1].numpy(),
             size=np.array(calib["size"]), K=mono.K.cpu().numpy(), dist=mono.dist.cpu().numpy(),
             mean_error=mono.mean_error.cpu().numpy(), rms=mono.rms.cpu().numpy(),
             R=rig.R.cpu().numpy(), T=rig.T.cpu().numpy(), stereo_rms=rig.rms.cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
