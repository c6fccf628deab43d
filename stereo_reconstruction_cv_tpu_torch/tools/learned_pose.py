"""The learned geometry path's pose on the rendered scene of utils/synth.py.

    python -m stereo_reconstruction_cv_tpu_torch.tools.learned_pose [--seeds N] [--out CORR.npz]

Run on the card. The raw rig of utils/synth.py (chip_smoke.py phase 7's) (x2 = R x1 + T, R
1.2 deg, T (-0.14, 0.004, -0.003) m) at two sizes: 960x540 with K_4K / 4,
detected at its own size, and 3840x2160 with K_4K, detected at 1920x1080
with LK at full size. For each size: estimate_geometry(method="learned")
over seeds 0 to N - 1 (5 by default): matches, F and E inliers, R and t
direction error against the truth in degrees; and how far the
correspondences lie from the true epipolar lines (Sampson distance), with
how many of them LK moved. One JSON line a size. --out saves each size's correspondences and truth, on which
tools/learned_pose_reference.py runs the JAX reference's robust fits.
Exit 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np


def true_fundamental(K, R_true, T_true):
    """F of the rig x2 = R x1 + T with both cameras K."""
    tx = np.array([[0.0, -T_true[2], T_true[1]], [T_true[2], 0.0, -T_true[0]],
                   [-T_true[1], T_true[0], 0.0]])
    Ki = np.linalg.inv(K)
    return Ki.T @ tx @ R_true @ Ki


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=5, help="seeds of the robust fits")
    ap.add_argument("--out", help="save each size's correspondences and truth (.npz)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("learned_pose: no CUDA device", file=sys.stderr)
        return 2
    from stereo_reconstruction_cv_tpu_torch import config as C
    from stereo_reconstruction_cv_tpu_torch.utils import synth
    from stereo_reconstruction_cv_tpu_torch.ops import geometry as G
    from stereo_reconstruction_cv_tpu_torch.ops.refine import refine_matches_lk
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages

    dev = torch.device("cuda")
    R_true, T_true = synth.rotation_about(synth.SCENE_AXIS, synth.SCENE_DEG), np.array(synth.SCENE_T)
    base = float(np.linalg.norm(T_true))
    cfg = C.DEFAULT.match
    saved = {}
    for H, W in ((540, 960), (2160, 3840)):
        K = synth.K_4K.copy()
        K[:2] *= W / 3840.0
        left, right = synth.render_pair(K, R_true, T_true, H, W, seed=synth.SEED, device=dev)
        runs = []
        for seed in range(args.seeds):
            g = stages.estimate_geometry((left, right), base, K, seed=seed, method="learned",
                                         device=dev)
            r, t = synth.pose_errors(g["Rotation Matrix"], g["Translation Vector"], R_true, T_true)
            runs.append({"seed": seed, "matches": g["num_matches"], "F_inliers": g["num_inliers_F"],
                         "E_inliers": g["num_inliers_E"], "R_deg": r, "t_deg": t})
        p1, p2, mask, factor = stages._match_for_geometry(left, right, cfg, method="learned")
        u1, u2, _, _ = stages._match_for_geometry(left, right, dataclasses.replace(cfg, lk_refine=False),
                                                  method="learned")
        _, moved = refine_matches_lk(left, right, u1.float(), u2.float(), win=cfg.lk_win,
                                     iters=cfg.lk_iters)
        F = torch.as_tensor(true_fundamental(K, R_true, T_true), device=dev)
        d = torch.sqrt(G.sampson_error(F, p1, p2))[mask].cpu().numpy()
        p1, p2, mask = p1.cpu().numpy(), p2.cpu().numpy(), mask.cpu().numpy()
        print(json.dumps({
            "size": f"{W}x{H}", "detect_factor": factor, "seeds": runs,
            "median_R_deg": float(np.median([x["R_deg"] for x in runs])),
            "median_t_deg": float(np.median([x["t_deg"] for x in runs])),
            "lk_moved": int(((moved != 0).any(-1).cpu().numpy() & mask).sum()),
            "sampson_px": {"under_0.5": int((d < 0.5).sum()), "under_1": int((d < 1.0).sum()),
                           "over_1.5": int((d > 1.5).sum()), "median": float(np.median(d))},
        }), flush=True)
        saved.update({f"{H}_{k}": v for k, v in dict(
            p1=p1, p2=p2, mask=mask, factor=np.array(factor), K=K, R=R_true, T=T_true).items()})
    if args.out:
        np.savez(args.out, **saved)
    return 0


if __name__ == "__main__":
    sys.exit(main())
