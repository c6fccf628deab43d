"""The JAX reference's robust fits on saved learned correspondences.

    python tools/learned_pose_reference.py CORR.npz [SEEDS]

CORR.npz is what ``python -m stereo_reconstruction_cv_tpu_torch.tools.learned_pose
--out CORR.npz`` saves on the card: for each rendered size, the learned
correspondences of the port's _match_for_geometry (which the tests hold to
the reference's) and the truth. For each size this runs the reference's
estimate_geometry past its matching (F by LMedS, E by 5-point RANSAC at
e_threshold_px times the detection factor, recoverPose) over seeds 0 to
SEEDS - 1 (5 by default) and prints one JSON line: F and E inliers, R and t
direction error against the truth in degrees, and their medians. Runs on
the CPU.
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from chip_smoke import pose_errors  # noqa: E402
from stereo_reconstruction_cv_tpu.pipeline import stages as RS  # noqa: E402


def main(path: str, seeds: int = 5) -> int:
    z = np.load(path)
    for H in sorted({int(k.split("_")[0]) for k in z.files}):
        p1, p2, mask = (z[f"{H}_{k}"] for k in ("p1", "p2", "mask"))
        factor, K, R_true, T_true = int(z[f"{H}_factor"]), z[f"{H}_K"], z[f"{H}_R"], z[f"{H}_T"]
        match = RS._match_for_geometry
        RS._match_for_geometry = lambda *a, **k: (p1, p2, mask, factor)
        try:
            blank = np.zeros((16, 16), np.uint8)
            runs = []
            for seed in range(seeds):
                g = RS.estimate_geometry((blank, blank), float(np.linalg.norm(T_true)), K,
                                         seed=seed, method="learned")
                r, t = pose_errors(g["Rotation Matrix"], g["Translation Vector"], R_true, T_true)
                runs.append({"seed": seed, "matches": g["num_matches"],
                             "F_inliers": g["num_inliers_F"], "E_inliers": g["num_inliers_E"],
                             "R_deg": r, "t_deg": t})
        finally:
            RS._match_for_geometry = match
        print(json.dumps({"size_h": H, "detect_factor": factor, "reference_seeds": runs,
                          "median_R_deg": float(np.median([x["R_deg"] for x in runs])),
                          "median_t_deg": float(np.median([x["t_deg"] for x in runs]))}),
              flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], *map(int, sys.argv[2:])))
