"""Time BASELINE config 4's step on the card, with its detection and refinement.

    python -m stereo_reconstruction_cv_tpu_torch.tools.time_config4 [RUNS]

Renders chip_smoke.py phase 8's 960x536 pair (benchmarks.bench_config4's
first). The step is detect_pair (1024 keypoints) -> match_learned ->
gather_correspondences -> triangulate_points -> masked sum, with the
shipped weights; RUNS warm runs (20 by default) after one cold one, each
synchronised. Then the corner refinement of both images' keypoints,
refined image by image (two calls) and as one batch (one call, as
detect_pair runs it), in alternating runs. Prints one JSON line: the first
run, median and minimum in ms of each, and the card's name and power
limit. Exit 2 without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    runs = int(argv[0]) if argv else 20
    import torch

    if not torch.cuda.is_available():
        print("time_config4: no CUDA device", file=sys.stderr)
        return 2
    from stereo_reconstruction_cv_tpu_torch import benchmarks as B
    from stereo_reconstruction_cv_tpu_torch.models import xfeat as XF
    from stereo_reconstruction_cv_tpu_torch.ops import geometry as G
    from stereo_reconstruction_cv_tpu_torch.ops import matching as MT
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages
    from stereo_reconstruction_cv_tpu_torch.utils import synth

    dev = torch.device("cuda")
    W, H = B.CONFIG4_SIZE
    K = synth.K_4K.copy()
    K[:2] *= W / 3840.0
    T = np.array([-synth.BASELINE_M, 0.0, 0.0])
    left, right = synth.render_pair(K, np.eye(3), T, H, W, seed=synth.SEED, device=dev)
    _, rect = synth.rectified_rig((W, H))
    P1, P2 = rect.P1.to(dev, torch.float32), rect.P2.to(dev, torch.float32)
    model = stages._xfeat_model(None, dev)

    def detect():
        return XF.detect_pair(model, left, right, B.CONFIG4_MAXK)

    def step():
        f1, f2 = detect()
        res = MT.match_learned(f1.descriptors, f2.descriptors)
        a, b, ok = MT.gather_correspondences(f1.keypoints, f2.keypoints, res)
        pts = G.triangulate_points(P1, P2, a, b)
        return torch.where(ok[:, None], pts, torch.zeros_like(pts)).sum(0)

    def ms(fn):
        walls = []
        for _ in range(1 + runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        return {"first": walls[0], "median": statistics.median(walls[1:]), "min": min(walls[1:])}

    imgs = torch.stack([left, right])
    heats = XF.heatmap_from_logits(model(imgs.to(torch.float32) / 255.0)[0])
    kpts = torch.stack([XF.peaks(heats[i], B.CONFIG4_MAXK)[1] for i in range(2)])
    refine = {
        "per_image": lambda: [XF.refine_keypoints(imgs[i], kpts[i]) for i in range(2)],
        "batched": lambda: XF.refine_keypoints(imgs, kpts),
    }
    gap = float((torch.stack(refine["per_image"]()) - refine["batched"]()).abs().max())
    if gap > 1e-4:
        print(f"time_config4: batched and per-image refinement differ by {gap} px", file=sys.stderr)
        return 1
    walls = {k: [] for k in refine}
    for _ in range(1 + runs):
        for k, fn in refine.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[k].append(1e3 * (time.perf_counter() - t0))
    out = {"step_ms": ms(step), "detect_pair_ms": ms(detect), "runs": runs,
           "refine_batched_vs_per_image_px": gap}
    for k, w in walls.items():
        out[f"refine_{k}_ms"] = {"first": w[0], "median": statistics.median(w[1:]), "min": min(w[1:])}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "not read"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
