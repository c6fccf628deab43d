"""Probe the sparse path's largest stage and its host syncs on the card.

    python -m stereo_reconstruction_cv_tpu_torch.tools.probe_sparse

On the 4K scene of chip_smoke.py phase 7 (utils/synth.py's raw rig):
1. the 5-point solver over 256 minimal problems, as it stands (the
   reference's unrolled partially pivoted LU for det M~) and with
   ``torch.linalg.det`` in its place: times, and whether both find the same
   roots;
2. the host syncs of one warm ``estimate_geometry``, by source line
   (``torch.cuda.set_sync_debug_mode``, which PyTorch calls a prototype
   that does not see every sync).
Prints one JSON line each. Exit 2 without a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time
import warnings

import numpy as np


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_sparse: no CUDA device", file=sys.stderr)
        return 2
    from stereo_reconstruction_cv_tpu_torch.ops import fivepoint as FP
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages
    from stereo_reconstruction_cv_tpu_torch.utils import synth

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    M = 256  # the samples find_essential draws at the default 2048 hypotheses
    X = np.stack([rng.uniform(-2, 2, (M, 5)), rng.uniform(-1.5, 1.5, (M, 5)),
                  rng.uniform(3, 8, (M, 5))], -1)
    X2 = X @ synth.rotation_about((0.1, 1.0, 0.2), 3.0).T + np.array([-1.0, 0.1, 0.05])
    n1 = torch.from_numpy(X[..., :2] / X[..., 2:]).to(dev)
    n2 = torch.from_numpy(X2[..., :2] / X2[..., 2:]).to(dev)

    def ms(fn, n=5):
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n, out

    t_lu, (E1, v1) = ms(lambda: FP.essential_5pt(n1, n2))
    det_lu = FP._det_lu
    FP._det_lu = torch.linalg.det
    try:
        t_det, (E2, v2) = ms(lambda: FP.essential_5pt(n1, n2))
    finally:
        FP._det_lu = det_lu
    both = v1 & v2
    diff = torch.minimum((E1 - E2).abs().amax((-2, -1)), (E1 + E2).abs().amax((-2, -1)))[both]
    print(json.dumps({"essential_5pt_256_ms": {"unrolled_lu": t_lu, "torch_linalg_det": t_det},
                      "roots": int(v1.sum()), "same_valid": bool(torch.equal(v1, v2)),
                      "max_candidate_diff": float(diff.max()) if diff.numel() else 0.0}))

    K = synth.K_4K
    left, right = synth.render_pair(K, synth.rotation_about(synth.SCENE_AXIS, synth.SCENE_DEG),
                                 np.array(synth.SCENE_T), 2160, 3840, seed=synth.SEED, device=dev)
    stages.estimate_geometry((left, right), synth.BASELINE_M, K, device="cuda")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            stages.estimate_geometry((left, right), synth.BASELINE_M, K, device="cuda")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    lines = {}
    for w in caught:
        if "synchronizing" in str(w.message):
            key = f"{w.filename.split('/')[-1]}:{w.lineno}"
            lines[key] = lines.get(key, 0) + 1
    print(json.dumps({"estimate_geometry_syncs": sum(lines.values()), "by_line": lines}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
