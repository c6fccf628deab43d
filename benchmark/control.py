"""The control of ``correct``: the plain reference put in the program's place
with one stated guarantee broken at each stage, judged as a run judges the
program. Every number it reads must fail its limit somewhere.

- rectification: the bilinear weights in bfloat16, the precision below the
  maps' float32;
- decode: the JPEG decoded at half scale (libjpeg's DCT scaling, PIL's
  ``draft``) and repeated back to full size, the tempting shortcut of a
  decoder;
- disparity: one path direction left out of the configuration's 5 or 8
  (the last of the list), a sweep a later change might drop.

    python3 benchmark/control.py --workload CELL --seeds 1,2,3

on the card prints, for each seed, the numbers of one pair drawn from it,
each beside its limit, and one JSON line.
Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def control_pair(config: dict, ref, k: int, raw, files, res, maps, device):
    """The control's record of pair k, in the form of a run's sampled pair."""
    from benchmark import traffic
    from benchmark.reference import rig as RR

    if maps is not None:
        frames = [RR.remap_bilinear(torch.from_numpy(f).to(device), m, torch.bfloat16)
                  for f, m in zip(raw, maps)]
    elif files is not None:
        frames = [torch.from_numpy(half_scale_decode(p)).to(device) for p in files]
    else:
        frames = [torch.from_numpy(f).to(device) for f in raw]
    disp, valid = ref.maps(config, frames[0], frames[1], control=True)
    cloud = RR.cloud(disp, valid, res.Q.to(torch.float32)).cpu()
    return traffic.Pair(k, tuple(frames), disp, valid, cloud,
                        torch.tensor([cloud.shape[0]], dtype=torch.int64))


def half_scale_decode(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        W, H = im.size
        im.draft("L", (W // 2, H // 2))
        small = np.asarray(im.convert("L"))
    return np.repeat(np.repeat(small, 2, 0), 2, 1)[:H, :W]


def control_numbers(name: str, seed: int, device, root: Path = ROOT, overrides=None) -> dict:
    """(the control's numbers, the limits) for one pair drawn from `seed`,
    at the cell's own size (`overrides` as harness.load_cell takes them)."""
    from benchmark import check, harness, traffic

    _, config, mix, _, _ = harness.load_cell(name, root, overrides)
    rig, pairs = traffic.render(config, mix, seed, device)
    k = int(np.random.default_rng(seed % (1 << 64)).integers(0, len(pairs)))
    res, maps = check.reference_rig(config, mix, *rig, device)
    ref = harness.piece("reference", config["chain"], root)
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as folder:
        files = traffic.write_files(pairs, mix, folder)
        files = None if files is None else files[k]
        pair = control_pair(config, ref, k, pairs[k], files, res, maps, device)
        numbers = check.judge_pair(config, ref, pair, pairs[k], files, res, maps, device,
                                   own_decode=True)
    return numbers, config["limits"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers, limits = control_numbers(args.workload, seed, device)
        failed = sorted(k for k, v in numbers.items() if v > limits[k])
        for k, v in numbers.items():
            print(f"control {args.workload} seed {seed} {k} {v} limit {limits[k]}")
        rows.append({"seed": seed, "numbers": numbers, "failed": failed})
    print(json.dumps({"workload": args.workload, "control": rows}))
    return 0 if all(r["failed"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
