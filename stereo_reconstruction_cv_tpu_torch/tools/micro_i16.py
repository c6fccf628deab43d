"""Microbenchmark: add / min / roll chains by dtype (the 16-bit op-chain probe).

Port of ``tools/micro_i16.py``: the same dtypes and op sets on a (1024, 512)
array of integers in [1, 1000) from numpy's default_rng(0), REPS = 96 steps
per launch, timed with CUDA events around the replay of a CUDA graph of
launches (a launch takes less device time than its wrapper takes on the
host, so back-to-back calls would time the host). Prints, per case, the
time of one launch and the rate in cell-steps per second (H * W * REPS /
time).

    python -m stereo_reconstruction_cv_tpu_torch.tools.micro_i16

Needs a CUDA device. A case that fails prints FAIL; the exit code is then 1
(and 2 without a device).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch.ops.cuda import op_chain as OC
from stereo_reconstruction_cv_tpu_torch.utils.timing import card, graph_ms

CASES = (
    [(dt, ("add", "min")) for dt in (torch.float32, torch.int32, torch.int16, torch.uint16,
                                     torch.bfloat16)]
    + [(dt, ("roll", "add", "min")) for dt in (torch.float32, torch.int32, torch.int16,
                                               torch.uint16)]
)


def make_input(dtype, H: int = 1024, W: int = 512, device="cpu") -> torch.Tensor:
    x = np.random.default_rng(0).integers(1, 1000, (H, W))
    return torch.from_numpy(x).to(dtype).to(device)


def run(dtype, ops, H: int = 1024, W: int = 512) -> bool:
    """Time one case and print its line; False if it failed."""
    name = str(dtype).split(".")[-1]
    try:
        x = make_input(dtype, H, W, "cuda")
        ms = graph_ms(lambda: OC.op_chain(x, ops), iters=20, counts=(OC.launches, "op_chain"))
        cells = H * W * OC.REPS
        print(f"{name:8s} {'+'.join(ops):12s}: {ms * 1e3:8.1f} us "
              f"({cells / (ms * 1e-3) / 1e9:7.1f} Gop-cell/s)", flush=True)
        return True
    except Exception as e:  # report every case, then fail
        print(f"{name:8s} {'+'.join(ops):12s}: FAIL {type(e).__name__}: {e}"[:140], flush=True)
        return False


def main() -> int:
    if not torch.cuda.is_available():
        print("micro_i16: needs a CUDA device (the op-chain kernel runs only on the card)",
              file=sys.stderr)
        return 2
    print(card(), flush=True)
    ok = [run(dtype, ops) for dtype, ops in CASES]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
