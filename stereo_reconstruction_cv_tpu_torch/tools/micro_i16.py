"""Microbenchmark: add / min / roll chains by dtype (the 16-bit op-chain probe).

Port of ``tools/micro_i16.py``: the same dtypes and op sets on a (1024, 512)
array of integers in [1, 1000) from numpy's default_rng(0), REPS = 96 steps
per launch, timed with CUDA events around the replay of a CUDA graph of
launches (a launch takes less device time than its wrapper takes on the
host, so back-to-back calls would time the host). Prints, per case, the
time of one launch and the rate in cell-steps per second (H * W * REPS /
time): first at the reference's (1024, 512), then at (16384, 512), where
the card is full and the rate, not the launch ramp, is read.

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
SIZES = ((1024, 512), (16384, 512))  # the reference's, then one that fills the card

# The largest value of each dtype that edge_values draws (see there).
EDGE_TOP = {torch.int16: 2**15 - 1, torch.uint16: 2**16 - 1, torch.int32: 2**31 - 1,
            torch.float32: 2**24 - 7}


def edge_values(dtype, H: int, W: int, seed: int = 0) -> np.ndarray:
    """(H, W) int64 values where the chain's +1 is not plain integer
    arithmetic in `dtype`: an integer dtype's largest value minus 0..7 (+1
    wraps to the smallest), bfloat16 integers in [2^8, 2^12) (+1 rounds to
    an even neighbour, or back), float32 in [2^24 - 14, 2^24 - 7] (+1 stops
    being exact after 7 to 14 steps: past 2^24 each step rounds). float32
    starts below 2^24 because XLA folds a run of float adds of a constant
    into one add, so a reference chain of adds alone that crossed 2^24 in a
    few steps would round once, not each step. A quarter of the values are
    integers in [1, 1000), so that edge values meet ordinary ones in the
    roll."""
    rng = np.random.default_rng(seed)
    ordinary = rng.random((H, W)) < 0.25
    low = rng.integers(1, 1000, (H, W))
    if dtype == torch.bfloat16:
        edge = rng.integers(2**8, 2**12, (H, W))
    else:
        edge = EDGE_TOP[dtype] - rng.integers(0, 8, (H, W))
    return np.where(ordinary, low, edge)


def make_input(dtype, H: int = 1024, W: int = 512, device="cpu",
               edge: bool = False) -> torch.Tensor:
    """The reference's input, integers in [1, 1000) from default_rng(0); or,
    with edge, edge_values."""
    x = edge_values(dtype, H, W) if edge else np.random.default_rng(0).integers(1, 1000, (H, W))
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
    ok = []
    for H, W in SIZES:
        print(f"(H, W) = ({H}, {W})", flush=True)
        ok += [run(dtype, ops, H, W) for dtype, ops in CASES]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
