"""The SGBM layer's work, counted from a configuration's shapes alone, and
the card's peaks: the yardstick of ``sgbm_roofline``.

Operations. The number of cells is H x (W - x0) x D, x0 = min_disparity +
num_disparities (the cropped columns every implementation fills). Per cell:
the cost (``OPS_PER["cost_volume"]``: Birchfield-Tomasi on two planes, four
subtractions, four maxima and one minimum each, their sum, and four for the
box's running sums), one DP step per path direction
(``OPS_PER["sgm_path_sweep"]`` x paths: the minimum with P2, the minimum of
the two neighbours, + P1, the minimum, + C, the running minimum and
renormalisation, the accumulation into S) and the WTA (``OPS_PER["wta"]``:
the packed key's multiply, add and minimum, the uniqueness test's multiply,
compare and or). Per pixel: the LR check (``OPS_PER["lr_check"]``) and the
speckle filter (``OPS_PER["speckle"]``: two edges, a union, a histogram add
and a compare).

Bytes. Only what any implementation has to move: the two uint8 frames in,
the float32 disparity and the bool validity out, 7 bytes a pixel. The
volumes that today's kernels write and read again are not counted, so a
kernel that fuses two launches leaves the count as it is.

Least time. The larger of operations / PEAK_OPS_S and bytes / PEAK_BYTES_S,
the published rates of one H100 SXM at 700 W (a card set to a lower power
limit runs below them: the run reports its limit beside the share).

Why no implementation that gives the same outputs reads above 100%:

- every counted cell operation is one that the outputs depend on. S at a
  cell is the sum of every path's L there, each L needs its predecessor's
  whole row of D values, and the WTA, the uniqueness test and the subpixel
  read S at every d; so an exact implementation evaluates each path's
  recurrence at every cell and reduces every cell, whatever it fuses or
  keeps on chip. The counts are the fewest two-operand operations that the
  arithmetic above takes, and the per-pixel counts are small beside them;
- PEAK_OPS_S is 2 operations per lane per cycle at every one of the 128
  FP32 lanes of each of 132 SMs at the 1.98 GHz boost clock (an FMA counted
  as two). The integer pipes that SGBM's adds, minima and compares use have
  half as many lanes (64 a SM), so even an instruction that does four
  counted operations (a 3-input minimum or an add-minimum on two packed
  16-bit halves, Hopper's DPX) retires at most 256 a SM and cycle: the same
  rate. So no mix of instructions computes the counted operations faster;
- the bytes are each read or written once, and PEAK_BYTES_S is HBM3's rate.

A share that reads above 100% therefore means a time that leaves out part
of the work (a range that misses a launch) or a count that is wrong.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
OPS_PER = {
    "cost_volume": 23,
    "sgm_path_sweep": 8,
    "wta": 6,
    "lr_check": 20,
    "speckle": 10,
}


def sgbm_work(height: int, width: int, sgbm: dict) -> dict:
    """Operations and bytes of one frame's SGBM at a configuration's shapes,
    and the least time the card could take for it, in seconds."""
    D = sgbm["num_disparities"]
    cells = height * max(width - sgbm["min_disparity"] - D, 0) * D
    pixels = height * width
    ops = (cells * (OPS_PER["cost_volume"] + OPS_PER["sgm_path_sweep"] * sgbm["num_directions"]
                    + OPS_PER["wta"])
           + pixels * (OPS_PER["lr_check"] + OPS_PER["speckle"]))
    nbytes = pixels * (2 + 4 + 1)
    t_ops, t_bytes = ops / PEAK_OPS_S, nbytes / PEAK_BYTES_S
    return {"ops": ops, "bytes": nbytes, "least_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
