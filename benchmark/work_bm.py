"""The WTA pass of block matching, counted from a configuration's shapes
alone: the yardstick of ``wta_roofline``. The whole layer's count is
``work.sgbm_work``, which counts zero paths as it counts five or eight.

The pass reduces a stored cost volume C (H, W - x0, D) int16, x0 =
min_disparity + num_disparities, to the four maps of the cropped columns:
the disparity f32, the validity (a byte), the winner and its cost (int32
each), 13 bytes a pixel.

Operations: ``work.OPS_PER["wta"]`` a cell (the packed key's multiply, add
and minimum; the uniqueness test's multiply, compare and or).

Bytes: C read once, 2 bytes a cell, and the maps written once, 13 bytes a
pixel of the cropped columns.

Least time: the larger of operations / PEAK_OPS_S and bytes / PEAK_BYTES_S
(``work.py``'s peaks, one H100 SXM at 700 W).

Why no implementation of this function reads above 100%: every cell of C is
an input on which the outputs depend (a pixel's winner, its uniqueness vote
and its neighbours' costs read C at every d), so each is read at least once,
and each byte of the four maps is an output, written at least once; the
counted operations are the fewest two-operand operations the key and the
vote take at every cell, and PEAK_OPS_S is no lower than any instruction
mix's rate (``work.py``). Bytes bound it at every shape the benchmark runs,
so a share above 100% would mean a time that leaves out part of the pass or
a count that is wrong. The count leaves out what the program keeps apart
from the pass (the cost kernel that writes C): a pass fused into the cost
kernel would read no C and is no longer this function.
"""

from __future__ import annotations

from benchmark.work import OPS_PER, PEAK_BYTES_S, PEAK_OPS_S

MAP_BYTES = 4 + 1 + 4 + 4  # disp f32, valid, best i32, minS i32


def wta_work(height: int, width: int, sgbm: dict) -> dict:
    """Operations and bytes of one frame's WTA pass over a stored C, and its
    least time on the card, in seconds."""
    D = sgbm["num_disparities"]
    pixels = height * max(width - sgbm["min_disparity"] - D, 0)
    cells = pixels * D
    ops = cells * OPS_PER["wta"]
    nbytes = cells * 2 + pixels * MAP_BYTES
    t_ops, t_bytes = ops / PEAK_OPS_S, nbytes / PEAK_BYTES_S
    return {"ops": ops, "bytes": nbytes, "least_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
