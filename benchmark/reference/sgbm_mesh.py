"""Plain SGBM over a ('data', 'space') mesh in halo mode: the benchmark's
reference for the disparity layer of the "sgbm_mesh" chain.

Halo mode as the port defines it: a frame's rows are split into
``mesh.space`` equal shards; shard j runs the plain SGBM of ``sgbm.py``,
speckle filter off, on its own rows plus ``halo`` rows from each interior
neighbour (none at a true image edge; at most a shard's rows), and is
cropped back to its own rows. The speckle filter then runs on the whole
frame, right of the min_disparity + num_disparities margin. The 'data'
axis splits the batch into independent pairs and changes no map.

This is the port's fix of reference fault 12: the JAX package's shards at
the image's top and bottom edges run on ``halo`` rows of zeros beyond the
edge, where these run on none.

Imports nothing of the program. Runs on the device of its inputs.
"""

from __future__ import annotations

import torch

from benchmark.reference import sgbm as RS


def maps(config: dict, left: torch.Tensor, right: torch.Tensor, control: bool = False):
    """The maps of one (H, W) uint8 pair under the configuration's ``sgbm``
    group, ``mesh`` and ``halo``. `control` leaves the last path direction
    out, as ``sgbm.maps`` does."""
    p = config["sgbm"]
    ns = config["mesh"]["space"]
    H = left.shape[0]
    h = H // ns
    halo = 0 if ns == 1 else min(config["halo"], h)
    dirs = RS.directions(p["num_directions"])
    dirs = dirs[:-1] if control else dirs
    core = dict(p, speckle_window_size=0)
    ds, vs = [], []
    for j in range(ns):
        top = halo if j > 0 else 0
        bottom = halo if j < ns - 1 else 0
        rows = slice(j * h - top, (j + 1) * h + bottom)
        d, v = RS.sgbm(left[rows], right[rows], core, dirs)
        ds.append(d[top:top + h])
        vs.append(v[top:top + h])
    disp, valid = torch.cat(ds), torch.cat(vs)
    if p["speckle_window_size"] > 0:
        x0 = p["min_disparity"] + p["num_disparities"]
        keep = RS.speckle_keep(disp[:, x0:], valid[:, x0:], p["speckle_window_size"],
                               float(p["speckle_range"]))
        valid = torch.nn.functional.pad(keep, (x0, 0), value=False)
    return disp, valid
