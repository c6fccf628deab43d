"""Microbenchmark: the standalone WTA pass and its variants at 4K.

Port of ``tools/micro_wta.py``: the same arguments, variant names and
volumes (C in [0, 20000) int16 and one delta volume in [0, 40000) u16, both
(Wc, H, D) with H = 2160 and Wc = 3840 - D, from numpy's default_rng(0)),
timed with CUDA events. Every variant computes the same maps; they differ in
the kernel's tile and warp reductions.

    python -m stereo_reconstruction_cv_tpu_torch.tools.micro_wta [D] [variants]

variants, comma-separated (default: shipped):
  shipped         wta_volume over C and the delta volume (nd = 5)
  shipped2        wta_volume over C and the delta volume twice (nd = 8)
  nat[:bh:bw]     wta_packed, native reductions (redux.sync) and masked-sum
                  extraction, bh x bw pixels per block (default 8 x 512)
  2nat[:bh:bw]    the same over the delta volume twice
  bh:bw:dot|bfly  wta_packed with butterfly reductions; dot reads S[best -+ 1]
                  by __shfl_sync, bfly by a butterfly sum

Needs a CUDA device. A variant that fails prints FAIL; the exit code is then
1 (and 2 without a device).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch.ops.cuda import sgm as SK
from stereo_reconstruction_cv_tpu_torch.utils.timing import card, launch_ms

H, W = 2160, 3840
UNIQUENESS, MIN_DISP = 10, 0


def volumes(D: int, device, seed: int = 0):
    """The probe's (Wc, H, D) cost volume and u16 delta volume (as int16 bits)."""
    Wc = W - D
    rng = np.random.default_rng(seed)
    C = torch.from_numpy(rng.integers(0, 20000, (Wc, H, D)).astype(np.int16)).to(device)
    ds = rng.integers(0, 40000, (Wc, H, D)).astype(np.uint16).view(np.int16)
    return C, torch.from_numpy(ds).to(device)


def _tile(parts):
    return (int(parts[1]), int(parts[2])) if len(parts) == 3 else (8, 512)


def variant(name: str):
    """(label, fn(C, ds)) of one variant name; ValueError if it is not one."""
    if name == "shipped":
        return "shipped wta_volume", lambda c, s: SK.wta_volume(c, [s], UNIQUENESS, MIN_DISP)
    if name == "shipped2":
        return "shipped 2ds", lambda c, s: SK.wta_volume(c, [s, s], UNIQUENESS, MIN_DISP)
    parts = name.split(":")
    if parts[0] in ("nat", "2nat") and len(parts) in (1, 3):
        bh, bw = _tile(parts)
        n = 1 if parts[0] == "nat" else 2
        label = f"nat BH{bh} BW{bw}" if n == 1 else f"nat2ds BH{bh} BW{bw}"
        return label, lambda c, s: SK.wta_packed(c, [s] * n, UNIQUENESS, MIN_DISP, bh, bw)
    if len(parts) == 3 and parts[2] in ("dot", "bfly"):
        bh, bw = int(parts[0]), int(parts[1])
        extract = "shuffle" if parts[2] == "dot" else "sum"
        return (f"variant BH{bh} BW{bw} {parts[2]}",
                lambda c, s: SK.wta_packed(c, [s], UNIQUENESS, MIN_DISP, bh, bw,
                                           reduction="butterfly", extract=extract))
    raise ValueError(f"unknown variant {name!r}")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    D = int(args[0]) if args else 128
    which = args[1].split(",") if len(args) > 1 else ["shipped"]
    if not torch.cuda.is_available():
        print("micro_wta: needs a CUDA device (the WTA kernels run only on the card)",
              file=sys.stderr)
        return 2
    C, ds = volumes(D, torch.device("cuda"))
    print(f"{card()}; C and ds {tuple(C.shape)}", flush=True)
    failed = 0
    for w in which:
        try:
            label, fn = variant(w)
            print(f"{label}: {launch_ms(lambda: fn(C, ds), iters=4):.3f} ms", flush=True)
        except Exception as e:  # report every variant, then fail
            print(f"{w}: FAIL {type(e).__name__}: {e}"[:200], flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
