"""Semi-global aggregation + winner-take-all: plain PyTorch and CUDA kernels.

Plain versions of ``stereo_reconstruction_cv_tpu/ops/disparity.py``
(``_sgm_step``, ``_scan_dir`` with the exact scan only, ``sgm_aggregate``,
``wta_disparity``) and the wrappers of ``csrc/sgm.cu``, whose two kernels
replace the TPU kernels that ``ops/pallas/sgm_pallas.py:sgm_wta_pallas``
chains:

- ``sgm_path_sweep`` (``_sweep_vertical``, ``_sweep_vertical_tiled``,
  ``_sweep_hT``): one path direction, writing or adding its (L - C) deltas
  onto a u16 volume;
- ``sgm_sweep_wta`` (``_sweep_hT_wta``): the reverse horizontal path with WTA
  fused, so the aggregated volume S never reaches device memory.

``sgm_wta`` dispatches on the device of the cost volume: CPU takes the plain
version, CUDA launches the kernels (or raises). Delta volumes hold u16 bits in
int16-typed tensors; ``u16`` widens them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from stereo_reconstruction_cv_tpu_torch import _build

# Path steps r = (dx, dy); the predecessor of p is p - r. 5 = OpenCV's
# MODE_SGBM {L, R, UL, U, UR}; 8 = all eight paths.
DIRS_5 = ((1, 0), (-1, 0), (1, 1), (0, 1), (-1, 1))
DIRS_8 = ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1))
# The reverse horizontal path runs last, fused with WTA.
FUSED_DIR = (-1, 0)

_BIG = 1 << 29

# Kernel launches by this module's wrappers (read and reset by chip_smoke.py).
launches = {"sgm_path_sweep": 0, "sgm_sweep_wta": 0}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _sgm_step(prev: torch.Tensor, cost: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """L = C + min(Lp[d], Lp[d-1] + P1, Lp[d+1] + P1, min Lp + P2) - min Lp,
    with no phantom neighbour at d = 0 or d = D - 1."""
    pad = torch.full_like(prev[..., :1], _BIG)
    up = torch.cat([prev[..., 1:], pad], -1)
    dn = torch.cat([pad, prev[..., :-1]], -1)
    min_prev = prev.amin(-1, keepdim=True)
    best = torch.minimum(torch.minimum(prev, min_prev + p2), torch.minimum(up, dn) + p1)
    return cost + best - min_prev


def _shift_cols(a: torch.Tensor, dx: int) -> torch.Tensor:
    """out[x] = a[x - dx] along axis -2, zero where x - dx leaves the image."""
    z = torch.zeros_like(a[..., :1, :])
    if dx > 0:
        return torch.cat([z, a[..., :-1, :]], -2)
    return torch.cat([a[..., 1:, :], z], -2)


def _scan_dir(C: torch.Tensor, dx: int, dy: int, p1: int, p2: int) -> torch.Tensor:
    """Exact aggregation L along one direction r = (dx, dy). C (H, W, D) int32.
    A zero carry makes every path start reduce to L = C."""
    if dy == 0:
        vol = C if dx > 0 else C.flip(1)
        out = torch.empty_like(vol)
        prev = torch.zeros_like(vol[:, 0])
        for x in range(vol.shape[1]):
            prev = _sgm_step(prev, vol[:, x], p1, p2)
            out[:, x] = prev
        return out if dx > 0 else out.flip(1)
    vol = C if dy > 0 else C.flip(0)
    out = torch.empty_like(vol)
    prev = torch.zeros_like(vol[0])
    for y in range(vol.shape[0]):
        prev = _sgm_step(_shift_cols(prev, dx) if dx else prev, vol[y], p1, p2)
        out[y] = prev
    return out if dy > 0 else out.flip(0)


def sgm_aggregate(C: torch.Tensor, p1: int, p2: int,
                  directions: Sequence[Tuple[int, int]] = DIRS_8) -> torch.Tensor:
    """Sum of per-direction aggregations. (H, W, D) -> (H, W, D) int32."""
    C = C.to(torch.int32)
    S = torch.zeros_like(C)
    for dx, dy in directions:
        S += _scan_dir(C, dx, dy, p1, p2)
    return S


def path_delta_plain(C: torch.Tensor, dx: int, dy: int, p1: int, p2: int) -> torch.Tensor:
    """One direction's (L - C), int32: what sgm_path_sweep adds to its volume."""
    C = C.to(torch.int32)
    return _scan_dir(C, dx, dy, p1, p2) - C


def wta_maps(S: torch.Tensor, min_disp: int, uniqueness_ratio: int):
    """Winner-take-all with OpenCV's uniqueness test and parabolic subpixel.
    S (..., D) int32 -> (disp f32, valid bool, best i32, minS i32)."""
    D = S.shape[-1]
    best = torch.argmin(S, dim=-1)  # first index on ties, as jnp.argmin
    minS = S.gather(-1, best[..., None])[..., 0]
    d_idx = torch.arange(D, device=S.device)
    far = (d_idx - best[..., None]).abs() > 1
    close = (S * (100 - uniqueness_ratio) < minS[..., None] * 100) & far
    valid = ~close.any(-1)
    Sm1 = S.gather(-1, torch.clamp(best - 1, 0, D - 1)[..., None])[..., 0]
    Sp1 = S.gather(-1, torch.clamp(best + 1, 0, D - 1)[..., None])[..., 0]
    denom = torch.clamp(Sm1 + Sp1 - 2 * minS, min=1).to(torch.float32)
    frac = (Sm1 - Sp1).to(torch.float32) / (2.0 * denom)
    interior = (best > 0) & (best < D - 1)
    disp = best.to(torch.float32) + torch.where(interior, frac, torch.zeros_like(frac))
    disp = disp + float(min_disp)
    return disp, valid, best.to(torch.int32), minS.to(torch.int32)


def wta_disparity(S: torch.Tensor, min_disp: int, uniqueness_ratio: int):
    """(disp incl. min_disp, valid) from the aggregated volume."""
    return wta_maps(S, min_disp, uniqueness_ratio)[:2]


def sweep_wta_plain(C, partial, nd: int, p1: int, p2: int, uniqueness_ratio: int,
                    min_disp: int, direction: Tuple[int, int] = FUSED_DIR):
    """What sgm_sweep_wta computes: S = nd*C + partial + the last direction's
    deltas, reduced by wta_maps. partial: int32 sum of the other deltas."""
    C = C.to(torch.int32)
    S = nd * C + partial.to(torch.int32) + path_delta_plain(C, *direction, p1, p2)
    return wta_maps(S, min_disp, uniqueness_ratio)


def sgm_wta_plain(C, p1: int, p2: int, num_directions: int = 8,
                  uniqueness_ratio: int = 10, min_disp: int = 0):
    """wta_maps(sgm_aggregate(C)) -> (disp, valid, best, minS)."""
    S = sgm_aggregate(C, p1, p2, directions_for(num_directions))
    return wta_maps(S, min_disp, uniqueness_ratio)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def directions_for(num_directions: int):
    if num_directions == 5:
        return DIRS_5
    if num_directions == 8:
        return DIRS_8
    raise ValueError(f"num_directions must be 5 or 8, got {num_directions}")


def delta_groups(num_directions: int):
    """Directions swept into u16 volume A (at most 4) and B (the rest), in
    order; FUSED_DIR is left for the WTA sweep."""
    rest = [d for d in directions_for(num_directions) if d != FUSED_DIR]
    return rest[:4], rest[4:]


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def check_sgm_bounds(p1: int, p2: int, num_disp: int, num_directions: int) -> None:
    """Raise where a config would overflow the kernels' integer widths."""
    directions_for(num_directions)
    if p1 < 0 or p2 < 0:
        raise ValueError(f"P1={p1} and P2={p2} must be >= 0")
    if 4 * p2 > 0xFFFF:
        raise ValueError(
            f"P2={p2}: a u16 delta volume holds up to 4 directions of <= P2 each, "
            f"4*P2 = {4 * p2} > 65535"
        )
    if not 1 <= num_disp <= 512:
        raise ValueError(f"num_disp={num_disp} outside [1, 512]")
    max_s = num_directions * (0x7FFF + p2)
    if (max_s + 1) * _pow2_at_least(num_disp) > 0x7FFFFFFF:
        raise ValueError("the packed WTA key S*Dp + d would overflow int32")


def u16(vol: torch.Tensor) -> torch.Tensor:
    """u16 bits stored in an int16 tensor -> int32 values."""
    return vol.to(torch.int32) & 0xFFFF


def _require_cuda_cost(C: torch.Tensor) -> None:
    if C.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {C.device} tensor")
    if C.dtype != torch.int16 or C.dim() != 3 or not C.is_contiguous():
        raise ValueError("C must be a contiguous (H, W, D) int16 CUDA tensor")


def path_sweep_cuda(C: torch.Tensor, acc: torch.Tensor, dx: int, dy: int,
                    p1: int, p2: int, accumulate: bool) -> None:
    """Kernel: one direction's deltas written (or added) onto acc in place."""
    _require_cuda_cost(C)
    if acc.shape != C.shape or acc.dtype != torch.int16 or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous int16 tensor of C's shape")
    H, W, D = C.shape
    lib = _build.kernels_library()
    with torch.cuda.device(C.device):
        err = lib.srcv_sgm_path_sweep(
            C.data_ptr(), acc.data_ptr(), H, W, D, dx, dy, p1, p2, int(accumulate),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "sgm_path_sweep")
    launches["sgm_path_sweep"] += 1


def path_deltas_cuda(C: torch.Tensor, num_directions: int, p1: int, p2: int):
    """Kernels: every direction but FUSED_DIR, swept group by group
    (delta_groups) into one or two u16 delta volumes."""
    vols = []
    for group in delta_groups(num_directions):
        if not group:
            continue
        acc = torch.empty_like(C)
        for i, (dx, dy) in enumerate(group):
            path_sweep_cuda(C, acc, dx, dy, p1, p2, accumulate=i > 0)
        vols.append(acc)
    return vols


def sweep_wta_cuda(C: torch.Tensor, vols: Sequence[torch.Tensor],
                   nd: int, p1: int, p2: int, uniqueness_ratio: int, min_disp: int,
                   direction: Tuple[int, int] = FUSED_DIR):
    """Kernel: the last direction's sweep fused with WTA over
    S = nd*C + sum(vols) + its deltas -> (disp, valid, best, minS).
    vols: the one or two u16 delta volumes of path_deltas_cuda."""
    _require_cuda_cost(C)
    if not 1 <= len(vols) <= 2:
        raise ValueError(f"sweep_wta_cuda takes one or two delta volumes, got {len(vols)}")
    for ds in vols:
        if ds.shape != C.shape or ds.dtype != torch.int16 or not ds.is_contiguous():
            raise ValueError("delta volumes must be contiguous int16 tensors of C's shape")
    dsa, dsb = vols[0], (vols[1] if len(vols) > 1 else None)
    H, W, D = C.shape
    dev = C.device
    disp = torch.empty((H, W), dtype=torch.float32, device=dev)
    valid = torch.empty((H, W), dtype=torch.bool, device=dev)
    best = torch.empty((H, W), dtype=torch.int32, device=dev)
    minS = torch.empty((H, W), dtype=torch.int32, device=dev)
    lg = _pow2_at_least(D).bit_length() - 1
    lib = _build.kernels_library()
    with torch.cuda.device(dev):
        err = lib.srcv_sgm_sweep_wta(
            C.data_ptr(), dsa.data_ptr(), None if dsb is None else dsb.data_ptr(),
            disp.data_ptr(), valid.data_ptr(), best.data_ptr(), minS.data_ptr(),
            H, W, D, direction[0], direction[1], nd, p1, p2, uniqueness_ratio,
            min_disp, lg, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "sgm_sweep_wta")
    launches["sgm_sweep_wta"] += 1
    return disp, valid, best, minS


def sgm_wta(C: torch.Tensor, p1: int, p2: int, num_directions: int = 8,
            uniqueness_ratio: int = 10, min_disp: int = 0):
    """All SGM paths + WTA on the cropped cost volume C (H, Wc, D).

    Returns (disp f32, valid bool, best i32, minS i32), each (H, Wc)."""
    H, W, D = C.shape
    check_sgm_bounds(p1, p2, D, num_directions)
    if C.device.type == "cpu":
        return sgm_wta_plain(C, p1, p2, num_directions, uniqueness_ratio, min_disp)
    _require_cuda_cost(C)
    vols = path_deltas_cuda(C, num_directions, p1, p2)
    return sweep_wta_cuda(C, vols, num_directions, p1, p2, uniqueness_ratio, min_disp)
