"""Semi-global aggregation + winner-take-all: plain PyTorch and CUDA kernels.

Plain versions of ``stereo_reconstruction_cv_tpu/ops/disparity.py``
(``_sgm_step``, ``_scan_dir`` with the exact scan only, ``sgm_aggregate``,
``wta_disparity``) and the wrappers of ``csrc/sgm.cu``, whose two kernels
replace the TPU kernels of ``ops/pallas/sgm_pallas.py``:

- ``sgm_path_sweep`` (``_sweep_vertical``, ``_sweep_vertical_tiled``,
  ``_sweep_hT``, ``_sweep_horizontal``): one path direction, writing or
  adding its (L - C) deltas onto a u16 volume; with a carry in and out
  (``sgm_path_sweep_carry``, the XLA scan ``parallel/sgm_sharded.py:
  _scan_rows_carry``) a block of rows continues a taller frame, as the
  exact row-sharded SGBM hands each shard's last row on to the next;
- ``sgm_sweep_wta`` (``_sweep_hT_wta``): the last direction, FUSED_DIR, with
  WTA fused, so the aggregated volume S never reaches device memory;
- ``sgm_sweep_sum`` (the S assembly of ``sgm_aggregate_pallas``): the last
  direction with S = nd*C + the delta volumes + its deltas stored, int32.

``sgm_wta`` (``sgm_wta_pallas``: path sweeps + ``sgm_sweep_wta``) and
``sgm_aggregate`` (``sgm_aggregate_pallas``, the full S volume: path sweeps +
``sgm_sweep_sum``) dispatch on the device of the cost volume: CPU takes the
plain version, CUDA launches the kernels (or raises). Delta volumes hold u16
bits in int16-typed tensors; ``u16`` widens them. At zero paths (block
matching, ``num_directions=0``) ``sgm_wta`` sweeps nothing: S = C, and its
WTA is ``wta_volume`` with no delta volume.

The standalone WTA pass is the wrapper of ``csrc/wta.cu``:

- ``wta_volume`` (``_wta_volume``): the four maps of
  wta_maps(nd*C + the delta volumes), nd = 5 for one volume and 8 for two;
  ``sgm_sweep_wta(C, vols)`` equals it once the last direction has been
  accumulated onto one of the volumes. With no volume, nd = 1: S = C, block
  matching's WTA (the reference's ``wta_disparity(C)``), read straight from
  the int16 volume (no int32 copy of C);
- ``wta_packed`` (``tools/micro_wta.py``'s ``wta_nat`` and ``wta_variant``):
  the same maps packed into (A, B, 8) f32, with the probes' tile and
  reduction knobs, which change no bit of the output.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from stereo_reconstruction_cv_tpu_torch import _build

# Path steps r = (dx, dy); the predecessor of p is p - r. 5 = OpenCV's
# MODE_SGBM {L, R, UL, U, UR}; 8 = all eight paths; 0 = none, block
# matching (StereoBM's WTA over the cost volume).
DIRS_5 = ((1, 0), (-1, 0), (1, 1), (0, 1), (-1, 1))
DIRS_8 = ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1))
# The direction that runs last, fused with WTA. S is a sum of integers, so
# any direction gives the same maps. FUSED_DIR is the one of
# FUSED_CANDIDATES (in both DIRS_5 and DIRS_8) with the smaller time of
# path sweeps + fused sweep over configs 2 and 3 on the card (chip_smoke.py,
# tools/probe_sweep.py; PERF.md, PR 5).
FUSED_CANDIDATES = ((-1, 0), (0, 1))
FUSED_DIR = (0, 1)

_BIG = 1 << 29

# Kernel launches by this module's wrappers: read by the tests, chip_smoke.py
# (which resets them) and utils/timing.graph_ms (which adds a graph's replays).
launches = {"sgm_path_sweep": 0, "sgm_path_sweep_carry": 0, "sgm_sweep_wta": 0,
            "sgm_sweep_sum": 0, "wta_volume": 0, "wta_packed": 0}


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
    return scan_rows_carry(C, dx, dy, p1, p2)[0]


def scan_rows_carry(C: torch.Tensor, dx: int, dy: int, p1: int, p2: int,
                    carry: torch.Tensor | None = None):
    """One direction with dy != 0 over a block of rows that continues a
    taller frame (``parallel/sgm_sharded.py:_scan_rows_carry``): carry (W, D)
    is L of the row before the block's first row in path order (None: a
    true image edge, where the zero carry makes L = C). The diagonal's
    column shift applies to the carry as between any two rows. C (h, W, D)
    int32 -> (L volume, L of the block's last row in path order)."""
    vol = C if dy > 0 else C.flip(0)
    out = torch.empty_like(vol)
    prev = torch.zeros_like(vol[0]) if carry is None else carry.to(vol.dtype)
    for y in range(vol.shape[0]):
        prev = _sgm_step(_shift_cols(prev, dx) if dx else prev, vol[y], p1, p2)
        out[y] = prev
    return (out if dy > 0 else out.flip(0)), prev


def sgm_aggregate_plain(C: torch.Tensor, p1: int, p2: int,
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


def path_delta_carry_plain(C: torch.Tensor, dx: int, dy: int, p1: int, p2: int,
                           carry: torch.Tensor | None = None):
    """What sgm_path_sweep computes with a carry: (the direction's (L - C)
    int32, lam = L - min_d L of the block's last row in path order). The
    deltas do not depend on a constant added to the carry, so L and lam
    carries give the same."""
    C = C.to(torch.int32)
    L, last = scan_rows_carry(C, dx, dy, p1, p2, carry)
    return L - C, last - last.amin(-1, keepdim=True)


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


def sweep_sum_plain(C, partial, nd: int, p1: int, p2: int,
                    direction: Tuple[int, int] = FUSED_DIR) -> torch.Tensor:
    """What sgm_sweep_sum computes: S = nd*C + partial + the last direction's
    deltas, (H, W, D) int32. partial: int32 sum of the other deltas."""
    C = C.to(torch.int32)
    return nd * C + partial.to(torch.int32) + path_delta_plain(C, *direction, p1, p2)


def sweep_wta_plain(C, partial, nd: int, p1: int, p2: int, uniqueness_ratio: int,
                    min_disp: int, direction: Tuple[int, int] = FUSED_DIR):
    """What sgm_sweep_wta computes: sweep_sum_plain's S reduced by wta_maps."""
    return wta_maps(sweep_sum_plain(C, partial, nd, p1, p2, direction), min_disp,
                    uniqueness_ratio)


def sgm_wta_plain(C, p1: int, p2: int, num_directions: int = 8,
                  uniqueness_ratio: int = 10, min_disp: int = 0):
    """wta_maps(sgm_aggregate(C)) -> (disp, valid, best, minS)."""
    S = sgm_aggregate_plain(C, p1, p2, directions_for(num_directions))
    return wta_maps(S, min_disp, uniqueness_ratio)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def directions_for(num_directions: int):
    if num_directions == 0:
        return ()
    if num_directions == 5:
        return DIRS_5
    if num_directions == 8:
        return DIRS_8
    raise ValueError(f"num_directions must be 0 (block matching), 5 or 8, got {num_directions}")


def delta_groups(num_directions: int, fused: Tuple[int, int] = FUSED_DIR):
    """Directions swept into u16 volume A (at most 4) and B (the rest), in
    order; `fused` is left for the WTA sweep."""
    if fused not in directions_for(num_directions):
        raise ValueError(f"fused direction {fused} is not one of the {num_directions} paths")
    rest = [d for d in directions_for(num_directions) if d != fused]
    return rest[:4], rest[4:]


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def check_sgm_bounds(p1: int, p2: int, num_disp: int, num_directions: int) -> None:
    """Raise where a config would overflow the kernels' integer widths. At
    zero paths S = C, and P1, P2 are unused."""
    directions_for(num_directions)
    if num_directions:
        check_delta_bounds(p1, p2, num_disp)
        max_s = num_directions * (0x7FFF + p2)
    else:
        check_disparities(num_disp)
        max_s = 0x7FFF
    if (max_s + 1) * _pow2_at_least(num_disp) > 0x7FFFFFFF:
        raise ValueError("the packed WTA key S*Dp + d would overflow int32")


def check_delta_bounds(p1: int, p2: int, num_disp: int) -> None:
    """Raise where the path sweeps' u16 delta volumes would overflow."""
    if p1 < 0 or p2 < 0:
        raise ValueError(f"P1={p1} and P2={p2} must be >= 0")
    if 4 * p2 > 0xFFFF:
        raise ValueError(
            f"P2={p2}: a u16 delta volume holds up to 4 directions of <= P2 each, "
            f"4*P2 = {4 * p2} > 65535"
        )
    check_disparities(num_disp)


def check_disparities(num_disp: int) -> None:
    if not 1 <= num_disp <= 512:
        raise ValueError(f"num_disp={num_disp} outside [1, 512]")


def u16(vol: torch.Tensor) -> torch.Tensor:
    """u16 bits stored in an int16 tensor -> int32 values."""
    return vol.to(torch.int32) & 0xFFFF


def _require_cuda_cost(what: str, C: torch.Tensor) -> torch.device:
    dev = _build.cuda_device(what, C)
    if C.dtype != torch.int16 or C.dim() != 3 or not C.is_contiguous():
        raise ValueError("C must be a contiguous (H, W, D) int16 CUDA tensor")
    return dev


def _check_deltas(C: torch.Tensor, vols: Sequence[torch.Tensor]) -> None:
    """Raise unless every u16 delta volume is laid out as C is for the
    kernels, which the plain versions require too."""
    for v in vols:
        if (v.shape != C.shape or v.dtype != torch.int16 or v.device != C.device
                or not v.is_contiguous()):
            raise ValueError("delta volumes must be contiguous int16 tensors of C's shape "
                             "and device")


def lanes_k(num_disp: int) -> int:
    """Disparities per lane of a path-sweep warp: the smallest power of two
    K with 32*K >= D (csrc/sgm.cu lanes_k)."""
    return max(1, _pow2_at_least(-(-num_disp // 32)))


def sweep_vector_path(num_disp: int, *ptrs: int) -> bool:
    """Whether a sweep kernel (the path sweep over C and its volume, the
    fused sweep + WTA over C and every delta volume) moves each lane's K
    disparities as one access of 2K bytes: D % K == 0 and every pointer
    aligned to min(2K, 16) bytes. Otherwise the same kernel takes K scalar
    accesses."""
    k = lanes_k(num_disp)
    align = min(2 * k, 16)
    return num_disp % k == 0 and all(p % align == 0 for p in ptrs)


def _check_carries(C: torch.Tensor, dy: int, *carries) -> None:
    if dy == 0:
        raise ValueError("a carry continues rows: horizontal directions (dy = 0) take none")
    H, W, D = C.shape
    for c in carries:
        if c is not None and (c.shape != (W, D) or c.dtype != torch.int32
                              or c.device != C.device or not c.is_contiguous()):
            raise ValueError(f"carries must be contiguous ({W}, {D}) int32 tensors on {C.device}")


def path_sweep_cuda(C: torch.Tensor, acc: torch.Tensor, dx: int, dy: int,
                    p1: int, p2: int, accumulate: bool,
                    carry_in: torch.Tensor | None = None,
                    carry_out: torch.Tensor | None = None) -> None:
    """Kernel: one direction's deltas written (or added) onto acc in place.
    With a carry (dy != 0; csrc/sgm.cu path_sweep_kernel's CARRY instance)
    the rows continue a taller frame: carry_in (W, D) int32 is L (or lam) of
    the row before the first, carry_out receives lam of the last row, both
    in path order; it counts as sgm_path_sweep_carry."""
    dev = _require_cuda_cost("sgm_path_sweep", C)
    if acc.shape != C.shape or acc.dtype != torch.int16 or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous int16 tensor of C's shape")
    carried = carry_in is not None or carry_out is not None
    if carried:
        _check_carries(C, dy, carry_in, carry_out)
    H, W, D = C.shape
    vec = sweep_vector_path(D, C.data_ptr(), acc.data_ptr())
    _build.launch("srcv_sgm_path_sweep", dev, C.data_ptr(), acc.data_ptr(),
                  None if carry_in is None else carry_in.data_ptr(),
                  None if carry_out is None else carry_out.data_ptr(), H, W, D, dx, dy, p1, p2,
                  int(accumulate), int(vec),
                  counts=(launches, "sgm_path_sweep_carry" if carried else "sgm_path_sweep"))


def path_sweep(C: torch.Tensor, acc: torch.Tensor, dx: int, dy: int, p1: int, p2: int,
               accumulate: bool, carry_in: torch.Tensor | None = None,
               carry_out: torch.Tensor | None = None) -> None:
    """path_sweep_cuda on a CUDA tensor, its plain version on the CPU: acc
    (u16 bits in int16) gets the direction's deltas written or added (mod
    2^16), carry_out the last row's lam."""
    if C.device.type != "cpu":
        path_sweep_cuda(C, acc, dx, dy, p1, p2, accumulate, carry_in, carry_out)
        return
    if carry_in is not None or carry_out is not None:
        _check_carries(C, dy, carry_in, carry_out)
        delta, lam = path_delta_carry_plain(C, dx, dy, p1, p2, carry_in)
        if carry_out is not None:
            carry_out.copy_(lam)
    else:
        delta = path_delta_plain(C, dx, dy, p1, p2)
    if accumulate:
        delta = delta + u16(acc)
    acc.copy_((delta & 0xFFFF).to(torch.int16))


def _sweep_group(C: torch.Tensor, acc: torch.Tensor, group, p1: int, p2: int) -> None:
    """Kernels: acc = the u16 sum of the deltas of `group` (at most 4 directions)."""
    for i, (dx, dy) in enumerate(group):
        path_sweep_cuda(C, acc, dx, dy, p1, p2, accumulate=i > 0)


def path_deltas_cuda(C: torch.Tensor, num_directions: int, p1: int, p2: int,
                     fused: Tuple[int, int] = FUSED_DIR):
    """Kernels: every direction but `fused`, swept group by group
    (delta_groups) into one or two u16 delta volumes."""
    vols = []
    for group in delta_groups(num_directions, fused):
        if group:
            vols.append(torch.empty_like(C))
            _sweep_group(C, vols[-1], group, p1, p2)
    return vols


# Directions one sgm_sweep_sum covers: two u16 volumes of four, and its own.
SUM_PASS = 9


def aggregate_passes(directions: Sequence[Tuple[int, int]]):
    """How sgm_aggregate_cuda covers a direction list: one sgm_sweep_sum pass
    per SUM_PASS entries, each (fused, groups). The fused direction is
    FUSED_DIR where the pass holds it, else its last entry; the others, in
    order, fill at most two u16 groups of at most four. Duplicates stay, so
    they are summed."""
    passes = []
    for i in range(0, len(directions), SUM_PASS):
        rest = list(directions[i:i + SUM_PASS])
        fused = FUSED_DIR if FUSED_DIR in rest else rest[-1]
        rest.remove(fused)
        passes.append((fused, [g for g in (rest[:4], rest[4:]) if g]))
    return passes


def sweep_sum_cuda(C: torch.Tensor, vols: Sequence[torch.Tensor], nd: int, p1: int, p2: int,
                   direction: Tuple[int, int] = FUSED_DIR,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel: the last direction's sweep storing S = nd*C + sum(vols) + its
    deltas, (H, W, D) int32, in a new tensor or added onto `out`. vols: zero,
    one or two u16 delta volumes."""
    dev = _require_cuda_cost("sgm_sweep_sum", C)
    if len(vols) > 2:
        raise ValueError(f"sweep_sum_cuda takes at most two delta volumes, got {len(vols)}")
    if tuple(direction) not in DIRS_8:
        raise ValueError(f"direction must be a unit step (a member of DIRS_8), got {direction}")
    _check_deltas(C, vols)
    if out is None:
        S = torch.empty(C.shape, dtype=torch.int32, device=dev)
    elif out.shape != C.shape or out.dtype != torch.int32 or not out.is_contiguous():
        raise ValueError("out must be a contiguous int32 tensor of C's shape")
    else:
        S = out
    H, W, D = C.shape
    align_s = min(4 * lanes_k(D), 16)
    vec = (sweep_vector_path(D, *(t.data_ptr() for t in (C, *vols)))
           and S.data_ptr() % align_s == 0)
    ptrs = [v.data_ptr() for v in vols] + [None] * (2 - len(vols))
    _build.launch("srcv_sgm_sweep_sum", dev, C.data_ptr(), *ptrs, S.data_ptr(), H, W, D,
                  direction[0], direction[1], nd, p1, p2, int(out is not None), int(vec),
                  counts=(launches, "sgm_sweep_sum"))
    return S


def sgm_aggregate_cuda(C: torch.Tensor, p1: int, p2: int,
                       directions: Sequence[Tuple[int, int]] = DIRS_8) -> torch.Tensor:
    """Kernels: S = len(directions)*C + the deltas of every direction ->
    (H, W, D) int32. Each pass of aggregate_passes sweeps its groups into
    u16 volumes, then sgm_sweep_sum sweeps its fused direction and writes S
    (the first pass) or adds onto it. 8 paths: 7 path sweeps + 1."""
    _require_cuda_cost("sgm_aggregate", C)
    directions = list(directions)
    if not directions:
        return torch.zeros(C.shape, dtype=torch.int32, device=C.device)
    S, vols = None, []
    for fused, groups in aggregate_passes(directions):
        while len(vols) < len(groups):
            vols.append(torch.empty_like(C))
        for vol, group in zip(vols, groups):
            _sweep_group(C, vol, group, p1, p2)
        S = sweep_sum_cuda(C, vols[:len(groups)], 1 + sum(map(len, groups)), p1, p2, fused,
                           out=S)
    return S


def sgm_aggregate(C: torch.Tensor, p1: int, p2: int,
                  directions: Sequence[Tuple[int, int]] = DIRS_8) -> torch.Tensor:
    """The aggregated volume S (H, W, D) int32: kernels on a CUDA tensor
    (int16, contiguous), plain on the CPU. Both take the same inputs: unit
    path steps (members of DIRS_8) and P1, P2, D within the u16 bounds."""
    check_delta_bounds(p1, p2, C.shape[2])
    directions = list(directions)
    if not set(directions) <= set(DIRS_8):
        raise ValueError(f"directions must be unit steps (members of DIRS_8), got {directions}")
    if C.device.type == "cpu":
        return sgm_aggregate_plain(C, p1, p2, directions)
    return sgm_aggregate_cuda(C, p1, p2, directions)


def sweep_wta_cuda(C: torch.Tensor, vols: Sequence[torch.Tensor],
                   nd: int, p1: int, p2: int, uniqueness_ratio: int, min_disp: int,
                   direction: Tuple[int, int] = FUSED_DIR):
    """Kernel: the last direction's sweep fused with WTA over
    S = nd*C + sum(vols) + its deltas -> (disp, valid, best, minS).
    vols: the one or two u16 delta volumes of path_deltas_cuda."""
    dev = _require_cuda_cost("sgm_sweep_wta", C)
    if not 1 <= len(vols) <= 2:
        raise ValueError(f"sweep_wta_cuda takes one or two delta volumes, got {len(vols)}")
    if tuple(direction) not in DIRS_8:
        raise ValueError(f"direction must be a unit step (a member of DIRS_8), got {direction}")
    _check_deltas(C, vols)
    dsa, dsb = vols[0], (vols[1] if len(vols) > 1 else None)
    H, W, D = C.shape
    vec = sweep_vector_path(D, *(t.data_ptr() for t in (C, *vols)))
    disp = torch.empty((H, W), dtype=torch.float32, device=dev)
    valid = torch.empty((H, W), dtype=torch.bool, device=dev)
    best = torch.empty((H, W), dtype=torch.int32, device=dev)
    minS = torch.empty((H, W), dtype=torch.int32, device=dev)
    lg = _pow2_at_least(D).bit_length() - 1
    _build.launch("srcv_sgm_sweep_wta", dev, C.data_ptr(), dsa.data_ptr(),
                  None if dsb is None else dsb.data_ptr(), disp.data_ptr(), valid.data_ptr(),
                  best.data_ptr(), minS.data_ptr(), H, W, D, direction[0], direction[1], nd,
                  p1, p2, uniqueness_ratio, min_disp, lg, int(vec),
                  counts=(launches, "sgm_sweep_wta"))
    return disp, valid, best, minS


def sweep_wta(C: torch.Tensor, vols: Sequence[torch.Tensor], nd: int, p1: int, p2: int,
              uniqueness_ratio: int, min_disp: int, direction: Tuple[int, int] = FUSED_DIR):
    """sweep_wta_cuda on a CUDA tensor, sweep_wta_plain over the u16
    volumes' sum on the CPU -> (disp, valid, best, minS)."""
    if C.device.type != "cpu":
        return sweep_wta_cuda(C, vols, nd, p1, p2, uniqueness_ratio, min_disp, direction)
    partial = sum(u16(v) for v in vols)
    return sweep_wta_plain(C, partial, nd, p1, p2, uniqueness_ratio, min_disp, direction)


def sgm_wta(C: torch.Tensor, p1: int, p2: int, num_directions: int = 8,
            uniqueness_ratio: int = 10, min_disp: int = 0):
    """All SGM paths + WTA on the cropped cost volume C (H, Wc, D); at zero
    paths the WTA over C alone (wta_volume with no delta volume: one launch
    on the card, wta_maps(C widened) on the CPU).

    Returns (disp f32, valid bool, best i32, minS i32), each (H, Wc)."""
    H, W, D = C.shape
    check_sgm_bounds(p1, p2, D, num_directions)
    if num_directions == 0:
        return wta_volume(C, (), uniqueness_ratio, min_disp)
    if C.device.type == "cpu":
        return sgm_wta_plain(C, p1, p2, num_directions, uniqueness_ratio, min_disp)
    _require_cuda_cost("sgm_wta", C)
    vols = path_deltas_cuda(C, num_directions, p1, p2)
    return sweep_wta_cuda(C, vols, num_directions, p1, p2, uniqueness_ratio, min_disp)


# ---------------------------------------------------------------------------
# The standalone WTA pass (csrc/wta.cu)
# ---------------------------------------------------------------------------

REDUCTIONS = ("native", "butterfly")  # redux.sync, or an __shfl_xor_sync butterfly
EXTRACTS = ("sum", "shuffle")         # S[best -+ 1] by masked warp sum, or by __shfl_sync


# S = nd*C + the delta volumes: nd by the number of volumes (the reference's
# rule for 5 and 8 paths; none is block matching, S = C).
ND_OF_VOLUMES = (1, 5, 8)


def _check_wta_inputs(C: torch.Tensor, vols: Sequence[torch.Tensor],
                      uniqueness_ratio: int) -> int:
    """Raise on inputs the WTA pass does not take; -> nd (1, 5 or 8)."""
    if C.dtype != torch.int16 or C.dim() != 3:
        raise ValueError("C must be an (A, B, D) int16 tensor")
    if not 1 <= C.shape[2] <= 512:
        raise ValueError(f"D={C.shape[2]} outside [1, 512]")
    if len(vols) > 2:
        raise ValueError(f"the WTA pass takes at most two delta volumes, got {len(vols)}")
    _check_deltas(C, vols)
    if not 0 <= uniqueness_ratio <= 100:
        raise ValueError(f"uniqueness_ratio={uniqueness_ratio} outside [0, 100]")
    return ND_OF_VOLUMES[len(vols)]


def wta_volume_plain(C: torch.Tensor, vols: Sequence[torch.Tensor],
                     uniqueness_ratio: int, min_disp: int):
    """wta_maps(nd*C + sum of the u16 volumes) -> (disp, valid, best, minS)."""
    nd = ND_OF_VOLUMES[len(vols)]
    S = nd * C.to(torch.int32)
    for v in vols:
        S += u16(v)
    return wta_maps(S, min_disp, uniqueness_ratio)


def pack_maps(disp, valid, best, minS) -> torch.Tensor:
    """(A, B) maps -> (A, B, 8) f32: disp, 1 - bad, best, minS, then zeros."""
    out = torch.zeros(disp.shape + (8,), dtype=torch.float32, device=disp.device)
    for i, m in enumerate((disp, valid, best, minS)):
        out[..., i] = m.to(torch.float32)
    return out


def wta_packed_plain(C: torch.Tensor, vols: Sequence[torch.Tensor],
                     uniqueness_ratio: int, min_disp: int) -> torch.Tensor:
    """wta_volume_plain's maps packed into (A, B, 8) f32."""
    return pack_maps(*wta_volume_plain(C, vols, uniqueness_ratio, min_disp))


def _launch_wta(C, vols, nd, uniqueness_ratio, min_disp, bh, bw, bfly, shfl, outs):
    dev = _build.cuda_device("wta", C)
    if not C.is_contiguous():
        raise ValueError("C must be contiguous")
    A, B, D = C.shape
    dsa, dsb = ([v.data_ptr() for v in vols] + [None, None])[:2]
    ptrs = [None if t is None else t.data_ptr() for t in outs]
    _build.launch("srcv_wta", dev, C.data_ptr(), dsa, dsb, A, B, D, nd,
                  uniqueness_ratio, min_disp, _pow2_at_least(D).bit_length() - 1, bh, bw,
                  int(bfly), int(shfl), *ptrs)


def wta_volume(C: torch.Tensor, vols: Sequence[torch.Tensor],
               uniqueness_ratio: int = 10, min_disp: int = 0):
    """Winner-take-all over S = nd*C + the zero, one or two u16 delta
    volumes (nd = 1, 5 or 8), pixel by pixel: C (A, B, D) int16 in any
    layout of the pixels -> (disp f32, valid bool, best i32, minS i32), each
    (A, B). The kernel on a CUDA tensor (with no volume its own form, which
    reads C alone), the plain version on the CPU."""
    nd = _check_wta_inputs(C, vols, uniqueness_ratio)
    if C.device.type == "cpu":
        return wta_volume_plain(C, vols, uniqueness_ratio, min_disp)
    A, B, _ = C.shape
    disp = torch.empty((A, B), dtype=torch.float32, device=C.device)
    valid = torch.empty((A, B), dtype=torch.bool, device=C.device)
    best = torch.empty((A, B), dtype=torch.int32, device=C.device)
    minS = torch.empty((A, B), dtype=torch.int32, device=C.device)
    _launch_wta(C, vols, nd, uniqueness_ratio, min_disp, 1, 64, False, False,
                (disp, valid, best, minS, None))
    _build.count(launches, "wta_volume")
    return disp, valid, best, minS


def wta_packed(C: torch.Tensor, vols: Sequence[torch.Tensor],
               uniqueness_ratio: int = 10, min_disp: int = 0, bh: int = 8, bw: int = 512,
               reduction: str = "native", extract: str = "sum") -> torch.Tensor:
    """wta_volume's maps packed into (A, B, 8) f32 (disp, 1 - bad, best,
    minS, zeros), as the probes of tools/micro_wta.py write them. One thread
    block takes a tile of bh x bw pixels; `reduction` and `extract` pick the
    warp reduction and the S[best -+ 1] read (REDUCTIONS, EXTRACTS). Neither
    the tile nor the knobs change a bit of the output. Takes one or two
    delta volumes (the probes' forms)."""
    nd = _check_wta_inputs(C, vols, uniqueness_ratio)
    if not vols:
        raise ValueError("wta_packed takes one or two delta volumes; wta_volume takes none")
    if reduction not in REDUCTIONS or extract not in EXTRACTS:
        raise ValueError(f"reduction in {REDUCTIONS}, extract in {EXTRACTS}; "
                         f"got {reduction!r}, {extract!r}")
    if bh < 1 or bw < 1:
        raise ValueError(f"tile {bh}x{bw} must be at least 1x1")
    if C.device.type == "cpu":
        return wta_packed_plain(C, vols, uniqueness_ratio, min_disp)
    out = torch.empty(C.shape[:2] + (8,), dtype=torch.float32, device=C.device)
    _launch_wta(C, vols, nd, uniqueness_ratio, min_disp, bh, bw,
                reduction == "butterfly", extract == "shuffle", (None,) * 4 + (out,))
    _build.count(launches, "wta_packed")
    return out
