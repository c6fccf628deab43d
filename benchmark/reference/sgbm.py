"""Plain SGBM in PyTorch: the benchmark's reference for the disparity layer.

cv2.StereoSGBM's semantics as the port states them (a frozen copy of the
arithmetic of its plain versions, rearranged in blocks so that a 4K frame at
256 disparities fits beside nothing else on one card):

- prefilter: clipped horizontal Sobel of both views; the four pixel-cost
  planes (Sobel and raw of each view) have their first and last column
  pinned to pre_filter_cap;
- cost: Birchfield-Tomasi on the Sobel planes plus BT on the raw planes >> 2,
  over the columns x >= min_disparity + num_disparities (x0), summed over a
  block_size square, edge-replicated at that cropped boundary;
- paths: L = C + min(Lp[d], Lp[d +- 1] + P1, min Lp + P2) - min Lp along each
  direction (dx, dy), the predecessor p - (dx, dy), zero outside the image;
  S = sum of L over the directions;
- WTA: argmin over d (first on ties), the uniqueness test, the parabolic
  subpixel from S[d -+ 1];
- LR check (disp12MaxDiff), the left margin padded back as invalid
  (min_disparity - 1);
- speckle: 4-connected components of valid pixels joined where |d(p) - d(q)|
  <= speckle_range, labels flooded to their fixpoint, components of at most
  speckle_window_size pixels dropped.

Imports nothing of the program. Runs on the device of its inputs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

DIRS_5 = ((1, 0), (-1, 0), (1, 1), (0, 1), (-1, 1))
DIRS_8 = ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1))
_BIG = 1 << 29


def directions(num_directions: int) -> Tuple[Tuple[int, int], ...]:
    if num_directions == 5:
        return DIRS_5
    if num_directions == 8:
        return DIRS_8
    raise ValueError(f"num_directions must be 5 or 8, got {num_directions}")


def xsobel_clip(img: torch.Tensor, cap: int) -> torch.Tensor:
    """Clipped horizontal Sobel, replicated border: int32 in [0, 2 cap]."""
    H, W = img.shape
    rows = torch.clamp(torch.arange(-1, H + 1, device=img.device), 0, H - 1)
    cols = torch.clamp(torch.arange(-1, W + 1, device=img.device), 0, W - 1)
    p = img.to(torch.int32)[rows][:, cols]
    dx = ((p[:-2, 2:] - p[:-2, :-2]) + 2 * (p[1:-1, 2:] - p[1:-1, :-2])
          + (p[2:, 2:] - p[2:, :-2]))
    return torch.clamp(dx, -cap, cap) + cap


def _halfpixel_range(v: torch.Tensor):
    """min / max over {v, (v + v_left) // 2, (v + v_right) // 2}, neighbours
    clamped at the plane's edge."""
    vl = torch.cat([v[:, :1], torch.div(v[:, 1:] + v[:, :-1], 2, rounding_mode="floor")], 1)
    vr = torch.cat([torch.div(v[:, 1:] + v[:, :-1], 2, rounding_mode="floor"), v[:, -1:]], 1)
    return (torch.minimum(torch.minimum(vl, vr), v), torch.maximum(torch.maximum(vl, vr), v))


def cost_planes(left: torch.Tensor, right: torch.Tensor, cap: int):
    planes = []
    for p in (xsobel_clip(left, cap), xsobel_clip(right, cap),
              left.to(torch.int32), right.to(torch.int32)):
        p = p.clone()
        p[:, 0] = cap
        p[:, -1] = cap
        planes.append(p)
    return planes


def _bt_rows(lv, llo, lhi, rv, rlo, rhi, xr):
    """BT cost of one plane for a block of rows: left values (h, Wc) at the
    cropped columns, right planes (h, W) gathered at xr (Wc, D) -> (h, Wc, D)."""
    r_v, r_lo, r_hi = (a[:, xr] for a in (rv, rlo, rhi))
    l_v, l_lo, l_hi = (a[:, :, None] for a in (lv, llo, lhi))
    c0 = torch.clamp(torch.maximum(l_v - r_hi, r_lo - l_v), min=0)
    c1 = torch.clamp(torch.maximum(r_v - l_hi, l_lo - r_v), min=0)
    return torch.minimum(c0, c1)


def _box_rows(x: torch.Tensor, n_out: int, block: int) -> torch.Tensor:
    """Sums of `block` consecutive rows (dim 0) of x, which holds n_out +
    block - 1 rows -> n_out rows."""
    cs = torch.cumsum(x, 0)
    cs = torch.cat([torch.zeros_like(cs[:1]), cs])
    return cs[block:block + n_out] - cs[:n_out]


def _box_cols(x: torch.Tensor, block: int) -> torch.Tensor:
    """Sums over a block-wide window of columns (dim 1), edge-replicated."""
    n, r = x.shape[1], block // 2
    idx = torch.clamp(torch.arange(-r - 1, n + r, device=x.device), 0, n - 1)
    cs = torch.cumsum(x.index_select(1, idx), 1)
    return cs[:, block:block + n] - cs[:, :n]


def cost_volume(left, right, num_disp: int, min_disp: int, block: int, cap: int,
                rows: int = 32) -> torch.Tensor:
    """(H, Wc, D) int16 block-summed pixel cost over the columns x >= x0."""
    H, W = left.shape
    x0 = min_disp + num_disp
    Wc = W - x0
    dev = left.device
    sl, sr, rawl, rawr = cost_planes(left, right, cap)
    ranges = [_halfpixel_range(p) for p in (sl, sr, rawl, rawr)]
    x = torch.arange(x0, W, device=dev)[:, None]
    d = torch.arange(num_disp, device=dev)[None, :]
    xr = torch.clamp(x - (min_disp + d), min=0)
    r = block // 2
    out = torch.empty((H, Wc, num_disp), dtype=torch.int16, device=dev)
    for a in range(0, H, rows):
        b = min(a + rows, H)
        ys = torch.clamp(torch.arange(a - r, b + r, device=dev), 0, H - 1)
        (sllo, slhi), (srlo, srhi), (rllo, rlhi), (rrlo, rrhi) = (
            (lo[ys], hi[ys]) for lo, hi in ranges)
        c_sobel = _bt_rows(sl[ys][:, x0:], sllo[:, x0:], slhi[:, x0:],
                           sr[ys], srlo, srhi, xr)
        c_raw = _bt_rows(rawl[ys][:, x0:], rllo[:, x0:], rlhi[:, x0:],
                         rawr[ys], rrlo, rrhi, xr)
        pix = c_sobel + (c_raw >> 2)
        del c_sobel, c_raw
        out[a:b] = _box_cols(_box_rows(pix, b - a, block), block).to(torch.int16)
    return out


def _sgm_step(prev, cost, p1: int, p2: int):
    pad = torch.full_like(prev[..., :1], _BIG)
    up = torch.cat([prev[..., 1:], pad], -1)
    dn = torch.cat([pad, prev[..., :-1]], -1)
    min_prev = prev.amin(-1, keepdim=True)
    best = torch.minimum(torch.minimum(prev, min_prev + p2), torch.minimum(up, dn) + p1)
    return cost + best - min_prev


def _shift_cols(a: torch.Tensor, dx: int) -> torch.Tensor:
    """out[x] = a[x - dx] along dim 0 of (W, D), zero where it leaves."""
    z = torch.zeros_like(a[:1])
    if dx > 0:
        return torch.cat([z, a[:-1]], 0)
    return torch.cat([a[1:], z], 0)


def aggregate(C: torch.Tensor, p1: int, p2: int,
              dirs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """S = sum over dirs of the path costs L, (H, Wc, D) int32, built in
    place one line of the path order at a time."""
    H, Wc, D = C.shape
    S = torch.zeros((H, Wc, D), dtype=torch.int32, device=C.device)
    for dx, dy in dirs:
        if dy == 0:
            prev = torch.zeros((H, D), dtype=torch.int32, device=C.device)
            for x in (range(Wc) if dx > 0 else range(Wc - 1, -1, -1)):
                prev = _sgm_step(prev, C[:, x].to(torch.int32), p1, p2)
                S[:, x] += prev
        else:
            prev = torch.zeros((Wc, D), dtype=torch.int32, device=C.device)
            for y in (range(H) if dy > 0 else range(H - 1, -1, -1)):
                prev = _sgm_step(_shift_cols(prev, dx) if dx else prev,
                                 C[y].to(torch.int32), p1, p2)
                S[y] += prev
    return S


def wta(S: torch.Tensor, min_disp: int, uniqueness: int, rows: int = 64):
    """(disp f32, valid, best i32, minS i32), each (H, Wc), in row blocks."""
    outs = [_wta_block(S[a:a + rows], min_disp, uniqueness) for a in range(0, S.shape[0], rows)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _wta_block(S: torch.Tensor, min_disp: int, uniqueness: int):
    D = S.shape[-1]
    best = torch.argmin(S, dim=-1)
    minS = S.gather(-1, best[..., None])[..., 0]
    far = (torch.arange(D, device=S.device) - best[..., None]).abs() > 1
    close = (S * (100 - uniqueness) < minS[..., None] * 100) & far
    valid = ~close.any(-1)
    Sm1 = S.gather(-1, torch.clamp(best - 1, 0, D - 1)[..., None])[..., 0]
    Sp1 = S.gather(-1, torch.clamp(best + 1, 0, D - 1)[..., None])[..., 0]
    denom = torch.clamp(Sm1 + Sp1 - 2 * minS, min=1).to(torch.float32)
    frac = (Sm1 - Sp1).to(torch.float32) / (2.0 * denom)
    interior = (best > 0) & (best < D - 1)
    disp = best.to(torch.float32) + torch.where(interior, frac, torch.zeros_like(frac))
    disp = disp + float(min_disp)
    return disp, valid, best.to(torch.int32), minS.to(torch.int32)


def lr_keep(best, minS, disp, num_disp: int, min_disp: int, max_diff: int) -> torch.Tensor:
    """disp12MaxDiff keep mask (H, Wc): the right view's winner of column xr
    is the left pixel x = xr + min_disp + d whose own winner is d with the
    smallest cost (ties: smallest d); a left pixel is dropped only where the
    floor and the ceil of its disparity both point at a right winner that
    disagrees by more than max_diff."""
    H, Wc = best.shape
    D = num_disp
    x0 = min_disp + D
    W_full = x0 + Wc
    dev = best.device
    pad = (x0, D + min_disp)
    pad_best = torch.nn.functional.pad(best, pad, value=-1)
    pad_minS = torch.nn.functional.pad(minS, pad, value=_BIG)
    run_min = torch.full((H, W_full), _BIG, dtype=torch.int32, device=dev)
    run_arg = torch.zeros((H, W_full), dtype=torch.int32, device=dev)
    for d in range(D):
        s = min_disp + d
        b = pad_best[:, s:s + W_full]
        v = torch.where(b == d, pad_minS[:, s:s + W_full], _BIG)
        take = v < run_min
        run_min = torch.where(take, v, run_min)
        run_arg = torch.where(take, d, run_arg)
    has_partner = run_min < _BIG
    dispR = run_arg + min_disp

    def check(d_int):
        xr = torch.arange(Wc, device=dev)[None, :] + x0 - d_int
        xr_c = torch.clamp(xr, 0, W_full - 1).to(torch.int64)
        partner_valid = has_partner.gather(1, xr_c)
        dR = dispR.gather(1, xr_c)
        in_img = (xr >= 0) & (xr < W_full)
        return ~(in_img & partner_valid) | ((dR - d_int).abs() <= max_diff)

    return (check(torch.floor(disp).to(torch.int32))
            | check(torch.ceil(disp).to(torch.int32)))


def _shift(x: torch.Tensor, s: int, axis: int, before: bool, fill) -> torch.Tensor:
    n = x.shape[axis]
    out = torch.full_like(x, fill)
    if s < n:
        if before:
            out.narrow(axis, s, n - s).copy_(x.narrow(axis, 0, n - s))
        else:
            out.narrow(axis, 0, n - s).copy_(x.narrow(axis, s, n - s))
    return out


def _seg_min_flood(lab, conn, axis: int, big: int):
    """Two-sided min-flood of labels along `axis` within runs of joined
    neighbours (conn[i]: i joined to its predecessor), by log-doubling."""
    n = lab.shape[axis]
    bigv = torch.full_like(lab, big)
    C = conn
    s = 1
    while s < n:
        lab = torch.minimum(lab, torch.where(C, _shift(lab, s, axis, True, 0), bigv))
        C_next = _shift(C, s, axis, False, False)
        lab = torch.minimum(lab, torch.where(C_next, _shift(lab, s, axis, False, 0), bigv))
        C = C & _shift(C, s, axis, True, False)
        s *= 2
    return lab


def speckle_keep(disp: torch.Tensor, valid: torch.Tensor, max_size: int, max_diff: float,
                 max_rounds: int = 100000) -> torch.Tensor:
    """valid & (the pixel's component has more than max_size pixels), the
    components flooded to their fixpoint (raises if max_rounds do not reach it)."""
    H, W = valid.shape
    disp = disp.to(torch.float32)
    ch = torch.zeros_like(valid)
    cv = torch.zeros_like(valid)
    ch[:, 1:] = ((disp[:, 1:] - disp[:, :-1]).abs() <= max_diff) & valid[:, 1:] & valid[:, :-1]
    cv[1:, :] = ((disp[1:, :] - disp[:-1, :]).abs() <= max_diff) & valid[1:, :] & valid[:-1, :]
    lab = torch.arange(H * W, dtype=torch.int32, device=valid.device).reshape(H, W)
    lab = torch.where(valid, lab, torch.full_like(lab, H * W))
    big = H * W
    for _ in range(max_rounds):
        new = _seg_min_flood(_seg_min_flood(lab, ch, 1, big), cv, 0, big)
        if not bool((new != lab).any()):
            break
        lab = new
    else:
        raise RuntimeError(f"speckle labels: no fixpoint within {max_rounds} rounds")
    sizes = torch.bincount(lab.reshape(-1).to(torch.int64), minlength=H * W + 1)
    return valid & (sizes[lab.to(torch.int64)] > max_size)


def sgbm(left: torch.Tensor, right: torch.Tensor, p: dict,
         dirs: Sequence[Tuple[int, int]] | None = None):
    """(H, W) uint8 pair -> (disp f32 (H, W), valid bool (H, W)) with the
    parameters `p` (a configuration's sgbm group); `dirs` overrides the
    path directions (the control leaves one out)."""
    D, dmin = p["num_disparities"], p["min_disparity"]
    x0 = dmin + D
    dirs = directions(p["num_directions"]) if dirs is None else dirs
    C = cost_volume(left, right, D, dmin, p["block_size"], p["pre_filter_cap"])
    S = aggregate(C, p["p1"], p["p2"], dirs)
    del C
    disp, valid, best, minS = wta(S, dmin, p["uniqueness_ratio"])
    del S
    if p["disp12_max_diff"] >= 0:
        valid = valid & lr_keep(best, minS, disp, D, dmin, p["disp12_max_diff"])
    disp = torch.nn.functional.pad(disp, (x0, 0), value=float(dmin - 1))
    valid = torch.nn.functional.pad(valid, (x0, 0), value=False)
    if p["speckle_window_size"] > 0:
        keep = speckle_keep(disp[:, x0:], valid[:, x0:], p["speckle_window_size"],
                            float(p["speckle_range"]))
        valid = torch.nn.functional.pad(keep, (x0, 0), value=False)
    return disp, valid


def maps(config: dict, left: torch.Tensor, right: torch.Tensor, control: bool = False):
    """The reference of the "sgbm" chain: the maps of one (H, W) uint8 pair
    with a configuration's ``sgbm`` group. `control` leaves the last path
    direction out, a sweep a later change might drop (the control of
    ``correct``)."""
    p = config["sgbm"]
    dirs = directions(p["num_directions"])
    return sgbm(left, right, p, dirs[:-1] if control else dirs)
