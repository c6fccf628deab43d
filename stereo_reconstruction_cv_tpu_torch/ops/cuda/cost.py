"""Prefilter and cost volume: plain PyTorch versions and the CUDA kernel.

Plain versions of ``stereo_reconstruction_cv_tpu/ops/disparity.py``
(``xsobel_clip``, ``_halfpixel_range``, ``_bt_plane``, ``bt_cost_volume``,
``block_sum``) and the wrapper of ``csrc/cost_volume.cu``, which replaces the
TPU kernel ``ops/pallas/cost_pallas.py:cost_volume_pallas``.

``cost_volume`` dispatches on the device of its inputs: CPU tensors take the
plain version, CUDA tensors launch the kernel (or raise). All integer.
"""

from __future__ import annotations

import torch

from stereo_reconstruction_cv_tpu_torch import _build

# Kernel launches by this module's wrapper (read and reset by chip_smoke.py).
launches = {"cost_volume": 0}


def xsobel_clip(img: torch.Tensor, cap: int = 63) -> torch.Tensor:
    """Clipped horizontal Sobel, OpenCV SGBM prefilter: int32 in [0, 2*cap].
    Border: replicate."""
    H, W = img.shape
    rows = torch.clamp(torch.arange(-1, H + 1, device=img.device), 0, H - 1)
    cols = torch.clamp(torch.arange(-1, W + 1, device=img.device), 0, W - 1)
    p = img.to(torch.int32)[rows][:, cols]
    dx = (
        (p[:-2, 2:] - p[:-2, :-2])
        + 2 * (p[1:-1, 2:] - p[1:-1, :-2])
        + (p[2:, 2:] - p[2:, :-2])
    )
    return torch.clamp(dx, -cap, cap) + cap


def _halfpixel_range(v: torch.Tensor):
    """Per-pixel min/max over {v, (v+v_left)//2, (v+v_right)//2}, neighbours
    clamped at the plane edge. (H, W) -> (lo, hi)."""
    vl = torch.cat([v[:, :1], torch.div(v[:, 1:] + v[:, :-1], 2, rounding_mode="floor")], 1)
    vr = torch.cat([torch.div(v[:, 1:] + v[:, :-1], 2, rounding_mode="floor"), v[:, -1:]], 1)
    lo = torch.minimum(torch.minimum(vl, vr), v)
    hi = torch.maximum(torch.maximum(vl, vr), v)
    return lo, hi


def _bt_plane(left: torch.Tensor, right: torch.Tensor, num_disp: int, min_disp: int):
    """Symmetric BT cost of one plane -> (H, W, D) int32. C[y, x, d] compares
    left pixel x with right pixel x - (min_disp + d), clamped at the left edge."""
    H, W = left.shape
    llo, lhi = _halfpixel_range(left)
    rlo, rhi = _halfpixel_range(right)
    x = torch.arange(W, device=left.device)[:, None]
    d = torch.arange(num_disp, device=left.device)[None, :]
    xr = torch.clamp(x - (min_disp + d), min=0)  # (W, D)
    rv, r0, r1 = (a[:, xr] for a in (right, rlo, rhi))
    lv, l0, l1 = (a[:, :, None] for a in (left, llo, lhi))
    c0 = torch.clamp(torch.maximum(lv - r1, r0 - lv), min=0)
    c1 = torch.clamp(torch.maximum(rv - l1, l0 - rv), min=0)
    return torch.minimum(c0, c1)


def bt_cost_volume(left_sobel, right_sobel, left_raw, right_raw,
                   num_disp: int, min_disp: int = 0) -> torch.Tensor:
    """OpenCV SGBM pixel cost: BT on the clipped-Sobel plane plus the BT on
    the raw plane >> 2. -> (H, W, D) int16."""
    i32 = torch.int32
    c_sobel = _bt_plane(left_sobel.to(i32), right_sobel.to(i32), num_disp, min_disp)
    c_raw = _bt_plane(left_raw.to(i32), right_raw.to(i32), num_disp, min_disp)
    return (c_sobel + (c_raw >> 2)).to(torch.int16)


def block_sum(vol: torch.Tensor, block_size: int) -> torch.Tensor:
    """Sum over a block_size x block_size spatial window of a (H, W, D)
    volume, edge-replicated; integer volumes sum in int64 and are stored back
    at their own width."""
    r = block_size // 2
    dtype_in = vol.dtype
    acc = vol.to(torch.int64) if not dtype_in.is_floating_point else vol

    def box1d(x, dim):
        n = x.shape[dim]
        idx = torch.clamp(torch.arange(-r - 1, n + r, device=x.device), 0, n - 1)
        cs = torch.cumsum(x.index_select(dim, idx), dim=dim)
        return cs.narrow(dim, block_size, n) - cs.narrow(dim, 0, n)

    return box1d(box1d(acc, 0), 1).to(dtype_in)


def check_cost_bounds(block_size: int, cap: int) -> None:
    """The int16 cost volume holds block_size^2 * (2*cap + 63) at most."""
    if block_size < 1 or cap < 1:
        raise ValueError(f"block_size={block_size} and pre_filter_cap={cap} must be >= 1")
    worst = block_size * block_size * (2 * cap + 63)
    if worst > 32767:
        raise ValueError(
            f"block_size={block_size}, pre_filter_cap={cap}: block sums reach "
            f"{worst} > 32767 and would overflow the int16 cost volume"
        )


def cost_volume_plain(sl, sr, rawl, rawr, num_disp: int, min_disp: int = 0,
                      block_size: int = 11) -> torch.Tensor:
    """block_sum(bt_cost_volume(...)[:, x0:, :], block_size), x0 = min_disp + D."""
    x0 = min_disp + num_disp
    C = bt_cost_volume(sl, sr, rawl, rawr, num_disp, min_disp)
    return block_sum(C[:, x0:, :], block_size)


def cost_volume(sl, sr, rawl, rawr, num_disp: int, min_disp: int = 0,
                block_size: int = 11) -> torch.Tensor:
    """Fused BT cost + box sum over the cropped columns -> (H, Wc, D) int16.

    Inputs: four (H, W) integer planes (clipped Sobel and raw intensity,
    border-pinned by the caller), all on one device."""
    H, W = sl.shape
    x0 = min_disp + num_disp
    if min_disp < 0 or num_disp < 1 or W <= x0:
        raise ValueError(
            f"need min_disp >= 0, num_disp >= 1 and width {W} > min_disp + num_disp = {x0}"
        )
    planes = (sl, sr, rawl, rawr)
    if any(p.shape != (H, W) or p.device != sl.device for p in planes):
        raise ValueError("the four planes must share one (H, W) shape and device")
    if sl.device.type == "cpu":
        return cost_volume_plain(sl, sr, rawl, rawr, num_disp, min_disp, block_size)
    if sl.device.type != "cuda":
        raise ValueError(f"cost_volume: unsupported device {sl.device}")
    planes = [p.to(torch.int32).contiguous() for p in planes]
    out = torch.empty((H, W - x0, num_disp), dtype=torch.int16, device=sl.device)
    lib = _build.kernels_library()
    with torch.cuda.device(sl.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.srcv_cost_volume(
            *(p.data_ptr() for p in planes), out.data_ptr(),
            H, W, num_disp, min_disp, block_size, stream,
        )
    _build.check(lib, err, "cost_volume")
    launches["cost_volume"] += 1
    return out
