"""Prefilter and cost volume: plain PyTorch versions and the CUDA kernel.

Plain versions of ``stereo_reconstruction_cv_tpu/ops/disparity.py``
(``xsobel_clip``, ``_halfpixel_range``, ``_bt_plane``, ``bt_cost_volume``,
``block_sum``) and the wrapper of ``csrc/cost_volume.cu``, which replaces the
TPU kernel ``ops/pallas/cost_pallas.py:cost_volume_pallas``.

``cost_volume`` dispatches on the device of its inputs: CPU tensors take the
plain version, CUDA tensors launch a kernel (or raise). On the card the
planes' dtype picks the kernel: uint8 planes take the packed one (two
disparities a 32-bit register) wherever its 16-bit lanes hold every box sum
(``u8x2_fits``), wider planes the int32 one. All integer.
"""

from __future__ import annotations

import torch

from stereo_reconstruction_cv_tpu_torch import _build

# Kernel launches by this module's wrapper, and which kernel each
# cost_volume launch took: "u8x2" the packed kernel on uint8 planes, "i32"
# the int32 one. Read by the tests, chip_smoke.py (which resets them) and
# utils/timing.graph_ms (which adds a graph's replays).
launches = {"cost_volume": 0}
cost_paths = {"u8x2": 0, "i32": 0}


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


# Shared memory of one block of csrc/cost_volume.cu: what an H100 block may
# use, and the share above which a tile halves its disparities so that
# several blocks fit on one SM.
_SMEM_MAX = 232448
_SMEM_TARGET = 100 * 1024
# The largest pixel cost of byte planes (a BT distance of 255 on the Sobel
# plane plus 255 >> 2 on the raw one), and the largest box sum a 16-bit lane
# of the packed kernel holds without carrying into its neighbour.
_U8_COST_MAX = 255 + (255 >> 2)
_LANE_MAX = 0xFFFF


def u8x2_fits(block_size: int) -> bool:
    """Whether the packed kernel is exact on any uint8 planes at this box:
    block_size^2 * 318 <= 65535, i.e. block_size <= 14 (csrc/cost_volume.cu's
    head says why)."""
    return block_size * block_size * _U8_COST_MAX <= _LANE_MAX


def cost_smem_bytes(block_size: int, groups: int, cols: int, packed: bool = False) -> int:
    """Shared memory of one cost block (csrc/cost_volume.cu smem_bytes,
    smem_bytes_u8x2): two buffers of both planes' triples of `cols` left and
    cols + 8*groups - 1 right columns (32 bytes a column, 24 for the packed
    kernel's 16-bit lanes), two buffers of the vertical sums per (column +
    1, group) (column + 2 for the packed kernel), and a ring of block_size
    rows of pixel costs per (column, group), 16 bytes an entry."""
    right = cols + 8 * groups - 1
    sums = 2 * groups * (cols + (2 if packed else 1))
    staged = (48 if packed else 64) * (cols + right)
    return staged + 16 * (sums + block_size * cols * groups)


def cost_tile(block_size: int, num_disp: int, height: int, packed: bool = False):
    """(groups of 8 disparities, staged columns NC, output rows per band) of
    one cost block; `packed` for the uint8 kernel.

    NC is a multiple of 32 that leaves at least 32 output columns
    (NC - block_size + 1); groups start at 4 (fewer for small D) and halve
    while the block's shared memory exceeds 100 KB; a box too tall for even
    that stages block_size + 7 columns. Bands are 128 rows from 1024 rows up
    (fewer halo rows per output row; 256 for the packed kernel, whose halo
    rows cost relatively more: 3.7 against 3.8-4.0 ms at 4K x 256) and 64
    below, where taller bands leave too few blocks to fill the card. Raises
    where no tile fits."""
    groups = min(4, -(-num_disp // 8))
    cols = 32 * (-(-(block_size + 31) // 32))
    while groups > 1 and cost_smem_bytes(block_size, groups, cols, packed) > _SMEM_TARGET:
        groups //= 2
    if cost_smem_bytes(block_size, groups, cols, packed) > _SMEM_MAX:
        cols = block_size + 7
    if cost_smem_bytes(block_size, groups, cols, packed) > _SMEM_MAX:
        raise ValueError(f"block_size={block_size}: the cost kernel's ring of "
                         f"{block_size} rows exceeds a block's shared memory")
    return groups, cols, (256 if packed else 128) if height >= 1024 else 64


def cost_vector_store(num_disp: int, out_ptr: int) -> bool:
    """Whether the cost kernel writes 8 disparities as one 16-byte store:
    D % 8 == 0 and a 16-byte aligned output. Otherwise it stores them one
    by one, masked at D."""
    return num_disp % 8 == 0 and out_ptr % 16 == 0


def cost_volume(sl, sr, rawl, rawr, num_disp: int, min_disp: int = 0,
                block_size: int = 11) -> torch.Tensor:
    """Fused BT cost + box sum over the cropped columns -> (H, Wc, D) int16.

    Inputs: four (H, W) integer planes (clipped Sobel and raw intensity,
    border-pinned by the caller), all on one device. On the card, four
    uint8 planes take the packed kernel where ``u8x2_fits(block_size)``;
    other planes are widened to int32 for the int32 kernel."""
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
    dev = _build.cuda_device("cost_volume", sl)  # the planes share it (checked above)
    packed = all(p.dtype == torch.uint8 for p in planes) and u8x2_fits(block_size)
    groups, cols, rows = cost_tile(block_size, num_disp, H, packed)
    dtype = torch.uint8 if packed else torch.int32
    planes = [p.to(dtype).contiguous() for p in planes]
    out = torch.empty((H, W - x0, num_disp), dtype=torch.int16, device=dev)
    vec = cost_vector_store(num_disp, out.data_ptr())
    _build.launch("srcv_cost_volume_u8x2" if packed else "srcv_cost_volume", dev,
                  *(p.data_ptr() for p in planes), out.data_ptr(),
                  H, W, num_disp, min_disp, block_size, groups, cols, rows, int(vec),
                  counts=(launches, "cost_volume"))
    _build.count(cost_paths, "u8x2" if packed else "i32")
    return out
