"""Dense disparity: semi-global block matching (SGBM) on tensors.

Port of ``stereo_reconstruction_cv_tpu/ops/disparity.py`` (cv2.StereoSGBM
parity, the reference's exact parameter set in the port's own
``config.SGBMConfig``):

  x-Sobel prefilter (clipped)         -> tensor ops
  BT cost volume + box aggregation    -> cuda/cost.py  (kernel cost_volume)
  semi-global paths + WTA             -> cuda/sgm.py   (kernels sgm_path_sweep,
                                                        sgm_sweep_wta)
  or, at num_directions=0 (block
  matching), WTA over the cost volume -> cuda/sgm.py   (kernel wta_volume)
  left-right consistency              -> cuda/lr.py    (kernel lr_check)
  speckle filter, "propagate"         -> cuda/speckle.py (kernels speckle_labels,
                                                        speckle_keep)
  speckle filter, "exact"             -> host union-find (native.py)

beside the whole-frame sgbm_disparity: sgbm_disparity_auto, which row-tiles
(sgbm_disparity_tiled) a frame that does not fit the card's free memory, and
sgbm_disparity_fast, the reference's coarse-to-fine path. Block matching
runs whole-frame, row-tiled and with the host speckle filter; the
coarse-to-fine path refuses it.

On a CUDA device block matching's whole frame is replayed from a CUDA graph
(FrameGraph) once its first frame of a shape has run: its ~20 launches cost
the host more time than the card spends on them.

sgbm_disparity's stages are public so that the exact row-sharded SGBM
(parallel/sgm_sharded.py) runs the same frame around its own carried sweeps:
``validate``, ``sgbm_cost`` (planes + cost volume) and ``sgbm_post`` (LR
check into valid, the margin padded back). ``margin`` is the one home of the
left margin's width x0 and its disparity, which the speckle filters also read.

Every function runs on the device of the tensors it is given: CUDA tensors go
through the kernels, CPU tensors through the plain versions beside them.
``SGBMConfig.backend`` selects TPU code paths and is ignored here; the scans
are exact, so ``scan_chunk`` must be None.
"""

from __future__ import annotations

import torch

from stereo_reconstruction_cv_tpu_torch import _build, native
from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig
from stereo_reconstruction_cv_tpu_torch.ops.cuda.cost import (
    _halfpixel_range,
    block_sum,
    check_cost_bounds,
    cost_volume,
    xsobel_clip,
)
from stereo_reconstruction_cv_tpu_torch.ops.cuda.lr import lr_check_maps
from stereo_reconstruction_cv_tpu_torch.ops.cuda.sgm import check_sgm_bounds, sgm_wta
from stereo_reconstruction_cv_tpu_torch.ops.cuda.speckle import speckle_filter
from stereo_reconstruction_cv_tpu_torch.utils.profiling import span


def validate(H: int, W: int, cfg: SGBMConfig) -> None:
    """Raise ValueError on a frame size or config the port's SGBM does not take."""
    if cfg.speckle_backend not in ("propagate", "exact"):
        raise ValueError(f"speckle_backend={cfg.speckle_backend!r}: 'propagate' or 'exact'")
    if cfg.scan_chunk is not None:
        raise ValueError(
            f"scan_chunk={cfg.scan_chunk}: the port's path scans are exact; "
            "chunked scans were a TPU option (use scan_chunk=None)"
        )
    if cfg.min_disparity < 0:
        raise ValueError(f"min_disparity={cfg.min_disparity} must be >= 0")
    x0, _ = margin(cfg)
    if W <= x0:
        raise ValueError(f"width {W} must exceed min_disparity + num_disparities = {x0}")
    check_cost_bounds(cfg.block_size, cfg.pre_filter_cap)
    check_sgm_bounds(cfg.p1, cfg.p2, cfg.num_disparities, cfg.num_directions)


def cost_halo(block_size: int) -> int:
    """Rows beyond a block of rows that its exact cost volume reads: the
    box's radius, plus one for the Sobel that the box's outermost row reads
    (6 at block size 11, the reference's _COST_HALO)."""
    return block_size // 2 + 1


def block_matching(cfg: SGBMConfig) -> bool:
    """Whether cfg runs no path (num_directions=0): StereoBM's WTA over the
    cost volume, P1 and P2 unused."""
    return cfg.num_directions == 0


def cost_planes(left: torch.Tensor, right: torch.Tensor, cap: int):
    """The four planes of the pixel cost: clipped Sobel and raw intensity of
    both views, with the first and last column of each pinned to cap
    (OpenCV's calcPixelCostBT memset). uint8 where every value fits a byte
    (uint8 views and a Sobel range [0, 2 * cap] within 255), which the
    cost kernel reads two disparities a register; else int32."""
    byte = left.dtype == right.dtype == torch.uint8 and 2 * cap <= 255
    if byte:
        return _byte_planes(left, right, cap)
    planes = []
    for p in (xsobel_clip(left, cap), xsobel_clip(right, cap), left, right):
        p = p.to(torch.int32, copy=True)
        p[:, 0] = cap
        p[:, -1] = cap
        planes.append(p)
    return planes


def _byte_planes(left: torch.Tensor, right: torch.Tensor, cap: int):
    """cost_planes' uint8 planes, both views at once in a dozen tensor ops
    (the host issues each op of a frame): the four planes are one (4, H, W)
    tensor, raw views at 2 and 3. Only the Sobel of the interior columns is
    computed, since the first and last are pinned; its rows replicate at
    the top and bottom as xsobel_clip's do, in int16 (|dx| <= 4 * 255)."""
    H, W = left.shape
    planes = torch.empty((4, H, W), dtype=torch.uint8, device=left.device)
    planes[2].copy_(left)
    planes[3].copy_(right)
    raw = planes[2:].to(torch.int16)
    h = raw[..., 2:] - raw[..., :-2]
    hp = torch.cat((h[:, :1], h, h[:, -1:]), dim=1)
    dx = torch.add(hp[:, :-2] + hp[:, 2:], h, alpha=2)
    planes[:2, :, 1:-1] = dx.clamp_(-cap, cap).add_(cap)
    planes[:, :, ::max(W - 1, 1)] = cap  # the first and last columns
    return list(planes.unbind(0))


def margin(cfg: SGBMConfig):
    """The left margin x < x0 = min_disparity + num_disparities (OpenCV's
    minX1), where no disparity is computed -> (x0, the disparity its pixels
    hold: min_disparity - 1). They are invalid, so never kept."""
    return cfg.min_disparity + cfg.num_disparities, float(cfg.min_disparity - 1)


def pad_margin(t: torch.Tensor, x0: int, value=False) -> torch.Tensor:
    """(..., W - x0) -> (..., W): the margin's columns put back on the left."""
    return torch.nn.functional.pad(t, (x0, 0), value=value)


def sgbm_cost(left: torch.Tensor, right: torch.Tensor, cfg: SGBMConfig) -> torch.Tensor:
    """The cost stage: cost_planes + cost_volume -> C (H, W - x0, D) int16."""
    return cost_volume(*cost_planes(left, right, cfg.pre_filter_cap), cfg.num_disparities,
                       cfg.min_disparity, cfg.block_size)


def sgbm_post(disp: torch.Tensor, valid: torch.Tensor, best: torch.Tensor, minS: torch.Tensor,
              cfg: SGBMConfig):
    """The post stage short of the speckle filter: the LR check ANDed into
    valid in place, then the margin padded back -> full-width (disp, valid)."""
    if cfg.disp12_max_diff >= 0:
        lr_check_maps(best, minS, disp, cfg.num_disparities, cfg.min_disparity,
                      cfg.disp12_max_diff, out=valid)
    x0, pad = margin(cfg)
    return pad_margin(disp, x0, pad), pad_margin(valid, x0)


def sgbm_disparity(left: torch.Tensor, right: torch.Tensor, cfg: SGBMConfig):
    """Full SGBM: grayscale (H, W) uint8 pair -> (float disparity, valid).

    Disparities are computed for x >= min_disparity + num_disparities (OpenCV's
    minX1); the left margin is invalid and holds min_disparity - 1. Box and path
    aggregation replicate at that cropped boundary. OpenCV's prefilter pins the
    first and last column of every cost plane, raw ones included, to
    pre_filter_cap. At num_directions=0 no path runs: the WTA reads C alone
    (block matching), under the span "sgbm.wta" in place of
    "sgbm.aggregate". Block matching on a CUDA device with the "propagate"
    speckle filter replays its frame from a CUDA graph (FrameGraph) after
    the first call of each shape and configuration."""
    with span("sgbm"):
        key = (left.shape, right.shape, left.dtype, right.dtype, left.device, right.device, cfg)
        graph = _graphs.get(key)
        if graph is not None:
            return graph(left, right)
        validate(*_pair_shape(left, right), cfg)
        out = _frame(left, right, cfg)
        if (block_matching(cfg) and left.device.type == "cuda"
                and cfg.speckle_backend == "propagate"):
            if len(_graphs) >= MAX_GRAPHS:
                _graphs.pop(next(iter(_graphs)))
            _graphs[key] = FrameGraph(left, right, cfg)
        return out


def _pair_shape(left: torch.Tensor, right: torch.Tensor):
    H, W = left.shape
    if right.shape != (H, W) or right.device != left.device:
        raise ValueError("left and right must share one (H, W) shape and device")
    return H, W


def _frame(left: torch.Tensor, right: torch.Tensor, cfg: SGBMConfig):
    """sgbm_disparity's stages, launched one by one."""
    with span("sgbm.cost"):
        C = sgbm_cost(left, right, cfg)
    with span("sgbm.wta" if block_matching(cfg) else "sgbm.aggregate"):
        disp, valid, best, minS = sgm_wta(
            C, cfg.p1, cfg.p2, cfg.num_directions, cfg.uniqueness_ratio, cfg.min_disparity
        )
    del C
    with span("sgbm.post"):
        disp, valid = sgbm_post(disp, valid, best, minS, cfg)
        if cfg.speckle_window_size > 0:
            valid = _speckle(disp, valid, cfg)
    return disp, valid


# Block matching's frame issues ~20 short launches and tensor ops whose
# device time (~0.35 ms at 720p x 64) is less than the host's time to issue
# them: a graph's replay issues them in one call. Graphs hold their frame's
# memory, so at most MAX_GRAPHS are kept, the oldest dropped first.
MAX_GRAPHS = 4
_graphs: dict = {}


class FrameGraph:
    """One block-matching frame (_frame) captured as a CUDA graph on copies
    of its inputs. Calling it copies a pair into them, replays the graph on
    the current stream and returns copies of its (disp, valid), so a later
    replay overwrites nothing a caller holds. Each replay adds the launch
    counts that the capture skipped (_build.recording). Made after one eager
    frame of the same shape, which builds the kernels and the speckle count
    cells that the capture reuses. Its calls share its input copies, so they
    run in order on one stream, as calls that share count cells must."""

    def __init__(self, left: torch.Tensor, right: torch.Tensor, cfg: SGBMConfig):
        self.left = torch.empty_like(left, memory_format=torch.contiguous_format)
        self.right = torch.empty_like(right, memory_format=torch.contiguous_format)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(left.device):
            # thread_local: a loader thread's decodes may run meanwhile
            with _build.recording() as self.counts, \
                    torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.disp, self.valid = _frame(self.left, self.right, cfg)

    def __call__(self, left: torch.Tensor, right: torch.Tensor):
        self.left.copy_(left)
        self.right.copy_(right)
        self.graph.replay()
        for launches, name in self.counts:
            launches[name] += 1
        return self.disp.clone(), self.valid.clone()


def filter_speckles_host(disp: torch.Tensor, valid: torch.Tensor,
                         max_size: int, max_diff: float) -> torch.Tensor:
    """Exact cv2.filterSpeckles on the host; the mask returns to valid's device."""
    keep = native.filter_speckles(disp.detach().cpu().numpy(),
                                  valid.detach().cpu().numpy(), max_size, max_diff)
    return torch.from_numpy(keep).to(valid.device)


def _speckle(disp: torch.Tensor, valid: torch.Tensor, cfg: SGBMConfig) -> torch.Tensor:
    """Keep mask of cfg's speckle backend: "exact" on the host, "propagate"
    on the inputs' device. The left margin (margin) is invalid by
    construction, so "propagate" labels only the columns right of it and
    pads the margin back as not kept."""
    if cfg.speckle_backend == "exact":
        return filter_speckles_host(disp, valid, cfg.speckle_window_size,
                                    float(cfg.speckle_range))
    x0, _ = margin(cfg)
    keep = speckle_filter(disp[:, x0:], valid[:, x0:], cfg.speckle_window_size,
                          float(cfg.speckle_range))
    return pad_margin(keep, x0)


def frame_bytes(H: int, W: int, cfg: SGBMConfig) -> int:
    """Device bytes one frame's SGBM holds at its peak: the int16 cost volume,
    the u16 delta volumes (none for block matching, one for 5 directions,
    two for 8) and the planes."""
    cells = H * max(W - margin(cfg)[0], 0) * cfg.num_disparities
    volumes = 0 if block_matching(cfg) else (2 if cfg.num_directions == 8 else 1)
    return cells * 2 * (1 + volumes) + 64 * H * W


def fits_whole_frame(H: int, W: int, cfg: SGBMConfig, device) -> bool:
    """Whether one frame's SGBM (frame_bytes) fits the free memory of a CUDA
    device; frames on the CPU always do. The reference counts cells against
    a TPU's HBM (``_fits_whole_frame``, 24e8 or 4e8 cells); the port counts
    its own bytes against what the card has free."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    free, _total = torch.cuda.mem_get_info(device)
    return frame_bytes(H, W, cfg) <= free


def sgbm_disparity_auto(left: torch.Tensor, right: torch.Tensor, cfg: SGBMConfig,
                        tile_rows: int = 512):
    """sgbm_disparity, row-tiled (sgbm_disparity_tiled) only when the frame
    does not fit the device's free memory."""
    if fits_whole_frame(*left.shape, cfg, left.device):
        return sgbm_disparity(left, right, cfg)
    return sgbm_disparity_tiled(left, right, cfg, tile_rows=tile_rows)


def sgbm_disparity_tiled(left: torch.Tensor, right: torch.Tensor, cfg: SGBMConfig,
                         tile_rows: int = 512, halo: int = 32):
    """SGBM over row tiles of `tile_rows`, each with `halo` rows of warm-start
    overlap above and below (clamped at the image edges; the scheme of
    parallel/sgm_sharded.py's halo mode), stitched; the speckle filter runs
    on the whole map afterwards. Peak memory follows tile_rows, not H.
    Block matching has no path to warm up: its tiles equal the whole
    frame's rows exactly once the halo covers the cost's rows (cost_halo),
    and a smaller halo is refused."""
    H, W = left.shape
    if block_matching(cfg) and halo < cost_halo(cfg.block_size):
        raise ValueError(f"sgbm_disparity_tiled: block matching (num_directions=0) needs a "
                         f"halo of at least {cost_halo(cfg.block_size)} rows at block size "
                         f"{cfg.block_size}, got {halo}")
    if H <= tile_rows:
        return sgbm_disparity(left, right, cfg)
    validate(*_pair_shape(left, right), cfg)
    core = cfg.with_(speckle_window_size=0)
    disps, valids = [], []
    for y0 in range(0, H, tile_rows):
        y1 = min(y0 + tile_rows, H)
        a, b = max(y0 - halo, 0), min(y1 + halo, H)
        with span("sgbm"):  # each tile eagerly: a graph a tile shape would hold its memory
            d, v = _frame(left[a:b], right[a:b], core)
        disps.append(d[y0 - a:y1 - a])
        valids.append(v[y0 - a:y1 - a])
    disp, valid = torch.cat(disps), torch.cat(valids)
    if cfg.speckle_window_size > 0:
        valid = _speckle(disp, valid, cfg)
    return disp, valid


# ---------------------------------------------------------------------------
# Coarse-to-fine fast path
# ---------------------------------------------------------------------------

def box2(img: torch.Tensor) -> torch.Tensor:
    """2x box downsample of a (H, W) uint8 image: the rounded mean of each
    2x2 block (OpenCV INTER_AREA at factor 2); an odd last row or column is
    dropped."""
    H, W = img.shape
    a = img[:H - H % 2, :W - W % 2].to(torch.int32)
    s = a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]
    return ((s + 2) >> 2).to(torch.uint8)


def shift_plane(a: torch.Tensor, s: int) -> torch.Tensor:
    """a[y, x - s], edge-replicated (static shift)."""
    W = a.shape[1]
    return a[:, (torch.arange(W, device=a.device) - s).clamp(0, W - 1)]


def warp_by_disp(planes, d0: torch.Tensor) -> list:
    """planes[k][y, x - d0[y, x]] for integer d0 >= 0, the column clamped at
    0 (edge replication): one gather where the reference chains a shift and
    a select per disparity (a TPU stand-in for a gather)."""
    W = d0.shape[1]
    idx = (torch.arange(W, device=d0.device)[None, :] - d0.to(torch.int64)).clamp(min=0)
    return [p.gather(1, idx) for p in planes]


def _bt_aligned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric BT between two aligned planes; each half-pixel range comes
    from the plane's own neighbours."""
    blo, bhi = _halfpixel_range(b)
    alo, ahi = _halfpixel_range(a)
    c0 = torch.clamp(torch.maximum(a - bhi, blo - a), min=0)
    c1 = torch.clamp(torch.maximum(b - ahi, alo - b), min=0)
    return torch.minimum(c0, c1)


def sgbm_disparity_fast(left: torch.Tensor, right: torch.Tensor, cfg: SGBMConfig,
                        refine_radius: int = 2):
    """Coarse-to-fine SGBM (the reference's opt-in fast path): the full
    pipeline at half resolution and half range on the 2x box-downsampled
    pair (the kernels), the map upsampled (nearest, doubled), then each
    pixel re-scored at full resolution over d0 +- refine_radius with the BT
    + block cost (torch ops on 2r+1 planes), WTA and the parabolic
    subpixel. Validity comes from the coarse level; the speckle filter runs
    on the refined map. Raises where the coarse level's width leaves no
    disparity column (a width the single-device check refuses), and for
    block matching, which has no coarse-to-fine path here."""
    if block_matching(cfg):
        raise ValueError("sgbm_disparity_fast: block matching (num_directions=0) has no "
                         "coarse-to-fine path; use sgbm_disparity")
    H, W = left.shape
    D = cfg.num_disparities
    r = refine_radius
    cfg_h = cfg.with_(num_disparities=max(16, D // 2), min_disparity=cfg.min_disparity // 2,
                      speckle_window_size=0)
    lh, rh = box2(left), box2(right)
    try:
        validate(*lh.shape, cfg_h)
    except ValueError as e:
        raise ValueError(f"sgbm_disparity_fast: the half-resolution level {tuple(lh.shape)} "
                         f"with {cfg_h.num_disparities} disparities: {e}") from None
    d_h, v_h = sgbm_disparity(lh, rh, cfg_h)
    d0f = (d_h * 2.0).repeat_interleave(2, 0).repeat_interleave(2, 1)
    v0 = v_h.repeat_interleave(2, 0).repeat_interleave(2, 1)
    if H % 2:  # the odd last row and column repeat their neighbours
        d0f, v0 = torch.cat([d0f, d0f[-1:]]), torch.cat([v0, v0[-1:]])
    if W % 2:
        d0f, v0 = torch.cat([d0f, d0f[:, -1:]], 1), torch.cat([v0, v0[:, -1:]], 1)
    lo = cfg.min_disparity
    d0 = torch.clamp(torch.round(d0f), lo, lo + D - 1).to(torch.int32)
    cap = cfg.pre_filter_cap
    sl, sr = xsobel_clip(left, cap), xsobel_clip(right, cap)
    rawl, rawr = left.to(torch.int32), right.to(torch.int32)
    wsr, wraw = warp_by_disp((sr, rawr), d0)
    Ck = torch.stack([_bt_aligned(sl, shift_plane(wsr, k))
                      + (_bt_aligned(rawl, shift_plane(wraw, k)) >> 2)
                      for k in range(-r, r + 1)], -1)
    Ck = block_sum(Ck, cfg.block_size)
    best_k = torch.argmin(Ck, -1)  # the first index on ties, as jnp.argmin
    minC = Ck.gather(-1, best_k[..., None])[..., 0]
    Cm1 = Ck.gather(-1, (best_k - 1).clamp(0, 2 * r)[..., None])[..., 0]
    Cp1 = Ck.gather(-1, (best_k + 1).clamp(0, 2 * r)[..., None])[..., 0]
    denom = torch.clamp(Cm1 + Cp1 - 2 * minC, min=1).to(torch.float32)
    frac = (Cm1 - Cp1).to(torch.float32) / (2.0 * denom)
    interior = (best_k > 0) & (best_k < 2 * r)
    disp = (d0 + best_k - r).to(torch.float32) + torch.where(interior, frac, torch.zeros_like(frac))
    disp = torch.clamp(disp, float(lo), float(lo + D - 1))
    valid = v0
    if cfg.speckle_window_size > 0:
        valid = _speckle(disp, valid, cfg)
    return disp, valid


def sgbm_disparity_host_speckle(left: torch.Tensor, right: torch.Tensor, cfg: SGBMConfig):
    """SGBM on the device with the exact union-find speckle filter run on the
    host. Returns (disp, valid) on the inputs' device."""
    return sgbm_disparity_auto(left, right, cfg.with_(speckle_backend="exact"))


def compute_disparity_map(imgL: torch.Tensor, imgR: torch.Tensor, ndisp: int = 16,
                          mindis: int = 0, speckle_backend: str = "exact") -> torch.Tensor:
    """Reference-parity wrapper (main.ipynb cell 10): StereoSGBM with the
    notebook's parameters and 5 paths, float output, invalid and non-positive
    pixels zeroed."""
    cfg = SGBMConfig(min_disparity=mindis, num_disparities=ndisp, num_directions=5)
    if imgL.dim() == 3:  # the reference feeds colour; the cost uses the gray plane
        imgL = rgb_to_gray_u8(imgL)
        imgR = rgb_to_gray_u8(imgR)
    disp, valid = sgbm_disparity_auto(imgL, imgR, cfg.with_(speckle_backend=speckle_backend))
    disp = torch.where(valid, disp, torch.full_like(disp, float(mindis) - 1.0))
    return torch.where(disp > 0, disp, torch.zeros_like(disp))


def rgb_to_gray_u8(img: torch.Tensor) -> torch.Tensor:
    """BT.601 luma with OpenCV cvtColor rounding (RGB channel order)."""
    r, g, b = (img[..., i].to(torch.float32) for i in range(3))
    return torch.round(0.299 * r + 0.587 * g + 0.114 * b).to(torch.uint8)
