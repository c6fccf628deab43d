"""Dense disparity: semi-global block matching (SGBM) on tensors.

Port of ``stereo_reconstruction_cv_tpu/ops/disparity.py`` (cv2.StereoSGBM
parity, the reference's exact parameter set in the port's own
``config.SGBMConfig``):

  x-Sobel prefilter (clipped)         -> tensor ops
  BT cost volume + box aggregation    -> cuda/cost.py  (kernel cost_volume)
  semi-global paths + WTA             -> cuda/sgm.py   (kernels sgm_path_sweep,
                                                        sgm_sweep_wta)
  left-right consistency              -> cuda/lr.py    (kernel lr_check)
  speckle filter, "propagate"         -> cuda/speckle.py (kernels speckle_labels,
                                                        speckle_keep)
  speckle filter, "exact"             -> host union-find (native.py)

Every function runs on the device of the tensors it is given: CUDA tensors go
through the kernels, CPU tensors through the plain versions beside them.
``SGBMConfig.backend`` selects TPU code paths and is ignored here; the scans
are exact, so ``scan_chunk`` must be None.
"""

from __future__ import annotations

import torch

from stereo_reconstruction_cv_tpu_torch import native
from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig
from stereo_reconstruction_cv_tpu_torch.ops.cuda.cost import (
    check_cost_bounds,
    cost_volume,
    xsobel_clip,
)
from stereo_reconstruction_cv_tpu_torch.ops.cuda.lr import lr_check_maps
from stereo_reconstruction_cv_tpu_torch.ops.cuda.sgm import check_sgm_bounds, sgm_wta
from stereo_reconstruction_cv_tpu_torch.ops.cuda.speckle import speckle_filter


def _validate(H: int, W: int, cfg: SGBMConfig) -> None:
    if cfg.speckle_backend not in ("propagate", "exact"):
        raise ValueError(f"speckle_backend={cfg.speckle_backend!r}: 'propagate' or 'exact'")
    if cfg.scan_chunk is not None:
        raise ValueError(
            f"scan_chunk={cfg.scan_chunk}: the port's path scans are exact; "
            "chunked scans were a TPU option (use scan_chunk=None)"
        )
    if cfg.min_disparity < 0:
        raise ValueError(f"min_disparity={cfg.min_disparity} must be >= 0")
    if W <= cfg.min_disparity + cfg.num_disparities:
        raise ValueError(
            f"width {W} must exceed min_disparity + num_disparities = "
            f"{cfg.min_disparity + cfg.num_disparities}"
        )
    check_cost_bounds(cfg.block_size, cfg.pre_filter_cap)
    check_sgm_bounds(cfg.p1, cfg.p2, cfg.num_disparities, cfg.num_directions)


def cost_planes(left: torch.Tensor, right: torch.Tensor, cap: int):
    """The four int32 planes of the pixel cost: clipped Sobel and raw
    intensity of both views, with the first and last column of each pinned
    to cap (OpenCV's calcPixelCostBT memset)."""
    planes = []
    for p in (xsobel_clip(left, cap), xsobel_clip(right, cap),
              left.to(torch.int32), right.to(torch.int32)):
        p = p.clone()
        p[:, 0] = cap
        p[:, -1] = cap
        planes.append(p)
    return planes


def sgbm_disparity(left: torch.Tensor, right: torch.Tensor, cfg: SGBMConfig):
    """Full SGBM: grayscale (H, W) uint8 pair -> (float disparity, valid).

    Disparities are computed for x >= min_disparity + num_disparities (OpenCV's
    minX1); the left margin is invalid and holds min_disparity - 1. Box and path
    aggregation replicate at that cropped boundary. OpenCV's prefilter pins the
    first and last column of every cost plane, raw ones included, to
    pre_filter_cap."""
    H, W = left.shape
    if right.shape != (H, W) or right.device != left.device:
        raise ValueError("left and right must share one (H, W) shape and device")
    _validate(H, W, cfg)
    x0 = cfg.min_disparity + cfg.num_disparities
    planes = cost_planes(left, right, cfg.pre_filter_cap)
    C = cost_volume(*planes, cfg.num_disparities, cfg.min_disparity, cfg.block_size)
    disp, valid, best, minS = sgm_wta(
        C, cfg.p1, cfg.p2, cfg.num_directions, cfg.uniqueness_ratio, cfg.min_disparity
    )
    del C
    if cfg.disp12_max_diff >= 0:
        lr_check_maps(best, minS, disp, cfg.num_disparities, cfg.min_disparity,
                      cfg.disp12_max_diff, out=valid)  # valid &= keep, in place
    # Pad the invalid left margin back to full width.
    disp = torch.nn.functional.pad(disp, (x0, 0), value=float(cfg.min_disparity - 1))
    valid = torch.nn.functional.pad(valid, (x0, 0), value=False)
    if cfg.speckle_window_size > 0:
        valid = _speckle(disp, valid, cfg)
    return disp, valid


def filter_speckles_host(disp: torch.Tensor, valid: torch.Tensor,
                         max_size: int, max_diff: float) -> torch.Tensor:
    """Exact cv2.filterSpeckles on the host; the mask returns to valid's device."""
    keep = native.filter_speckles(disp.detach().cpu().numpy(),
                                  valid.detach().cpu().numpy(), max_size, max_diff)
    return torch.from_numpy(keep).to(valid.device)


def _speckle(disp: torch.Tensor, valid: torch.Tensor, cfg: SGBMConfig) -> torch.Tensor:
    """Keep mask of cfg's speckle backend: "exact" on the host, "propagate"
    on the inputs' device. The left margin x < min_disp + num_disp is invalid
    by construction, so "propagate" labels only the columns right of it and
    pads the margin back as not kept."""
    if cfg.speckle_backend == "exact":
        return filter_speckles_host(disp, valid, cfg.speckle_window_size,
                                    float(cfg.speckle_range))
    x0 = cfg.min_disparity + cfg.num_disparities
    keep = speckle_filter(disp[:, x0:], valid[:, x0:], cfg.speckle_window_size,
                          float(cfg.speckle_range))
    return torch.nn.functional.pad(keep, (x0, 0), value=False)


def frame_bytes(H: int, W: int, cfg: SGBMConfig) -> int:
    """Device bytes one frame's SGBM holds at its peak: the int16 cost volume,
    the u16 delta volumes (one for 5 directions, two for 8) and the planes."""
    cells = H * max(W - cfg.min_disparity - cfg.num_disparities, 0) * cfg.num_disparities
    volumes = 2 if cfg.num_directions == 8 else 1
    return cells * 2 * (1 + volumes) + 64 * H * W


def sgbm_disparity_auto(left: torch.Tensor, right: torch.Tensor, cfg: SGBMConfig):
    """sgbm_disparity after checking that the frame fits the device's free
    memory. Row tiling for frames that do not fit is ROADMAP.md A.11."""
    if left.device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(left.device)
        need = frame_bytes(*left.shape, cfg)
        if need > free:
            raise MemoryError(
                f"frame {tuple(left.shape)} x {cfg.num_disparities} disparities needs "
                f"~{need / 2**30:.1f} GiB, {free / 2**30:.1f} GiB free; row tiling "
                "is not ported yet (ROADMAP.md queue A item 11)"
            )
    return sgbm_disparity(left, right, cfg)


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
