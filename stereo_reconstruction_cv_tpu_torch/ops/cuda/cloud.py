"""The points layer: reprojection to 3-D points and the compaction of one
pair's cloud, each as plain PyTorch and as a CUDA kernel.

``reproject_plain`` is cv2.reprojectImageTo3D (handleMissingValues=False) in
torch ops, as ``stereo_reconstruction_cv_tpu/ops/geometry.py`` computes it;
``compact_plain`` keeps the points with valid & finite & disparity > 0 in
row-major order without a host sync. ``reproject_cuda`` and
``compact_cuda`` wrap ``csrc/cloud.cu``: one launch a frame, and one call of
two launches a frame, bit-equal to the plain versions. They replace no TPU
kernel. ``ops/geometry.reproject_image_to_3d`` and
``parallel/streaming.cloud_points`` dispatch between the two on the
disparity's device.

The kernel takes Q's sixteen values as launch arguments, read on the host.
Pass Q as a host array (numpy or a CPU tensor): a Q on a CUDA device is
copied to the host first, which waits for the device.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch import _build

# Pixels a compaction tile, and ballot words a tile: csrc/cloud.cu's TILE
# and WORDS, which size the kernels' work space.
TILE = 4096
WORDS = TILE // 32
# Pixels a frame the kernels index with 32-bit ints (csrc/cloud.cu MAX_PIXELS).
MAX_PIXELS = 2**31 - 1 - TILE

# Kernel launches by this module's wrappers (a compaction call launches two
# kernels and counts once): read by the tests, chip_smoke.py (which resets
# them) and utils/timing.graph_ms (which adds a graph's replays).
launches = {"reproject": 0, "compact": 0}


def reproject_plain(disparity: torch.Tensor, Q, out: torch.Tensor | None = None) -> torch.Tensor:
    """(H, W) disparity -> (H, W, 3): [X Y Z W]^T = Q [x y d 1]^T, output
    (X, Y, Z)/W, W == 0 mapped to inf, in the disparity's dtype and on its
    device; written into `out` when given."""
    H, W = disparity.shape
    dt, dev = disparity.dtype, disparity.device
    Q = torch.as_tensor(Q).to(dtype=dt, device=dev)
    y = torch.arange(H, dtype=dt, device=dev)[:, None]
    x = torch.arange(W, dtype=dt, device=dev)[None, :]
    o = [x * Q[i, 0] + y * Q[i, 1] + disparity * Q[i, 2] + Q[i, 3] for i in range(4)]
    w = torch.where(o[3] == 0, torch.full_like(o[3], float("inf")), o[3])
    return torch.stack([o[0] / w, o[1] / w, o[2] / w], dim=-1, out=out)


def host_q(Q) -> list:
    """Q (4, 4) as its sixteen float32 values, row-major, as Python floats
    (exact): numpy or torch, rounded to float32 as Tensor.to rounds. A CUDA
    tensor is copied to the host, which waits for its device."""
    if isinstance(Q, torch.Tensor):
        Q = Q.detach().to(device="cpu", dtype=torch.float32)
    q = np.asarray(Q, dtype=np.float32)
    if q.shape != (4, 4):
        raise ValueError(f"reproject: Q must be 4 x 4, got shape {q.shape}")
    return q.reshape(16).tolist()


def reproject_cuda(disparity: torch.Tensor, Q, out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel: reproject_plain's result in one launch.

    disparity: contiguous (H, W) float32 on a CUDA device; Q: (4, 4) on the
    host (host_q); out: None, or a contiguous (H, W, 3) float32 tensor on the
    same device to write into. Raises ValueError on anything else."""
    if disparity.dtype != torch.float32 or disparity.dim() != 2:
        raise ValueError(f"reproject: disparity must be (H, W) float32, got {disparity.dtype} "
                         f"{tuple(disparity.shape)}")
    H, W = disparity.shape
    if out is None:
        out = torch.empty((H, W, 3), dtype=torch.float32, device=disparity.device)
    elif out.dtype != torch.float32 or out.shape != (H, W, 3):
        raise ValueError(f"reproject: out must be ({H}, {W}, 3) float32, got {out.dtype} "
                         f"{tuple(out.shape)}")
    dev = _build.cuda_device("reproject", disparity, out)
    if not (disparity.is_contiguous() and out.is_contiguous()):
        raise ValueError("reproject: disparity and out must be contiguous on CUDA")
    if H * W > MAX_PIXELS:
        raise ValueError(f"reproject: at most {MAX_PIXELS} pixels, got {(H, W)}")
    _build.launch("srcv_cloud_reproject", dev, disparity.data_ptr(), out.data_ptr(), H, W,
                  *host_q(Q), counts=(launches, "reproject"))
    return out


def compact_plain(disp: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor):
    """(points (H*W, 3) whose first `count` rows are the points with valid &
    finite & disp > 0 in row-major order, count (1,) int64), on the inputs'
    device, without waiting for it. The other rows are unspecified."""
    mask = (valid & torch.isfinite(pts).all(dim=-1) & (disp > 0)).reshape(-1)
    n = mask.numel()
    rank = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask, rank, torch.full_like(rank, n))  # the rest to a spare row
    out = torch.empty((n + 1, 3), dtype=pts.dtype, device=pts.device)
    out.index_copy_(0, slot, pts.reshape(-1, 3))
    return out[:n], mask.sum().reshape(1)


def compact_cuda(disp: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor):
    """The kernels: compact_plain's result in one call of two launches.

    disp: contiguous (H, W) float32, pts: contiguous (H, W, 3) float32,
    valid: contiguous (H, W) bool, all on one CUDA device. Raises ValueError
    on anything else."""
    if disp.dtype != torch.float32 or disp.dim() != 2:
        raise ValueError(f"compact: disparity must be (H, W) float32, got {disp.dtype} "
                         f"{tuple(disp.shape)}")
    H, W = disp.shape
    if pts.dtype != torch.float32 or pts.shape != (H, W, 3):
        raise ValueError(f"compact: points must be ({H}, {W}, 3) float32, got {pts.dtype} "
                         f"{tuple(pts.shape)}")
    if valid.dtype != torch.bool or valid.shape != (H, W):
        raise ValueError(f"compact: valid must be ({H}, {W}) bool, got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    dev = _build.cuda_device("compact", disp, pts, valid)
    if not (disp.is_contiguous() and pts.is_contiguous() and valid.is_contiguous()):
        raise ValueError("compact: disparity, points and valid must be contiguous on CUDA")
    n = H * W
    if n > MAX_PIXELS:
        raise ValueError(f"compact: at most {MAX_PIXELS} pixels, got {(H, W)}")
    tiles = max(1, -(-n // TILE))
    scratch = torch.empty(tiles * (WORDS + 1), dtype=torch.int32, device=dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    count = torch.empty(1, dtype=torch.int64, device=dev)
    _build.launch("srcv_cloud_compact", dev, disp.data_ptr(), valid.data_ptr(), pts.data_ptr(),
                  out.data_ptr(), count.data_ptr(), scratch.data_ptr(), n, scratch.numel(),
                  counts=(launches, "compact"))
    return out, count
