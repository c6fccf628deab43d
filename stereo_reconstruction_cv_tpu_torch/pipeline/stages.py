"""Dense stage functions: disparity -> 3D points -> point-cloud file.

Ports of ``stereo_reconstruction_cv_tpu/pipeline/stages.py`` ``disparity``,
``reconstruct`` and ``export_point_cloud`` (PLY). Each takes an explicit
``device``; asking for CUDA where none is available is an error, never a
quiet move to the CPU. Results stay on the device as tensors; only the
masked points cross to the host, for the file.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_reconstruction_cv_tpu.io import ply as PLY
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G


def resolve_device(device) -> torch.device:
    """torch.device(device), raising when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the host"
        )
    return dev


def _on(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.require(x, requirements=["C", "W"]))
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def disparity(imgL, imgR, ndisp: int = 16, mindis: int = 0, device="cuda") -> torch.Tensor:
    """compute_disparity_map parity (cell 10): float map, invalid and
    non-positive pixels zeroed. Images: (H, W) or (H, W, 3) uint8."""
    dev = resolve_device(device)
    return DP.compute_disparity_map(_on(imgL, dev), _on(imgR, dev), ndisp, mindis)


def reconstruct(disparity_map, Q, device="cuda") -> torch.Tensor:
    """reconstruct_3D parity (cell 11): (H, W, 3) float32 point image."""
    dev = resolve_device(device)
    return G.reproject_image_to_3d(_on(disparity_map, dev, torch.float32),
                                   _on(Q, dev, torch.float32))


def export_point_cloud(path: str, points_3d, disparity_map, colors=None,
                       device="cuda") -> int:
    """Write the valid points (finite, disparity > 0) as PLY; returns N."""
    if path.endswith(".html"):
        raise NotImplementedError(
            "the HTML viewer export is not ported yet; write a .ply file"
        )
    dev = resolve_device(device)
    pts = _on(points_3d, dev)
    mask = G.valid_point_mask(pts, _on(disparity_map, dev))
    p = pts[mask].cpu().numpy()
    c = None
    if colors is not None:
        c = _on(colors, dev)[mask].cpu().numpy()
    return PLY.write_ply(path, p, c)
