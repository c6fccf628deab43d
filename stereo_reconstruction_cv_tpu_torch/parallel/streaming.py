"""Streaming batched stereo pipeline (after ``stereo_reconstruction_cv_tpu/parallel/streaming.py``; BASELINE config 5).

Pairs flow from disk through the prefetching JPEG loader into a batched
dense step (SGBM -> disparity -> 3D reprojection) on the device, with one
point cloud written per pair. The loader decodes and copies batch k+1 while
batch k computes; each pair's points are compacted on the device and copied
to pinned host memory asynchronously, so the PLY write of one batch runs on
the host while the device computes the next.

With ``mesh=`` (``parallel.mesh.Mesh``) the loader places each batch on the
mesh (pairs over 'data', rows over 'space'), SGBM runs row-sharded
(``parallel.sgm_sharded.sharded_sgbm_disparity``, halo warm-start, as the
reference's step calls it) and each pair's maps are gathered onto one device
of its own data row, the pairs of a row taking the row's devices in turn,
where its reprojection, cloud and copy to the host run. The clouds keep the
input's order.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig
from stereo_reconstruction_cv_tpu_torch.io import ply as PLY
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G
from stereo_reconstruction_cv_tpu_torch.ops.cuda import cloud as CL
from stereo_reconstruction_cv_tpu_torch.parallel import mesh as M
from stereo_reconstruction_cv_tpu_torch.parallel.prefetch import PrefetchLoader
from stereo_reconstruction_cv_tpu_torch.parallel.sgm_sharded import sharded_sgbm_disparity
from stereo_reconstruction_cv_tpu_torch.utils.profiling import span


def dense_batch_step(left, right, Q, cfg: SGBMConfig, mesh: Optional[M.Mesh] = None):
    """(B, H, W) uint8 pairs -> (disparity (B, H, W), points (B, H, W, 3),
    valid (B, H, W)) on their device. The port's sgbm_disparity takes one
    frame, so the batch runs one pair after the other, and each pair's
    points are written into the batch's tensor. Q (4, 4) stays on the host:
    the reprojection takes its values as launch arguments, so nothing here
    waits for the device. With `mesh`, the pairs (tensors, or Sharded by
    batch_row_sharding) run through sharded_sgbm_disparity and each comes
    back on a device of its own data row (mesh_points): three lists of B
    tensors, in the batch's order."""
    if mesh is not None:
        return mesh_points(*sharded_sgbm_disparity(mesh, left, right, cfg), Q, mesh)
    maps = [DP.sgbm_disparity(l, r, cfg) for l, r in zip(left, right)]
    # A batch of one is a view of its maps: no copy.
    disp, valid = (torch.stack(t) if len(t) > 1 else t[0].unsqueeze(0) for t in zip(*maps))
    with span("cloud.reproject"):
        pts = torch.empty((*disp.shape, 3), dtype=disp.dtype, device=disp.device)
        for d, p in zip(disp, pts):
            G.reproject_image_to_3d(d, Q, out=p)
    return disp, pts, valid


def gather_row(disp: M.Sharded, valid: M.Sharded, i: int):
    """Data row i's pairs as whole maps: (disparities, valid masks), pair k
    on the row's device k % n_space."""
    row = disp.mesh.devices[i]
    with span("mesh.gather"):
        out = [[torch.cat([blk[k].to(row[k % len(row)]) for blk in x.blocks[i]])
                for k in range(x.blocks[i][0].shape[0])] for x in (disp, valid)]
    return out[0], out[1]


def mesh_points(disp: M.Sharded, valid: M.Sharded, Q, mesh: M.Mesh):
    """Sharded maps -> (disparities, points, valid masks): lists in the
    batch's order, each pair's whole maps and points on a device of its own
    data row (gather_row). Q stays on the host (dense_batch_step)."""
    disps, pts, valids = [], [], []
    for i in range(mesh.shape["data"]):
        ds, vs = gather_row(disp, valid, i)
        with span("cloud.reproject"):
            pts += [G.reproject_image_to_3d(d, Q) for d in ds]
        disps += ds
        valids += vs
    return disps, pts, valids


def cloud_points(disp: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor):
    """The points of one pair that go into its cloud, valid & finite &
    disp > 0 in row-major order, without waiting for the device: (points
    (H*W, 3) whose first `count` rows are the cloud, count (1,) int64), both
    on the device. The other rows are unspecified. On a CUDA device one call
    of two kernels (ops/cuda/cloud.compact_cuda), on the CPU the plain ops."""
    with span("cloud.compact"):
        if disp.device.type == "cpu":
            return CL.compact_plain(disp, pts, valid)
        return CL.compact_cuda(disp, pts, valid)


def stream_reconstruct(
    pairs: Sequence[Tuple[str, str]],
    Q: np.ndarray,
    cfg: SGBMConfig,
    out_dir: str,
    batch_size: int = 2,
    prefetch: int = 2,
    decoder: str = "libjpeg",
    device="cuda",
    mesh: Optional[M.Mesh] = None,
) -> List[str]:
    """Stream stereo pairs (left, right JPEG paths) -> per-pair PLY point
    clouds ``out_dir/cloud_{idx:04d}.ply``. Returns the paths.

    `decoder` is one of native.DECODERS. Each cloud holds the points with
    valid & finite & disp > 0, in row-major order, as the reference writes
    them. On the device the points go to pinned host buffers through an
    async copy and an event; a batch's clouds are written once the next
    batch's compute is queued. With `mesh`, batches go onto the mesh
    (dense_batch_step) and `device` is not used: each pair's cloud is made
    and copied on a device of its own data row."""
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device(device) if mesh is None else mesh.devices[0][0]
    on_card = dev.type == "cuda"
    outputs: List[str] = []
    pending: list = []  # (path, host points, host count, event) of the batch before

    def write(batch):
        for path, host_pts, host_n, event in batch:
            if event is not None:
                event.synchronize()
            PLY.write_ply(path, host_pts[: int(host_n[0])].numpy())

    sharding = None if mesh is None else M.batch_row_sharding(mesh)
    with PrefetchLoader(pairs, batch_size=batch_size, prefetch=prefetch, gray=True,
                        decoder=decoder, device=dev, sharding=sharding) as loader:
        for left, right in loader:
            disp, pts, valid = dense_batch_step(left, right, Q, cfg, mesh)
            batch = []
            for i in range(len(disp)):
                points, count = cloud_points(disp[i], pts[i], valid[i])
                with span("cloud.copy"):
                    host_pts = torch.empty(points.shape, dtype=points.dtype, pin_memory=on_card)
                    host_n = torch.empty(count.shape, dtype=count.dtype, pin_memory=on_card)
                    host_pts.copy_(points, non_blocking=True)
                    host_n.copy_(count, non_blocking=True)
                    event = None
                    if on_card:
                        event = torch.cuda.Event()
                        event.record(torch.cuda.current_stream(points.device))
                path = os.path.join(out_dir, f"cloud_{len(outputs):04d}.ply")
                batch.append((path, host_pts, host_n, event))
                outputs.append(path)
            write(pending)
            pending = batch
        write(pending)
    return outputs
