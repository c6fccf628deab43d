"""The "sgbm_mesh" chain: the program's pair -> cloud path over a device mesh,
as ``stream_reconstruct(mesh=)`` runs it, without the PLY write.

A configuration with this chain states its ``mesh`` ({"data": n, "space":
m}); the chain builds it over the first n * m cards (over n * m copies of
the run's device elsewhere, as the CPU tests run it). Its batches come from
a loop that places them with ``batch_row_sharding`` (``loops/mesh_loader``).
The plain reference of the same name is ``reference/sgbm_mesh.py``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig
from stereo_reconstruction_cv_tpu_torch.ops import rectify as RC
from stereo_reconstruction_cv_tpu_torch.parallel import mesh as M
from stereo_reconstruction_cv_tpu_torch.parallel import sgm_sharded as SS
from stereo_reconstruction_cv_tpu_torch.parallel import streaming as ST


class Chain:
    """One configuration's chain over its mesh: ``dense_batch_step(...,
    mesh)`` on a Sharded batch (each pair's maps and points come back on a
    device of its data row), then per pair ``cloud_points`` and the
    non-blocking copy of the cloud and its count to pinned host memory,
    followed by an event on the pair's device. Only functions that programs
    without a row's own clouds have as well are called, so the chain also
    runs a program whose step gathers every pair onto the mesh's first
    device."""

    def __init__(self, config: dict, K, R, T, rectify: bool, device: torch.device):
        if rectify:
            raise ValueError("the sgbm_mesh chain takes rectified frames")
        W, H = config["width"], config["height"]
        f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
        res = RC.stereo_rectify(f64(K), None, f64(K), None, (W, H), f64(R), f64(T),
                                alpha=config["rig"]["alpha"])
        nd, ns = config["mesh"]["data"], config["mesh"]["space"]
        devices = ([torch.device("cuda", i) for i in range(nd * ns)] if device.type == "cuda"
                   else [device] * (nd * ns))
        self.mesh = M.make_mesh(nd, ns, devices=devices)
        self.Q = res.Q.numpy()
        self.cfg = SGBMConfig(**config["sgbm"])
        self.on_card = device.type == "cuda"

    def dense(self, lefts: M.Sharded, rights: M.Sharded):
        """A Sharded (B, H, W) uint8 batch -> (disparities, points, valid
        masks), each indexable by pair: lists of B, each pair's on a device
        of its data row."""
        return ST.dense_batch_step(lefts, rights, self.Q, self.cfg, self.mesh)

    def cloud(self, disp, pts, valid):
        """One pair's cloud on its way to the host: (host points, host count,
        event or None), made and copied on the pair's device."""
        points, count = ST.cloud_points(disp, pts, valid)
        host_pts = torch.empty(points.shape, dtype=points.dtype, pin_memory=self.on_card)
        host_n = torch.empty(count.shape, dtype=count.dtype, pin_memory=self.on_card)
        host_pts.copy_(points, non_blocking=True)
        host_n.copy_(count, non_blocking=True)
        event = None
        if self.on_card:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(points.device))
        return host_pts, host_n, event

    @contextlib.contextmanager
    def traced_layers(self, span):
        """Ranges opened by `span` in a traced run, restored on exit: "sgbm"
        around the sharded SGBM (``sharded_sgbm_disparity``), with
        "exchange" (each frame's halo rows, ``_extend``) and "speckle" (the
        batch's sharded speckle filter and its join) inside it; "cloud"
        around the maps' gathers and reprojections (``mesh_points``), with
        "gather" (each data row's, ``gather_row``) inside it. A site the
        program lacks is left out."""
        sites = [(ST, "sharded_sgbm_disparity", "sgbm"), (SS, "_extend", "exchange"),
                 (SS, "_sharded_speckle_with_margin", "speckle"),
                 (ST, "mesh_points", "cloud"), (ST, "gather_row", "gather")]
        sites = [site for site in sites if hasattr(site[0], site[1])]
        originals = [getattr(module, attr) for module, attr, _ in sites]

        def wrap(fn, name):
            def wrapped(*args, **kwargs):
                with span(name):
                    return fn(*args, **kwargs)
            return wrapped

        for (module, attr, name), fn in zip(sites, originals):
            setattr(module, attr, wrap(fn, name))
        try:
            yield
        finally:
            for (module, attr, _), fn in zip(sites, originals):
                setattr(module, attr, fn)
