"""The "sgbm" chain: what the benchmark takes from the program for a pair ->
cloud cell, the port's entry points.

The system under test is ``stereo_reconstruction_cv_tpu_torch``: its
rectification (``ops/rectify``), and the dense step and the cloud of
``parallel/streaming`` (the calls ``stream_reconstruct`` makes, without the
PLY write). A configuration names its chain (``"chain"``); the harness
finds ``chains/<chain>.py`` and its ``Chain``, and the check finds the
plain reference of the same name, ``reference/<chain>.py``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G
from stereo_reconstruction_cv_tpu_torch.ops import rectify as RC
from stereo_reconstruction_cv_tpu_torch.parallel import streaming as ST


class Chain:
    """One configuration's pair -> cloud chain on `device`, as
    ``stream_reconstruct`` runs it: optional rectification of both frames
    with the rig's maps (made once, here), ``dense_batch_step``, then per
    pair ``cloud_points`` and the non-blocking copy of the cloud and its
    count to pinned host memory, followed by an event."""

    def __init__(self, config: dict, K, R, T, rectify: bool, device: torch.device):
        W, H = config["width"], config["height"]
        f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
        res = RC.stereo_rectify(f64(K), None, f64(K), None, (W, H), f64(R), f64(T),
                                alpha=config["rig"]["alpha"])
        self.Q = res.Q.numpy()
        self.cfg = SGBMConfig(**config["sgbm"])
        self.device = device
        self.on_card = device.type == "cuda"
        self.maps = None
        if rectify:
            self.maps = [RC.rectify_map(f64(K), None, Rk, Pk, (W, H), device=device)
                         for Rk, Pk in ((res.R1, res.P1), (res.R2, res.P2))]

    def rectify(self, left: torch.Tensor, right: torch.Tensor):
        """(H, W) uint8 frames -> the rectified pair (or the frames as given)."""
        if self.maps is None:
            return left, right
        return RC.remap_bilinear(left, self.maps[0]), RC.remap_bilinear(right, self.maps[1])

    def dense(self, lefts: torch.Tensor, rights: torch.Tensor):
        """(B, H, W) uint8 -> (disp, points, valid), each (B, H, W, ...)."""
        return ST.dense_batch_step(lefts, rights, self.Q, self.cfg)

    def cloud(self, disp, pts, valid):
        """One pair's cloud on its way to the host: (host points, host count,
        event or None)."""
        points, count = ST.cloud_points(disp, pts, valid)
        host_pts = torch.empty(points.shape, dtype=points.dtype, pin_memory=self.on_card)
        host_n = torch.empty(count.shape, dtype=count.dtype, pin_memory=self.on_card)
        host_pts.copy_(points, non_blocking=True)
        host_n.copy_(count, non_blocking=True)
        event = None
        if self.on_card:
            event = torch.cuda.Event()
            event.record()
        return host_pts, host_n, event

    @contextlib.contextmanager
    def traced_layers(self, span):
        """Wrap the layers that ``dense_batch_step`` calls inside it, SGBM
        (``ops/disparity.sgbm_disparity``) and the reprojection
        (``ops/geometry.reproject_image_to_3d``), in the ranges "sgbm" and
        "cloud" opened by `span`, for a traced run; restored on exit."""
        originals = (DP.sgbm_disparity, G.reproject_image_to_3d)

        def wrap(fn, name):
            def wrapped(*args, **kwargs):
                with span(name):
                    return fn(*args, **kwargs)
            return wrapped

        DP.sgbm_disparity = wrap(originals[0], "sgbm")
        G.reproject_image_to_3d = wrap(originals[1], "cloud")
        try:
            yield
        finally:
            DP.sgbm_disparity, G.reproject_image_to_3d = originals
