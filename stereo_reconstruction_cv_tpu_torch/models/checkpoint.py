"""The learned net's weights: one .npz file, read with numpy alone.

The reference keeps its checkpoints as orbax directories
(``checkpoints/xfeat_v*``), which need JAX to read. The port reads a flat
``.npz`` of the same arrays under their flax paths
(``"params/ConvBlock_3/Conv_0/kernel"``, ...), which
``convert.xfeat_state_dict`` maps onto ``XFeatNet``. The shipped file is the
reference's default checkpoint, ``xfeat_v4``; export another one with

    python tests/test_torch_xfeat.py CHECKPOINT_DIR OUT.npz

(needs JAX, flax and orbax).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch import convert
from stereo_reconstruction_cv_tpu_torch.models.xfeat import XFeatNet

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights")


class CheckpointFormatError(ValueError):
    """A weights path that is not an .npz export (an orbax directory, say)."""


def default_checkpoint() -> str:
    """The shipped weights: the reference's xfeat_v4, exported."""
    return os.path.join(WEIGHTS_DIR, "xfeat_v4.npz")


def load_params(path: str, device) -> dict:
    """The port's state_dict of XFeatNet from an .npz export, on `device`
    (required: the stages pass theirs, "cuda" unless the caller asks for the
    CPU)."""
    if os.path.isdir(path):
        raise CheckpointFormatError(
            f"{path!r} is a directory (an orbax checkpoint?); the port reads .npz exports: "
            "python tests/test_torch_xfeat.py CHECKPOINT_DIR OUT.npz (needs JAX and orbax)")
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return {k: v.to(device) for k, v in convert.xfeat_state_dict(flat).items()}


def save_params(path: str, model: XFeatNet) -> str:
    """Write the model's weights as the .npz load_params reads (the flax
    paths, HWIO kernels; ".npz" appended to a path without it, as np.savez
    does). Returns the path written."""
    if not path.endswith(".npz"):
        path += ".npz"
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **convert.xfeat_flat_params(model.state_dict()))
    return path


def load_model(path: str, device) -> XFeatNet:
    """XFeatNet on `device` with the weights of `path`, for inference (eval
    mode, no gradients)."""
    model = XFeatNet().to(device)
    model.load_state_dict(load_params(path, device), strict=True)
    return model.eval().requires_grad_(False)
