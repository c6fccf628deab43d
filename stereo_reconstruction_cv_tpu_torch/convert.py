"""Carry the reference's state across to the port.

The port's state is the configuration, the rig geometry and the learned
net's weights. This module converts them:

- ``sgbm_config`` and ``pipeline_config``: the reference's ``SGBMConfig`` or
  ``PipelineConfig`` (or any object with their fields) into the port's own
  classes of ``config``, field by field, nested classes included;
- ``from_reference_rectification``: the reference's ``RectifyResult`` (arrays
  converted with ``np.asarray``) or the ``rectification.npz`` its ``rectify``
  verb writes (key ``Q``; ``R1, R2, P1, P2`` where present) into the port's
  ``RectifyResult`` of float64 tensors;
- ``xfeat_state_dict``: the reference's XFeatNet parameters, flattened to
  ``{flax path: array}``, into the port's ``XFeatNet`` state_dict, and
  ``xfeat_flat_params`` back (what the port's training saves).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch import config as C
from stereo_reconstruction_cv_tpu_torch.models.xfeat import XFeatNet
from stereo_reconstruction_cv_tpu_torch.ops.rectify import RectifyResult

_FIELDS = ("R1", "R2", "P1", "P2", "Q")
_SHAPES = {"R1": (3, 3), "R2": (3, 3), "P1": (3, 4), "P2": (3, 4), "Q": (4, 4)}


def _field(src, name):
    if hasattr(src, "_fields"):  # a RectifyResult named tuple
        return getattr(src, name)
    return src[name] if name in src else None


def from_reference_rectification(obj, device="cpu") -> RectifyResult:
    """Reference RectifyResult, .npz path, NpzFile or mapping -> the port's
    RectifyResult (float64 tensors on `device`; absent fields are None)."""
    if isinstance(obj, (str, os.PathLike)):
        with np.load(obj) as z:
            return from_reference_rectification(dict(z), device)
    out = {}
    for name in _FIELDS:
        value = _field(obj, name)
        if value is None:
            if name == "Q":
                raise KeyError("rectification has no Q matrix")
            out[name] = None
            continue
        arr = np.array(value, dtype=np.float64)
        if arr.shape != _SHAPES[name]:
            raise ValueError(f"{name} has shape {arr.shape}, expected {_SHAPES[name]}")
        out[name] = torch.as_tensor(arr, device=device)
    return RectifyResult(**out)


# The nested configuration fields and the port's class of each.
_NESTED = {"calibration": C.CalibrationConfig, "chessboard": C.ChessboardConfig,
           "match": C.MatchConfig, "robust": C.RobustConfig, "rectify": C.RectifyConfig,
           "sgbm": C.SGBMConfig}


def _carry(cls, src):
    """An instance of the port's `cls` with every field read from `src`."""
    return cls(**{f.name: _carry(_NESTED[f.name], getattr(src, f.name)) if f.name in _NESTED
                  else getattr(src, f.name) for f in dataclasses.fields(cls)})


def sgbm_config(ref_cfg) -> C.SGBMConfig:
    """The reference's SGBMConfig -> the port's, field by field (every
    field of the port's class must be present on `ref_cfg`)."""
    return _carry(C.SGBMConfig, ref_cfg)


def pipeline_config(ref_cfg) -> C.PipelineConfig:
    """The reference's PipelineConfig -> the port's, field by field through
    every nested configuration."""
    return _carry(C.PipelineConfig, ref_cfg)


def _xfeat_names() -> dict:
    """{flax path: port state_dict name} of every XFeatNet parameter."""
    names = {}
    for i in range(8):
        block = f"params/ConvBlock_{i}/"
        names[block + "Conv_0/kernel"] = f"blocks.{i}.conv.weight"
        names[block + "LayerNorm_0/scale"] = f"blocks.{i}.norm.weight"
        names[block + "LayerNorm_0/bias"] = f"blocks.{i}.norm.bias"
    for i, conv in enumerate(("kpt.0", "kpt.1", "kpt.2", "skip", "desc", "rel")):
        names[f"params/Conv_{i}/kernel"] = f"{conv}.weight"
        names[f"params/Conv_{i}/bias"] = f"{conv}.bias"
    return names


def xfeat_state_dict(flat) -> dict:
    """The reference's XFeatNet parameters as a flat {flax path: array}
    mapping (``"params/ConvBlock_3/Conv_0/kernel"``, ...) -> the port's
    XFeatNet state_dict of float32 CPU tensors: kernels HWIO -> OIHW,
    LayerNorm scale -> weight. Raises on a missing or unexpected name and on
    a shape the port's net does not have."""
    names = _xfeat_names()
    missing = sorted(set(names) - set(flat))
    unexpected = sorted(set(flat) - set(names))
    if missing or unexpected:
        raise KeyError(f"XFeatNet parameters: missing {missing}, unexpected {unexpected}")
    want = {k: tuple(v.shape) for k, v in XFeatNet().state_dict().items()}
    out = {}
    for path, name in names.items():
        arr = np.asarray(flat[path], dtype=np.float32)
        if path.endswith("/kernel") and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        if arr.shape != want[name]:
            raise ValueError(f"{path}: shape {np.shape(flat[path])} does not fit {name} "
                             f"{want[name]}")
        out[name] = torch.tensor(arr)
    return out


def xfeat_flat_params(state_dict) -> dict:
    """The inverse of xfeat_state_dict: the port's XFeatNet state_dict ->
    {flax path: float32 numpy array}, kernels OIHW -> HWIO, LayerNorm
    weight -> scale."""
    out = {}
    for path, name in _xfeat_names().items():
        arr = state_dict[name].detach().to("cpu", torch.float32).numpy()
        out[path] = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr
    return out
