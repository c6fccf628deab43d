"""Carry the reference's state across to the port.

The dense path has no learned weights; its state is the ``SGBMConfig`` and
the rig geometry. This module converts both:

- ``sgbm_config``: the reference's ``SGBMConfig`` (or any object with its
  fields) into the port's own ``config.SGBMConfig``, field by field;
- ``from_reference_rectification``: the reference's ``RectifyResult`` (arrays
  converted with ``np.asarray``) or the ``rectification.npz`` its ``rectify``
  verb writes (key ``Q``; ``R1, R2, P1, P2`` where present) into the port's
  ``RectifyResult`` of float64 tensors.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig
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


def sgbm_config(ref_cfg) -> SGBMConfig:
    """The reference's SGBMConfig -> the port's, field by field (every
    field of the port's class must be present on `ref_cfg`)."""
    return SGBMConfig(**{f.name: getattr(ref_cfg, f.name)
                         for f in dataclasses.fields(SGBMConfig)})
