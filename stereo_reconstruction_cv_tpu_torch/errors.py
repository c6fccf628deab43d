"""Typed errors of the port (copied from ``stereo_reconstruction_cv_tpu/errors.py``).

Everything the port raises for bad inputs is a :class:`StereoError`, so that
callers catch one family. Only the classes the port raises are here, and
``error_dict``, the ``{"error": ...}`` return of the calibration stages.
"""

from typing import Dict


class StereoError(Exception):
    """Base class for every error this package raises."""


class DataError(StereoError, FileNotFoundError):
    """Missing or malformed input data (images, pair folders).

    Subclasses FileNotFoundError, as the reference's does, so callers that
    catch the stdlib type keep working."""


def error_dict(message: str, kind: str = "data") -> Dict[str, str]:
    """A stage's error return, as the reference gives it: the message and a
    kind ("data", "calibration")."""
    return {"error": message, "error_kind": kind}
