"""Typed errors of the port (copied from ``stereo_reconstruction_cv_tpu/errors.py``).

Everything the port raises for bad inputs is a :class:`StereoError`, so that
callers catch one family. Only the classes the port raises are here.
"""


class StereoError(Exception):
    """Base class for every error this package raises."""


class DataError(StereoError, FileNotFoundError):
    """Missing or malformed input data (images, pair folders).

    Subclasses FileNotFoundError, as the reference's does, so callers that
    catch the stdlib type keep working."""
