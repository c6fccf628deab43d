"""Image loading and saving for the CLI (after ``stereo_reconstruction_cv_tpu/io/image.py``).

A stereo pair folder holds img1.jpg (left) and img2.jpg (right); a
calibration folder's images are its *.jpg files. Decoding
and encoding go through PIL, which is imported inside the functions that use
it, so the package imports where PIL is absent. The reference decodes JPEGs
with its own libjpeg build where present (bit-exact to cv2.imread) and with
PIL otherwise; here the CLI's loaders use PIL, and the streaming path
decodes with a decoder it names (``native.decode_jpeg``).
"""

from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from stereo_reconstruction_cv_tpu_torch.errors import DataError


def load_gray(path: str) -> np.ndarray:
    """(H, W) uint8 grayscale (PIL's BT.601 luma)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"))


def load_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def save_image(path: str, img: np.ndarray, quality: int | None = None) -> None:
    """Write (H, W) or (H, W, 3) uint8 in the format of the path's extension;
    `quality` is the JPEG quality (PIL's default, 75, when None)."""
    from PIL import Image

    params = {} if quality is None else {"quality": quality}
    Image.fromarray(np.asarray(img)).save(path, **params)


def load_stereo_pair(folder: str) -> Tuple[np.ndarray, np.ndarray]:
    """The img1.jpg / img2.jpg pair of `folder`, as grayscale."""
    p1 = os.path.join(folder, "img1.jpg")
    p2 = os.path.join(folder, "img2.jpg")
    if not os.path.exists(p1) or not os.path.exists(p2):
        raise DataError(
            f"stereo pair folder {folder!r} must contain img1.jpg and img2.jpg"
        )
    return load_gray(p1), load_gray(p2)


def glob_calibration_images(folder: str) -> List[str]:
    """The sorted *.jpg files of a calibration folder."""
    return sorted(glob.glob(os.path.join(folder, "*.jpg")))
