"""The port's native host code, through ctypes: the exact speckle filter and JPEG decode.

- ``filter_speckles``: the reference's ``native/speckle.cc``, cv2.filterSpeckles
  semantics: union-find over 4-connectivity where |d(p) - d(q)| <= max_diff;
  components of at most ``max_size`` pixels are invalidated.
- ``decode_jpeg`` / ``load_image`` (reference ``native.py:119, 139``): JPEG
  bytes -> (H, W) or (H, W, 3) uint8, by one of ``DECODERS``, named by the
  caller: ``"libjpeg"`` builds the reference's ``native/jpeg_loader.cc``
  (its grayscale is libjpeg's luma, bit-equal to the reference's decoder);
  ``"nvjpeg"`` builds ``csrc/nvjpeg_decode.cc`` against the CUDA toolkit's
  nvJPEG and decodes on the current CUDA device into host memory. The C
  calls release the GIL, so threads decode in parallel.

Each library is compiled at first use (``_build``), apart from the others, so
that a machine without libjpeg (or without a card) runs everything else; a
failed build raises instead of falling back. A decode that fails raises
``DataError``, where the reference returns None.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import numpy as np

from stereo_reconstruction_cv_tpu_torch import _build
from stereo_reconstruction_cv_tpu_torch.errors import DataError

DECODERS = ("libjpeg", "nvjpeg")


def filter_speckles(
    disp: np.ndarray, valid: np.ndarray, max_size: int, max_diff: float
) -> np.ndarray:
    """(H, W) float disparity + bool valid -> the updated valid mask (copy)."""
    disp = np.ascontiguousarray(disp, np.float32)
    out = np.ascontiguousarray(valid, np.uint8).copy()
    if disp.ndim != 2 or disp.shape != out.shape:
        raise ValueError(f"disp {disp.shape} and valid {out.shape} must be one (H, W) shape")
    h, w = disp.shape
    _build.speckle_library().stereo_native_filter_speckles(
        disp.ctypes.data, out.ctypes.data, h, w, int(max_size), float(max_diff)
    )
    return out.astype(bool)


# nvJPEG decoders (handle, state, stream, device buffer), one per thread at a
# time, kept for the life of the process: creating one costs milliseconds
# and its first decode allocates.
_nvjpeg_free: list = []
_nvjpeg_lock = threading.Lock()


@contextlib.contextmanager
def _nvjpeg_decoder():
    lib = _build.nvjpeg_library()
    with _nvjpeg_lock:
        handle = _nvjpeg_free.pop() if _nvjpeg_free else None
    if handle is None:
        ptr = ctypes.c_void_p()
        _check(lib.srcv_nvjpeg_create(ctypes.byref(ptr)), "creating an nvJPEG decoder")
        handle = ptr.value
    try:
        yield lib, handle
    finally:
        with _nvjpeg_lock:
            _nvjpeg_free.append(handle)


def _check(rc: int, what: str) -> None:
    """Raise for an nvJPEG return code: DataError for bad data, else
    RuntimeError (csrc/nvjpeg_decode.cc: kind * 1000 + code)."""
    if rc == 0:
        return
    kind, code = divmod(rc, 1000)
    if kind == 1:
        raise DataError(f"{what}: nvJPEG cannot decode the data (status {code})")
    source = "nvJPEG status" if kind == 2 else "CUDA error"
    raise RuntimeError(f"{what}: {source} {code}")


def check_decoder(decoder: str) -> None:
    if decoder not in DECODERS:
        raise ValueError(f"decoder={decoder!r}: one of {DECODERS}")


def jpeg_info(data: bytes, decoder: str = "libjpeg") -> tuple[int, int, int]:
    """(height, width, components) from a JPEG's header."""
    check_decoder(decoder)
    if not data:
        raise DataError("empty JPEG data")
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if decoder == "libjpeg":
        if _build.jpeg_library().stereo_native_jpeg_info(
                data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)):
            raise DataError("libjpeg cannot read the JPEG header")
    else:
        with _nvjpeg_decoder() as (lib, handle):
            _check(lib.srcv_nvjpeg_info(handle, data, len(data), ctypes.byref(h),
                                        ctypes.byref(w), ctypes.byref(c)), "reading a JPEG header")
    return h.value, w.value, c.value


def decode_jpeg(data: bytes, gray: bool = True, decoder: str = "libjpeg",
                out: np.ndarray | None = None) -> np.ndarray:
    """Decode JPEG bytes -> (H, W) (gray) or (H, W, 3) (RGB) uint8.

    `out`, when given, is a C-contiguous uint8 array of that shape (a view of
    a pinned tensor, say) that receives the pixels and is returned."""
    h, w, _ = jpeg_info(data, decoder)
    shape = (h, w) if gray else (h, w, 3)
    if out is None:
        out = np.empty(shape, np.uint8)
    elif out.shape != shape or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous uint8 array of shape {shape}, got "
                         f"{out.dtype} {out.shape}")
    if decoder == "libjpeg":
        if _build.jpeg_library().stereo_native_jpeg_decode(data, len(data), out.ctypes.data,
                                                            int(gray)):
            raise DataError("libjpeg cannot decode the JPEG data")
    else:
        with _nvjpeg_decoder() as (lib, handle):
            _check(lib.srcv_nvjpeg_decode(handle, data, len(data), out.ctypes.data, int(gray)),
                   "decoding a JPEG")
    return out


def load_image(path: str, gray: bool = True, decoder: str = "libjpeg",
               out: np.ndarray | None = None) -> np.ndarray:
    """decode_jpeg of a file's bytes."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_jpeg(data, gray, decoder, out)
    except DataError as e:
        raise DataError(f"{path}: {e}") from None
