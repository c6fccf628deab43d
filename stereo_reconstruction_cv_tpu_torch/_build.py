"""Build and load the port's native libraries at first use.

Two shared libraries with plain C interfaces, loaded with ctypes:

- the CUDA kernels: ``nvcc`` over ``csrc/*.cu`` for ``sm_90a`` (Hopper);
- the host speckle filter: ``g++`` over the reference's ``native/speckle.cc``
  alone (no libjpeg, unlike the reference's ``libstereo_native.so``).

Each library is written to ``build/`` at the repository root under a name
that carries a digest of its sources and flags, so an edited source is never
served by a stale library. A build that fails raises: there is no fallback.
Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
ROOT = _PKG.parent
BUILD_DIR = ROOT / "build"
CUDA_SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
SPECKLE_SOURCE = ROOT / "native" / "speckle.cc"

# Precise division and no fused contractions are part of the numerics
# contract (the subpixel f32 maths must match the reference bit for bit):
# never add --use_fast_math here.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_loaded: dict[str, ctypes.CDLL] = {}


def _digest(sources, flags) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _compile(cmd_prefix, sources, flags, name: str) -> Path:
    """Compile `sources` into build/<name>-<digest>.so unless it exists.

    The output goes to a per-process temporary name and is renamed into
    place, so concurrent first uses (test workers) never load a partial
    file. The compiler's messages are kept beside the library."""
    out = BUILD_DIR / f"{name}-{_digest(sources, flags)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*cmd_prefix, *flags, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {name} failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built at first use and need "
            "the CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return found


def kernels_library() -> ctypes.CDLL:
    """The CUDA kernels (built on first call, then cached per process)."""
    lib = _loaded.get("kernels")
    if lib is None:
        path = _compile([nvcc_path()], CUDA_SOURCES, NVCC_FLAGS, "libsrcv_kernels")
        lib = ctypes.CDLL(str(path))
        _declare_kernels(lib)
        _loaded["kernels"] = lib
    return lib


def speckle_library() -> ctypes.CDLL:
    """The host union-find speckle filter (built on first call)."""
    lib = _loaded.get("speckle")
    if lib is None:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the host speckle filter is built at first use")
        path = _compile([gxx], (SPECKLE_SOURCE,), GXX_FLAGS, "libsrcv_speckle")
        lib = ctypes.CDLL(str(path))
        lib.stereo_native_filter_speckles.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ]
        lib.stereo_native_filter_speckles.restype = None
        _loaded["speckle"] = lib
    return lib


def _declare_kernels(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.srcv_cost_volume.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
    lib.srcv_sgm_path_sweep.argtypes = [P, P, I, I, I, I, I, I, I, I, P]
    lib.srcv_sgm_sweep_wta.argtypes = [P] * 7 + [I] * 11 + [P]
    lib.srcv_lr_check.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
    for fn in (lib.srcv_cost_volume, lib.srcv_sgm_path_sweep,
               lib.srcv_sgm_sweep_wta, lib.srcv_lr_check):
        fn.restype = I
    lib.srcv_error_string.argtypes = [I]
    lib.srcv_error_string.restype = ctypes.c_char_p


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        name = lib.srcv_error_string(err).decode()
        raise RuntimeError(f"{what}: launch failed with CUDA error {err} ({name})")
