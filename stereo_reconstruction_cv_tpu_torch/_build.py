"""Build and load the port's native libraries at first use.

Shared libraries with plain C interfaces, loaded with ctypes:

- the CUDA kernels: ``nvcc`` over ``csrc/*.cu`` for ``sm_90a`` (Hopper);
- the host speckle filter: ``g++`` over the reference's ``native/speckle.cc``
  alone (no libjpeg, unlike the reference's ``libstereo_native.so``);
- the JPEG decoders, each apart, so that a machine without one still runs
  everything else: ``g++`` over the reference's ``native/jpeg_loader.cc``
  with ``-ljpeg`` (libjpeg), and ``nvcc`` over ``csrc/nvjpeg_decode.cc``
  with ``-lnvjpeg`` (nvJPEG, from the CUDA toolkit).

All are built the same way: one compiler process per source, all started
together, then one link. Each library is written to ``build/`` at the
repository root under a name that carries a digest of its sources and flags,
so an edited source is never served by a stale library. A build that fails raises: there is no fallback.
Nothing is built or loaded at import time.

Every wrapper in ``ops/cuda/`` launches its kernel through one seam,
``launch``: it loads the kernels library, enters the device, appends the
current stream, raises on the returned error code and counts the launch.
``KERNELS`` declares each entry point's signature, once; ``cuda_device`` is
the wrappers' check that their inputs lie on one CUDA device.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from stereo_reconstruction_cv_tpu_torch.utils.profiling import span

_PKG = Path(__file__).resolve().parent
ROOT = _PKG.parent
BUILD_DIR = ROOT / "build"
CUDA_SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
SPECKLE_SOURCE = ROOT / "native" / "speckle.cc"
JPEG_SOURCE = ROOT / "native" / "jpeg_loader.cc"
NVJPEG_SOURCE = _PKG / "csrc" / "nvjpeg_decode.cc"

# Precise division and no fused contractions are part of the numerics
# contract (the subpixel f32 maths must match the reference bit for bit):
# never add --use_fast_math here.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17")
NVJPEG_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()  # one build at a time among a process's threads


def _digest(sources, flags) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _run(cmds, log: list, name: str) -> None:
    """Start every command at once and wait for all; append their messages
    to `log`; raise on the first that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, p in procs:
        text = p.communicate()[0]
        log.append(f"$ {' '.join(cmd)}\n{text}")
        if p.returncode != 0:
            failed.append(f"building {name} failed ({' '.join(cmd)}):\n{text}")
    if failed:
        raise RuntimeError(failed[0])


def _compile(cmd_prefix, sources, flags, name: str, libs=()) -> Path:
    """Compile `sources` into build/<name>-<digest>.so unless it exists.

    Each source is compiled to an object by its own process, all started
    together, and the objects are then linked with -shared and `libs`. The output goes
    to a per-process temporary name and is renamed into place, so concurrent
    first uses (test workers) never load a partial file; the threads of one
    process (a loader's decode threads) build in turn, so a later one finds
    the library built. The compilers' messages are kept beside the
    library."""
    out = BUILD_DIR / f"{name}-{_digest(sources, (*flags, *libs))}.so"
    if out.exists():
        return out
    with _build_lock:
        if out.exists():
            return out
        with span("build"):
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
            log: list = []
            try:
                _run([[*cmd_prefix, *flags, "-c", "-o", str(o), str(src)]
                      for o, src in zip(objs, sources)], log, name)
                _run([[*cmd_prefix, "-shared", "-o", str(tmp), *map(str, objs), *libs]],
                     log, name)
                os.replace(tmp, out)
            finally:
                out.with_suffix(".log").write_text("".join(log))
                tmp.unlink(missing_ok=True)
                for o in objs:
                    o.unlink(missing_ok=True)
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
        path = _compile([_gxx()], (SPECKLE_SOURCE,), GXX_FLAGS, "libsrcv_speckle")
        lib = ctypes.CDLL(str(path))
        lib.stereo_native_filter_speckles.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ]
        lib.stereo_native_filter_speckles.restype = None
        _loaded["speckle"] = lib
    return lib


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host libraries are built at first use")
    return gxx


def jpeg_library() -> ctypes.CDLL:
    """The reference's libjpeg decoder (built on first call; needs libjpeg's
    headers and library)."""
    lib = _loaded.get("jpeg")
    if lib is None:
        path = _compile([_gxx()], (JPEG_SOURCE,), GXX_FLAGS, "libsrcv_jpeg", libs=("-ljpeg",))
        lib = ctypes.CDLL(str(path))
        P, I, SZ = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.stereo_native_jpeg_info.argtypes = [P, SZ, P, P, P]
        lib.stereo_native_jpeg_decode.argtypes = [P, SZ, P, I]
        lib.stereo_native_jpeg_info.restype = I
        lib.stereo_native_jpeg_decode.restype = I
        _loaded["jpeg"] = lib
    return lib


def nvjpeg_library() -> ctypes.CDLL:
    """The nvJPEG decoder (built on first call with the toolkit's nvcc,
    linked to its libnvjpeg)."""
    lib = _loaded.get("nvjpeg")
    if lib is None:
        nvcc = nvcc_path()
        cuda_lib = Path(nvcc).resolve().parent.parent / "lib64"
        path = _compile([nvcc], (NVJPEG_SOURCE,), NVJPEG_FLAGS, "libsrcv_nvjpeg",
                        libs=("-lnvjpeg", "-Xlinker", f"-rpath={cuda_lib}"))
        lib = ctypes.CDLL(str(path))
        P, I, SZ = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.srcv_nvjpeg_create.argtypes = [P]
        lib.srcv_nvjpeg_destroy.argtypes = [P]
        lib.srcv_nvjpeg_info.argtypes = [P, P, SZ, P, P, P]
        lib.srcv_nvjpeg_decode.argtypes = [P, P, SZ, P, I]
        for fn in (lib.srcv_nvjpeg_create, lib.srcv_nvjpeg_destroy, lib.srcv_nvjpeg_info,
                   lib.srcv_nvjpeg_decode):
            fn.restype = I
        _loaded["nvjpeg"] = lib
    return lib


# Every entry point of the kernels library (csrc/*.cu): its arguments before
# the stream, which `launch` appends. Each returns a CUDA error code.
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS = {
    "srcv_cost_volume": [_P] * 5 + [_I] * 9,
    "srcv_cost_volume_u8x2": [_P] * 5 + [_I] * 9,
    "srcv_sgm_path_sweep": [_P] * 4 + [_I] * 9,
    "srcv_sgm_sweep_wta": [_P] * 7 + [_I] * 12,
    "srcv_sgm_sweep_sum": [_P] * 4 + [_I] * 10,
    "srcv_lr_check": [_P] * 4 + [_I] * 7,
    "srcv_speckle_labels": [_P] * 3 + [_I] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_float],
    "srcv_speckle_keep": [_P] * 4 + [_I, _I, ctypes.c_longlong, _I],
    "srcv_wta": [_P] * 3 + [_I] * 11 + [_P] * 5,
    "srcv_op_chain": [_P] * 2 + [_I] * 4,
    "srcv_remap_bilinear": [_P] * 3 + [_I] * 6,
    "srcv_cloud_reproject": [_P] * 2 + [_I] * 2 + [ctypes.c_float] * 16,
    "srcv_cloud_compact": [_P] * 6 + [_I] * 2,
}


def _declare_kernels(lib: ctypes.CDLL) -> None:
    for entry, argtypes in KERNELS.items():
        fn = getattr(lib, entry)
        fn.argtypes = [*argtypes, _P]
        fn.restype = _I
    lib.srcv_error_string.argtypes = [_I]
    lib.srcv_error_string.restype = ctypes.c_char_p


def ptxas_report(log_text: str) -> dict:
    """{kernel entry (mangled): {"registers": n, "spill_stores": bytes,
    "spill_loads": bytes}} from ptxas's -v messages in a build log (the
    compiler messages _compile keeps beside each library)."""
    out, entry = {}, None
    for line in log_text.splitlines():
        if line.startswith("$ "):  # the next compiler command
            entry = None
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[entry].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out


def kernel_instance(entry: str) -> str:
    """A template kernel's mangled name (_ZN, then length-prefixed names:
    namespace, kernel) shortened to name<args>, its integer and bool
    template arguments in order (sweep_wta_kernel<4,1,1>); other names as
    they are."""
    if not entry.startswith("_ZN"):
        return entry
    pos, name = 3, None
    while pos < len(entry) and entry[pos].isdigit():
        digits = re.match(r"\d+", entry[pos:]).group()
        pos += len(digits)
        name = entry[pos:pos + int(digits)]
        pos += int(digits)
    if name is None or not entry.startswith("I", pos):
        return entry
    args = re.findall(r"L[ib](\d+)E", entry[pos + 1:entry.index("EE", pos) + 1])
    return f"{name}<{','.join(args)}>"


def cuda_device(what: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device every tensor lies on; ValueError naming `what`
    where one lies on the CPU or another device."""
    dev = tensors[0].device
    if dev.type == "cuda":
        for t in tensors[1:]:  # a plain loop: this runs before every launch
            if t.device != dev:
                break
        else:
            return dev
    raise ValueError(f"{what}: CUDA kernel called on tensors on "
                     f"{sorted({str(t.device) for t in tensors})}: inputs must all lie on one "
                     "CUDA device")


def launch(entry: str, device: torch.device, *args, counts: tuple[dict, str] | None = None) -> None:
    """Launch kernel `entry` (a key of KERNELS) on `device`'s current stream:
    `args` are its arguments before the stream (pointers as ints). Raises
    RuntimeError naming the kernel if the launch returned a CUDA error;
    otherwise `counts`, a module's launch-count dict and a kernel's name in
    it, gains the launch (count)."""
    lib = kernels_library()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        what = entry if counts is None else counts[1]
        raise RuntimeError(f"{what}: launch failed with CUDA error {err} "
                           f"({lib.srcv_error_string(err).decode()})")
    if counts is not None:
        count(*counts)


_recorders = threading.local()


def count(launches: dict, name: str) -> None:
    """Add one to a wrapper's launch count for the kernel it just launched.
    A call made while the current stream is captured into a CUDA graph only
    records the kernel, so it adds nothing: the graph's replays launch it.
    Inside recording() the count is kept for the replays to add
    (utils/timing.graph_ms counts its own)."""
    if not torch.cuda.is_current_stream_capturing():
        launches[name] += 1
        return
    recorder = getattr(_recorders, "counts", None)
    if recorder is not None:
        recorder.append((launches, name))


@contextlib.contextmanager
def recording():
    """The counts that launches captured on this thread inside the block
    skipped, as a list of (launch-count dict, name): a graph's replay adds
    one to each."""
    counts: list = []
    outer = getattr(_recorders, "counts", None)
    _recorders.counts = counts
    try:
        yield counts
    finally:
        _recorders.counts = outer
