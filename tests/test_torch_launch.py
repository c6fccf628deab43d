"""The kernels' launch seam (``_build.launch``, ``_build.cuda_device``,
``_build.KERNELS``) on the CPU, with a fake kernels library patched in:
what a launch passes, raises and counts. The kernels themselves run in the
``gpu`` tests of ``tests/test_torch_gpu.py``."""

from __future__ import annotations

import contextlib
import ctypes
import pathlib
import re
import types

import pytest
import torch

from stereo_reconstruction_cv_tpu_torch import _build
from stereo_reconstruction_cv_tpu_torch.ops.cuda import speckle as SPK

CSRC = pathlib.Path(_build.__file__).resolve().parent / "csrc"
STREAM = 0x5EED


class FakeLibrary:
    """Kernel entry points that record their arguments and return `err`."""

    def __init__(self, err: int):
        self.err = err
        self.calls = []

    def __getattr__(self, entry):
        if entry not in _build.KERNELS:
            raise AttributeError(entry)

        def fn(*args):
            self.calls.append((entry, args))
            return self.err
        return fn

    def srcv_error_string(self, err):
        return b"cudaErrorLaunchFailure"


@pytest.fixture
def fake_cuda(monkeypatch):
    """Patch in a fake library, a current stream and a device guard that
    needs no card; -> a function that sets the library's error code."""
    lib = FakeLibrary(0)
    monkeypatch.setattr(_build, "kernels_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=STREAM))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    return lib


def test_launch_appends_the_stream_and_counts_once(fake_cuda):
    counts = {"op_chain": 2}
    _build.launch("srcv_op_chain", torch.device("cuda:0"), 11, 12, 3, 32, 1, 6,
                  counts=(counts, "op_chain"))
    assert fake_cuda.calls == [("srcv_op_chain", (11, 12, 3, 32, 1, 6, STREAM))]
    assert counts == {"op_chain": 3}


@pytest.mark.parametrize("with_counts", [True, False])
def test_failed_launch_raises_naming_the_kernel_and_counts_nothing(fake_cuda, with_counts):
    fake_cuda.err = 719
    counts = {"sgm_path_sweep_carry": 4}
    name = "sgm_path_sweep_carry" if with_counts else "srcv_sgm_path_sweep"
    with pytest.raises(RuntimeError, match=f"^{name}: launch failed with CUDA error 719 "
                                           r"\(cudaErrorLaunchFailure\)"):
        _build.launch("srcv_sgm_path_sweep", torch.device("cuda:0"), *range(13),
                      counts=(counts, "sgm_path_sweep_carry") if with_counts else None)
    assert counts == {"sgm_path_sweep_carry": 4}
    assert len(fake_cuda.calls) == 1


@pytest.mark.parametrize("capturing,added", [(False, 1), (True, 0)])
def test_launch_under_graph_capture_adds_no_count(fake_cuda, monkeypatch, capturing, added):
    """A launch recorded into a CUDA graph is counted by its replays
    (utils/timing.graph_ms), not here."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    counts = {"remap": 5}
    _build.launch("srcv_remap_bilinear", torch.device("cuda:0"), *range(9),
                  counts=(counts, "remap"))
    assert counts == {"remap": 5 + added}
    assert len(fake_cuda.calls) == 1


@pytest.mark.parametrize("capturing", [False, True])
def test_recording_keeps_the_counts_that_capture_skips(fake_cuda, monkeypatch, capturing):
    """Inside recording() a captured launch is kept for the replays to add,
    once per launch and in order; an eager one is counted as always. The
    outer recorder is restored on exit, and outside any nothing is kept."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    counts = {"remap": 0, "op_chain": 0}
    with _build.recording() as outer:
        with _build.recording() as kept:
            _build.launch("srcv_remap_bilinear", torch.device("cuda:0"), *range(9),
                          counts=(counts, "remap"))
            _build.count(counts, "op_chain")
        _build.count(counts, "remap")
    _build.count(counts, "op_chain")
    if capturing:
        assert counts == {"remap": 0, "op_chain": 0}
        assert kept == [(counts, "remap"), (counts, "op_chain")]
        assert outer == [(counts, "remap")]
    else:
        assert counts == {"remap": 2, "op_chain": 2}
        assert kept == [] and outer == []


@pytest.mark.parametrize("err", [0, 700])
def test_failed_speckle_keep_drops_its_count_cells(fake_cuda, monkeypatch, err):
    """The keep kernels leave their cached count cells zero only when both
    passes ran: a failed launch drops them, so the next call makes new ones."""
    fake_cuda.err = err
    cpu = torch.device("cpu")
    monkeypatch.setattr(_build, "cuda_device", lambda what, *ts: cpu)
    monkeypatch.setattr(SPK, "_cells", {})
    monkeypatch.setattr(SPK, "launches", {"speckle_labels": 0, "speckle_keep": 0})
    labels = torch.zeros((6, 9), dtype=torch.int32)
    valid = torch.ones((6, 9), dtype=torch.bool)
    if err:
        with pytest.raises(RuntimeError, match="speckle_keep: launch failed"):
            SPK.speckle_keep_cuda(labels, valid, 3)
    else:
        SPK.speckle_keep_cuda(labels, valid, 3)
    assert [e for e, _ in fake_cuda.calls] == ["srcv_speckle_keep"]
    assert ((cpu, 54) in SPK._cells) == (err == 0)
    assert SPK.launches == {"speckle_labels": 0, "speckle_keep": int(err == 0)}


def _on(dev: str):
    return types.SimpleNamespace(device=torch.device(dev))


def test_cuda_device_takes_one_cuda_device_only():
    assert _build.cuda_device("k", _on("cuda:1"), _on("cuda:1")) == torch.device("cuda:1")
    for devs in (["cpu"], ["cpu", "cpu"], ["cuda:0", "cuda:1"], ["cuda:0", "cpu"],
                 ["cpu", "cuda:0"], ["meta"]):
        with pytest.raises(ValueError, match="^k: CUDA kernel called on .*one CUDA device"):
            _build.cuda_device("k", *map(_on, devs))
    with pytest.raises(ValueError, match=r"\['cpu', 'cuda:0'\]"):
        _build.cuda_device("k", torch.zeros(2), _on("cuda:0"))


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "long long": ctypes.c_longlong, "float": ctypes.c_float}


def test_signature_table_matches_the_kernel_sources():
    """KERNELS names every entry point of csrc/*.cu once, with the types of
    its C arguments; the stream, which the seam appends, comes last."""
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        for m in re.finditer(r"^int (srcv_\w+)\(([^)]*)\)", src.read_text(), re.M):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            assert m.group(1) not in found, m.group(1)
            found[m.group(1)] = [_C_TYPES[p.rsplit(" ", 1)[0]] for p in params]
    assert set(found) == set(_build.KERNELS)
    for entry, argtypes in _build.KERNELS.items():
        assert [*argtypes, ctypes.c_void_p] == found[entry], entry
