"""Per-stage timing, structured metrics and device traces.

The port of ``stereo_reconstruction_cv_tpu/utils/profiling.py``:

  - ``Metrics`` / ``METRICS``: values the stages record (match and inlier
    counts, residuals) and their wall times, dumped as one JSON object
    (``cli --metrics OUT.json``);
  - ``stage_timer(name, device=...)``: a stage's wall time, which
    synchronises the stage's CUDA device at exit so that the time covers its
    device work;
  - ``trace(logdir)``: a torch.profiler trace of the body, written as a
    Chrome trace (``logdir/trace.json``);
  - ``span(name)``: the program's named range "srcv.<name>", one per call
    at a layer boundary (README, "Tracing a run", lists them), recorded on
    the profiler's own clock beside the device items it launches, so each
    item and each idle gap of a trace can be put down to what the program
    was doing. While no profiler records, it is one shared null context: a
    span then costs one attribute check.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "srcv."
_NO_SPAN = contextlib.nullcontext()


class Metrics:
    """Structured metrics: recorded values and per-stage wall times."""

    def __init__(self):
        self.values: Dict[str, Any] = {}
        self.timings: Dict[str, list] = defaultdict(list)

    def record(self, name: str, value) -> None:
        self.values[name] = value

    def add_timing(self, stage: str, seconds: float) -> None:
        self.timings[stage].append(seconds)

    def summary(self) -> Dict[str, Any]:
        out = dict(self.values)
        for stage, ts in self.timings.items():
            out[f"time/{stage}_s"] = sum(ts) / len(ts)
            out[f"time/{stage}_calls"] = len(ts)
        return out

    def dump(self) -> str:
        return json.dumps(self.summary(), default=float, sort_keys=True)

    def reset(self) -> None:
        self.values.clear()
        self.timings.clear()


METRICS = Metrics()


@contextlib.contextmanager
def stage_timer(name: str, metrics: Metrics = METRICS, device=None) -> Iterator[None]:
    """Wall-clock a stage into `metrics`; a CUDA `device` that the process
    has initialised is synchronised first, so queued kernels count."""
    dev = None if device is None else torch.device(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if dev is not None and dev.type == "cuda" and torch.cuda.is_initialized():
            torch.cuda.synchronize(dev)
        metrics.add_timing(name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the body (the CPU, and CUDA where torch sees a
    card), written to logdir/trace.json for chrome://tracing or Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def span(name: str):
    """The range "srcv.<name>" in the running profiler's trace; while no
    profiler records, the shared null context (no record_function is built)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)
