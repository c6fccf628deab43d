"""Kernel timing on the card with CUDA events.

``cuda_ms`` times each call apart and takes the median; ``launch_ms`` warms
up, then puts one event pair around N back-to-back calls and divides. Both
include whatever time the host takes to issue a call while the device
waits, so they time a kernel only when it outlasts its wrapper's host work
(tens of microseconds). ``graph_ms`` captures N calls in a CUDA graph and
times its replay, which leaves only the kernels; since the wrappers count no
captured call, it adds the replayed launches to the count it is given. All
need a CUDA device;
none falls back to a host clock. ``card`` names the card and its power
limit, to be printed beside the times. ``kernel_ms`` times each kernel
that a call launches apart, by name, from ``torch.profiler``.
"""

from __future__ import annotations

import re
import statistics
import subprocess
from typing import Callable

import torch


def card() -> str:
    """The first card's name and power limit as nvidia-smi gives them (its
    name from torch and "power limit not read" where nvidia-smi fails)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0] if out else f"{torch.cuda.get_device_name(0)}, power limit not read"


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Median of `reps` CUDA-event timings of fn() (after the caller warmed it)."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def launch_ms(fn: Callable[[], object], iters: int = 8, warmup: int = 2) -> float:
    """Mean ms per call of fn() over `iters` back-to-back calls between one
    pair of CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 2,
             counts: tuple[dict, str] | None = None) -> float:
    """Mean ms per call of fn() replayed from a CUDA graph of `iters` calls
    (captured after `warmup` eager calls): the device time of the kernels
    fn launches, without the host's time to issue them. `counts`, a
    module's launch-count dict and a kernel's name in it, is for an fn that
    launches that kernel once per call: each replay adds `iters` to it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()  # warm, then timed
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    if counts is not None:
        launches, name = counts
        launches[name] += 2 * iters  # the two replays
    return a.elapsed_time(b) / iters


def kernel_ms(fn: Callable[[], object], reps: int = 5) -> dict:
    """{kernel name: mean device ms per call of fn()} from torch.profiler
    over `reps` eager calls (after one warm call): the launches of one
    wrapper timed apart."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", e.name)
            name = m.group(1) if m else e.name[:40]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return out
