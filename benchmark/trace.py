"""Ranges, the profiler's device trace, and what they reduce to.

``Spans`` opens the harness's named ranges (``torch.profiler.record_function``
"bench.<name>", only in a traced run) around its calls into each layer.
``summarize`` reduces a finished ``torch.profiler`` run over the window to:

- the device items (kernels, copies, sets) and their union on each card
  (busy, averaged over the cards the cell uses), over the traced window,
  as ``chip_smoke.idle_report`` reckons the idle share;
- each item's range: the profiler links an item to the host event that
  launched it (the op, or the runtime call by its correlation id); the
  innermost "bench." range open on that thread at that moment owns it;
- the device operations that took most time, and the idle gaps by the
  innermost range open on the harness's thread across each gap.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

PREFIX = "bench."


class Spans:
    """Named host ranges for the traced run (no-ops otherwise)."""

    def __init__(self, traced: bool):
        self.traced = traced
        if traced:
            from torch.profiler import record_function
            self._rf = record_function

    def __call__(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        return self._rf(PREFIX + name)


@dataclass
class Summary:
    window_s: float
    busy_s: float
    items: int
    range_s: dict = field(default_factory=dict)      # range -> device seconds
    device_ops: list = field(default_factory=list)   # [name, seconds], most first
    idle_gaps: list = field(default_factory=list)    # [host range, seconds], most first


def _innermost(intervals):
    """Properly nested (start, end, name) intervals -> disjoint segments
    (start, end, name) labelled by the innermost interval."""
    segs, stack, t = [], [], None
    for s, e, name in sorted(intervals, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            _, pe, pn = stack.pop()
            if pe > t:
                segs.append((t, pe, pn))
            t = pe
        if stack and s > t:
            segs.append((t, s, stack[-1][2]))
        stack.append((s, e, name))
        t = s
    while stack:
        _, pe, pn = stack.pop()
        if pe > t:
            segs.append((t, pe, pn))
        t = pe
    return segs


class _Timeline:
    def __init__(self, intervals):
        self.segs = _innermost(intervals)
        self.starts = [s for s, _, _ in self.segs]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segs[i][1]:
            return self.segs[i][2]
        return None


def _is_runtime(name: str) -> bool:
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def _union_s(spans) -> float:
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or e > end:
            busy += (e - (s if end is None else max(s, end))) * 1e-9
            end = e
    return busy


def summarize(prof, cards: int = 1, window: str = "window", top: int = 10) -> Summary | None:
    """Reduce a finished profiler run whose window is the range `window`,
    over a cell on `cards` cards; None where the trace holds no window
    range."""
    from torch.autograd import DeviceType

    ranges: dict = {}   # thread -> [(start, end, name)]
    ops: dict = {}      # correlation id of a host op -> (thread, start)
    runtime: dict = {}  # correlation id of a runtime call -> (thread, start)
    dev = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # the ranges' own device-side copies are not device work
            if not (name.startswith(("Activity Buffer", PREFIX)) or e.is_user_annotation()):
                dev.append((e.start_ns(), e.end_ns(), name, e.linked_correlation_id(),
                            e.correlation_id(), e.device_index()))
            continue
        tid, start = e.start_thread_id(), e.start_ns()
        if name.startswith(PREFIX):
            ranges.setdefault(tid, []).append((start, e.end_ns(), name[len(PREFIX):]))
        if e.correlation_id():
            (runtime if _is_runtime(name) else ops)[e.correlation_id()] = (tid, start)
    main = next((tid for tid, iv in ranges.items() if any(n == window for *_, n in iv)), None)
    if main is None:
        return None
    w0, w1 = next((s, e) for s, e, n in ranges[main] if n == window)
    lines = {tid: _Timeline(iv) for tid, iv in ranges.items()}
    range_s: dict = {}
    op_s: dict = {}
    spans, per_card = [], {}
    for s, e, name, linked, corr, card in dev:
        if e <= w0 or s >= w1:
            continue
        spans.append((max(s, w0), min(e, w1)))
        per_card.setdefault(card, []).append(spans[-1])
        op_s[name] = op_s.get(name, 0.0) + (e - s) * 1e-9
        site = ops.get(linked) if linked else None
        if site is None:
            site = runtime.get(corr)
        owner = lines[site[0]].at(site[1]) if site is not None and site[0] in lines else None
        if owner is not None:
            range_s[owner] = range_s.get(owner, 0.0) + (e - s) * 1e-9
    end, gaps = w0, {}
    host = lines[main]
    for s, e in sorted(spans):
        if s > end:
            label = host.at((s + end) / 2) or "host"
            gaps[label] = gaps.get(label, 0.0) + (s - end) * 1e-9
        end = max(end, e)
    if w1 > end:
        label = host.at((w1 + end) / 2) or "host"
        gaps[label] = gaps.get(label, 0.0) + (w1 - end) * 1e-9
    def most(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    busy = sum(_union_s(v) for v in per_card.values()) / cards
    return Summary(window_s=(w1 - w0) * 1e-9, busy_s=busy, items=len(spans), range_s=range_s,
                   device_ops=[[n[:120], v] for n, v in most(op_s)], idle_gaps=most(gaps))
