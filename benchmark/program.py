"""The program's own spans in a traced window, on the device trace's clock.

The port opens a range "srcv.<name>" at each of its layer boundaries
(``stereo_reconstruction_cv_tpu_torch.utils.profiling.span``) while a
profiler records. ``reduce`` reads them from the same finished profiler run
that ``trace.summarize`` reduces, and gives each span name, over the window:

- ``calls``: its ranges on the window's thread that overlap the window;
- ``host_s``: their wall time (the union of their intervals), clipped to
  the window;
- ``device_s``: the device items overlapping the window whose launching op's
  innermost open "srcv." range is one of them, the rule by which
  ``summarize`` gives items to "bench." ranges;
- ``idle_s``: the window's device-idle gaps whose midpoint falls inside one
  of them, innermost on the window's thread (none where the window holds no
  device item).

A name the window never entered is absent. "srcv." ranges are read here
alone: they take no item and no gap from a "bench." range. ``read`` finds
the window in a finished profiler run as ``summarize`` does and reduces it.
Nothing here imports the program, so a program without spans reads as an
empty dict.

No metric reads this yet: a reader of ``metrics/`` sees a ``Summary``, and
the profiler run is gone by then. Wiring it in takes a ``program`` field on
``trace.Summary``, filled at the end of ``trace.summarize`` from ``read``.
"""

from __future__ import annotations

from benchmark import trace

PREFIX = "srcv."


def reduce(events, main: int, w0: int, w1: int) -> dict:
    """{span name: {"calls", "host_s", "device_s", "idle_s"}} over the window
    [w0, w1] (ns) whose thread is `main`, from a profiler run's events."""
    from torch.autograd import DeviceType

    ranges: dict = {}   # thread -> [(start, end, name)]
    ops: dict = {}      # correlation id of a host op -> (thread, start)
    runtime: dict = {}  # correlation id of a runtime call -> (thread, start)
    dev = []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not (name.startswith(("Activity Buffer", trace.PREFIX, PREFIX))
                    or e.is_user_annotation()):
                dev.append((e.start_ns(), e.end_ns(), e.linked_correlation_id(),
                            e.correlation_id()))
            continue
        tid, start = e.start_thread_id(), e.start_ns()
        if name.startswith(PREFIX):
            ranges.setdefault(tid, []).append((start, e.end_ns(), name[len(PREFIX):]))
        if e.correlation_id():
            (runtime if trace._is_runtime(name) else ops)[e.correlation_id()] = (tid, start)
    out: dict = {}

    def entry(name):
        return out.setdefault(name, {"calls": 0, "host_s": 0.0, "device_s": 0.0, "idle_s": 0.0})

    inside: dict = {}
    for s, e, name in ranges.get(main, []):
        if e > w0 and s < w1:
            entry(name)["calls"] += 1
            inside.setdefault(name, []).append((max(s, w0), min(e, w1)))
    for name, spans in inside.items():
        out[name]["host_s"] = trace._union_s(spans)
    lines = {tid: trace._Timeline(iv) for tid, iv in ranges.items()}
    busy = []
    for s, e, linked, corr in dev:
        if e <= w0 or s >= w1:
            continue
        busy.append((max(s, w0), min(e, w1)))
        site = ops.get(linked) if linked else None
        if site is None:
            site = runtime.get(corr)
        owner = lines[site[0]].at(site[1]) if site is not None and site[0] in lines else None
        if owner is not None:
            entry(owner)["device_s"] += (e - s) * 1e-9
    host = lines.get(main)
    if busy and host is not None:
        end = w0
        for s, e in sorted(busy) + [(w1, w1)]:
            if s > end:
                owner = host.at((s + end) / 2)
                if owner is not None:
                    entry(owner)["idle_s"] += (s - end) * 1e-9
            end = max(end, e)
    return out


def read(prof, window: str = "window") -> dict | None:
    """``reduce`` over the window of a finished ``torch.profiler`` run: the
    thread and bounds of its "bench.<window>" range; None where the trace
    holds no such range."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    bounds = [(e.start_thread_id(), e.start_ns(), e.end_ns()) for e in events
              if e.name() == trace.PREFIX + window and e.device_type() != DeviceType.CUDA]
    if not bounds:
        return None
    return reduce(events, *bounds[0])
