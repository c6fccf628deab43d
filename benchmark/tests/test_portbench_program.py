"""benchmark/program.py: the program's "srcv." spans reduced from hand-built
profiler events (nesting, ownership by the innermost span, idle gaps,
clipping to the window), the harness's own summary unmoved by them, and a
tiny traced CPU run of each cell recording the program's spans."""

import types

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import harness, program, trace

CPU = torch.device("cpu")
NS = 1e-9
CELLS = ["logitech4k_sgbm256.live", "hd720_hh128.live", "logitech4k_sgbm256.jpeg_backlog"]


class Ev:
    """The part of a profiler event that trace.py and program.py read."""

    def __init__(self, name, start, end, tid=1, corr=0, linked=0, device=False, user=False):
        self._name, self._start, self._end, self._tid = name, start, end, tid
        self._corr, self._linked, self._device, self._user = corr, linked, device, user

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CUDA if self._device else DeviceType.CPU

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def device_index(self):
        return 0

    def is_user_annotation(self):
        return self._user


def events(spans: bool) -> list:
    """A window [0, 1000] ns on thread 1: bench ranges around the calls, and
    with `spans` the program's ranges inside them. The kernel of sgbm.post
    is linked to the innermost range open at its launch: the program's span
    where there is one, else the harness's range."""
    ev = [Ev("bench.window", 0, 1000, corr=1), Ev("bench.sgbm", 80, 595, corr=21),
          Ev("bench.cloud", 598, 800, corr=22),
          Ev("aten::mul", 20, 25, corr=15), Ev("aten::add", 130, 135, corr=11),
          Ev("cudaLaunchKernel", 320, 322, corr=12), Ev("aten::copy_", 670, 675, corr=14),
          Ev("aten::empty", 250, 260, tid=2, corr=16),
          Ev("k_rectify", 30, 60, device=True, linked=15),
          Ev("k_cost", 140, 250, device=True, linked=11),
          Ev("k_sweeps", 330, 480, device=True, corr=12),
          Ev("k_lr", 520, 560, device=True, linked=31 if spans else 21),
          Ev("k_compact", 700, 760, device=True, linked=14),
          Ev("k_late", 1100, 1150, device=True, linked=14)]
    if spans:
        ev += [Ev("srcv.rectify", -50, 50, corr=30), Ev("srcv.sgbm", 90, 590, corr=32),
               Ev("srcv.sgbm.cost", 120, 300, corr=33),
               Ev("srcv.sgbm.aggregate", 300, 500, corr=34),
               Ev("srcv.sgbm.post", 500, 580, corr=31),
               Ev("srcv.cloud.compact", 600, 790, corr=35),
               Ev("srcv.cloud.copy", 1100, 1200, corr=36),
               Ev("srcv.input.take", 200, 400, tid=2, corr=37),
               # a range's device-side copy is no device work
               Ev("srcv.sgbm", 140, 560, device=True, user=True)]
    return ev


def prof_of(evs):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))


def test_reduce_owns_items_and_gaps_by_the_innermost_span():
    got = program.reduce(events(True), 1, 0, 1000)
    want = {  # calls, host, device, idle (ns)
        "rectify": (1, 50, 30, 30),          # clipped to the window's start
        "sgbm": (1, 500, 0, 80),             # the gap [60, 140] is its own
        "sgbm.cost": (1, 180, 110, 80),      # [250, 330]
        "sgbm.aggregate": (1, 200, 150, 0),  # its kernel found by the runtime call
        "sgbm.post": (1, 80, 40, 40),        # [480, 520]: the post span opens at 500
        "cloud.compact": (1, 190, 60, 140),  # [560, 700]; [760, 1000] is no span's
    }
    assert set(got) == set(want)  # cloud.copy lies after the window, input.take on thread 2
    for name, (calls, host, device, idle) in want.items():
        assert got[name]["calls"] == calls, name
        for key, ns in (("host_s", host), ("device_s", device), ("idle_s", idle)):
            assert got[name][key] == pytest.approx(ns * NS, abs=1e-15), (name, key)


def test_reduce_without_device_items_reads_no_idle():
    got = program.reduce([e for e in events(True) if not e._device], 1, 0, 1000)
    assert all(v["idle_s"] == 0 and v["device_s"] == 0 for v in got.values())
    assert got["sgbm"]["host_s"] == pytest.approx(500 * NS)


def test_read_finds_the_window_of_a_profiler_run():
    prof = prof_of(events(True) + [Ev("bench.window", 0, 1000, device=True, user=True)])
    assert program.read(prof) == program.reduce(events(True), 1, 0, 1000)
    assert program.read(prof_of([e for e in events(True) if e._name != "bench.window"])) is None


def test_spans_move_no_field_of_the_summary():
    plain, spanned = (trace.summarize(prof_of(events(s))) for s in (False, True))
    assert spanned == plain
    assert plain.range_s == pytest.approx({"window": 30 * NS, "sgbm": 300 * NS, "cloud": 60 * NS})


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_records_the_program_spans(tiny, monkeypatch, cell):
    read = []

    def summarize(prof, *args, **kwargs):
        read.append(program.read(prof))
        return trace.summarize(prof, *args, **kwargs)
    monkeypatch.setattr(harness, "summarize", summarize)
    mix = {"decoder": "libjpeg"} if "backlog" in cell else {}
    r = harness.run_cell(cell, 2**31 + 7, 0.4, True, CPU, 0.0,
                         overrides=tiny(cell.split(".")[0], **mix))
    assert r["correct"], r["checks"]
    (got,) = read
    want = {"sgbm", "sgbm.cost", "sgbm.aggregate", "sgbm.post", "cloud.reproject",
            "cloud.compact"} | ({"rectify"} if "live" in cell else {"input.take"})
    assert want <= set(got), got
    assert all(got[n]["calls"] > 0 and got[n]["host_s"] > 0 for n in want)
    assert got["sgbm"]["calls"] == got["sgbm.post"]["calls"]
    if "backlog" in cell:
        assert got.get("input.stall", {"calls": 0})["calls"] <= got["input.take"]["calls"]
    # no device on the CPU: no span owns device time or idle gaps
    assert all(v["device_s"] == 0 and v["idle_s"] == 0 for v in got.values())
